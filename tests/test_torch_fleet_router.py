"""The port's fleet router against the JAX package's: the digest
helpers hash the same tokens alike, ``plan`` orders the same members the
same way, the autoscaler decides alike, the session affinity and the
routing text agree; then the port's proxy live, a port leader
(``serve_fleet_leader``) in front of scripted port workers: typed-503
failover, a 429 mirrored, an untyped 503 not retried, SSE passthrough
through a ``/control/leave``, a client abort that cancels its upstream,
and the HA gate. Live tests bind port 0 and wait on events and counts."""

import http.client
import json
import threading

import numpy as np
import pytest

from gofr_tpu.serving import router as jax_router
from gofr_tpu_torch.serving import router as port_router
from gofr_tpu_torch.serving.app import ChatServer, serve_fleet_leader
from gofr_tpu_torch.serving.logger import clear_fleet_context
from gofr_tpu_torch.serving.responses import Raw, Reply, Stream


@pytest.fixture(autouse=True)
def _no_fleet_context():
    yield
    clear_fleet_context()


# ------------------------------------------------------- digest helpers
@pytest.mark.parametrize("seed", range(4))
def test_prefix_hashes_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 128256, size=int(rng.integers(1, 300))).tolist()
    page = int(rng.choice([1, 4, 16, 64]))
    max_pages = int(rng.integers(0, 70))
    assert port_router.prefix_hash(tokens) == jax_router.prefix_hash(tokens)
    assert port_router.aligned_prefix_hashes(tokens, page, max_pages) == \
        jax_router.aligned_prefix_hashes(tokens, page, max_pages)


def test_aligned_hashes_leave_a_suffix_and_honour_the_bound():
    got = port_router.aligned_prefix_hashes(list(range(9)), 4, 64)
    assert [c for c, _ in got] == [8, 4]
    assert [c for c, _ in port_router.aligned_prefix_hashes(
        list(range(8)), 4, 64)] == [4]
    assert [c for c, _ in port_router.aligned_prefix_hashes(
        list(range(100)), 4, 2)] == [8, 4]
    assert port_router.aligned_prefix_hashes([1, 2], 4, 64) == []


# --------------------------------------------------------------- plans
class FakeLeader:
    """``routing_view`` / evict surface of a leader, no threads."""

    def __init__(self, members):
        self.members = members
        self.evict_listeners = []
        self.status_sources = {}
        self.evicted = []

    def routing_view(self):
        return [dict(m, summary=dict(m["summary"])) for m in self.members]

    def add_evict_listener(self, fn):
        self.evict_listeners.append(fn)

    def evict(self, host_id, reason="manual"):
        self.evicted.append((host_id, reason))
        self.members = [m for m in self.members if m["host_id"] != host_id]
        for fn in self.evict_listeners:
            fn(host_id, reason)


def member(host, *, hashes=(), page=4, active=0, waiting=0,
           pass_p50=0.01, status="UP"):
    return {"host_id": host, "address": f"127.0.0.1:1{host[-1]}",
            "status": status,
            "summary": {"active_slots": active, "waiting": waiting,
                        "pass_p50_s": pass_p50,
                        "prefix_digest": {"page": page,
                                          "hashes": list(hashes)}}}


PROMPT = list(range(20))  # page 4: candidates 16, 12, 8, 4
H = port_router.prefix_hash


def _plan_cases():
    """(members, session pins, sessions to plan, config kwargs): the JAX
    package's TestPlan cases."""
    return {
        "longest_prefix_beats_load": (
            [member("w2"), member("w1", hashes=[H(PROMPT[:8])], active=3,
                                  waiting=4)], {}, [None], {}),
        "longer_coverage_beats_shorter": (
            [member("w1", hashes=[H(PROMPT[:4])]),
             member("w2", hashes=[H(PROMPT[:16])])], {}, [None], {}),
        "load_tiebreak_depth_x_sec_per_token": (
            [member("w1", active=4, waiting=2, pass_p50=0.01),
             member("w2", active=1, waiting=1, pass_p50=0.02)],
            {}, [None], {}),
        "tokens_per_s_when_no_pass_p50": (
            [dict(member("w1", active=2), summary={
                "active_slots": 2, "tokens_per_s": 100.0}),
             dict(member("w2", active=2), summary={
                 "active_slots": 2, "tokens_per_s": 50.0})],
            {}, [None], {}),
        "affinity_moves_its_host_first": (
            [member("w1", hashes=[H(PROMPT[:8])]), member("w2")],
            {"s1": "w2"}, ["s1"], {}),
        "non_up_members_never_candidates": (
            [member("w1", status="DOWN"), member("w3",
                                                 status="QUARANTINED"),
             member("w2")], {}, [None], {}),
        "round_robin_rotates": (
            [member("w1"), member("w2")], {}, [None] * 4,
            {"policy": "round_robin"}),
        "digest_bound_limits_the_probe": (
            [member("w1", hashes=[H(PROMPT[:16])]),
             member("w2", hashes=[H(PROMPT[:4])])], {}, [None],
            {"digest_max_pages": 2}),
    }


@pytest.mark.parametrize("case", sorted(_plan_cases()))
def test_plan_agrees_with_the_jax_router(case):
    members, pins, sessions, kw = _plan_cases()[case]
    plans = []
    for mod in (port_router, jax_router):
        router = mod.FleetRouter(FakeLeader(members),
                                 mod.RouterConfig(**kw))
        for s, host in pins.items():
            router.affinity.put(s, host)
        plans.append([router.plan(PROMPT, session=s) for s in sessions])
    assert plans[0] == plans[1]
    assert plans[0][0], "every case plans at least one member"


def test_evict_drops_affinity_and_the_member():
    leader = FakeLeader([member("w1"), member("w2")])
    router = port_router.FleetRouter(leader)
    router.affinity.put("s1", "w1")
    leader.evict("w1", reason="leave")
    assert router.affinity.get("s1") is None
    assert [c["host_id"] for c in router.plan(PROMPT)] == ["w2"]


# ----------------------------------------------------------- affinity
@pytest.mark.parametrize("size", [0, 2, 8])
def test_session_affinity_agrees_with_the_jax_one(size):
    ops = [("put", "a", "h1"), ("put", "b", "h2"), ("get", "a"),
           ("put", "c", "h3"), ("get", "b"), ("get", "c"),
           ("put", "d", "h1"), ("drop", "h1"), ("get", "a"), ("get", "d")]
    outs = []
    for mod in (port_router, jax_router):
        aff, out = mod.SessionAffinity(size), []
        for op in ops:
            if op[0] == "put":
                aff.put(op[1], op[2])
            elif op[0] == "get":
                out.append(aff.get(op[1]))
            else:
                out.append(aff.drop_host(op[1]))
        out.append(aff.state())
        outs.append(out)
    assert outs[0] == outs[1]


# ---------------------------------------------------------- autoscaler
class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def load_view(*loads, occ=0.5):
    return [{"host_id": f"w{i}",
             "summary": {"active_slots": load, "waiting": 0,
                         "occupancy_mean": occ}}
            for i, load in enumerate(loads)]


def _scale_cases():
    """(config kwargs, [(advance_s, view), ...]): the JAX package's
    TestAutoscaler sequences."""
    busy, calm = load_view(6, 6), load_view(1, 1)
    idle = load_view(2, 1, occ=0.01)
    alone = load_view(0, occ=0.0)
    return {
        "sustained_pressure_scales_up": (
            {}, [(0, busy), (9.9, busy), (0.2, busy)]),
        "blip_rearms_the_window": (
            {}, [(0, busy), (8, calm), (4, busy)]),
        "sustained_idle_scales_down_least_loaded": (
            {}, [(0, idle), (11, idle)]),
        "single_host_never_scales_down": ({}, [(0, alone), (60, alone)]),
        "cooldown_spaces_decisions": (
            {}, [(0, busy), (11, busy), (11, busy), (31, busy)]),
        "no_setpoint_no_pressure": (
            {"setpoint_concurrency": 0}, [(0, busy), (60, busy)]),
    }


@pytest.mark.parametrize("case", sorted(_scale_cases()))
def test_autoscaler_decides_as_the_jax_one(case):
    kw, steps = _scale_cases()[case]
    kw = {"autoscale": True, "setpoint_concurrency": 4, "sustain_s": 10.0,
          "cooldown_s": 30.0, **kw}
    decisions = []
    for mod in (port_router, jax_router):
        clock = FakeClock()
        scaler = mod.Autoscaler(mod.RouterConfig(**kw), clock=clock)
        out = []
        for advance, view in steps:
            clock.now += advance
            out.append(scaler.observe(view))
        decisions.append(out)
    assert decisions[0] == decisions[1]


def test_act_mode_routes_scale_down_through_leader_evict():
    clock = FakeClock()
    leader = FakeLeader([member("w0"), member("w1")])
    router = port_router.FleetRouter(leader, port_router.RouterConfig(
        autoscale=True, autoscale_act=True, setpoint_concurrency=4,
        sustain_s=10.0, cooldown_s=30.0), clock=clock)
    router.autoscaler.observe(load_view(1, 2, occ=0.01))
    clock.now += 11
    assert router.autoscaler.observe(
        load_view(1, 2, occ=0.01))["action"] == "scale_down"
    assert leader.evicted == [("w0", "scale_down")]


def test_setpoint_file_read(tmp_path):
    path = tmp_path / "setpoint.json"
    path.write_text(json.dumps({"max_concurrency": 7}))
    scaler = port_router.Autoscaler(port_router.RouterConfig())
    scaler.load_setpoint_file(str(path))
    assert scaler.setpoint == 7
    scaler.load_setpoint_file(str(tmp_path / "missing.json"))
    assert scaler.setpoint == 7


# -------------------------------------------------------- routing text
@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": "be terse"},
        {"role": "user", "content": [{"text": "hi"}, {"text": "!"}]}]}),
    ("/chat", {"messages": [{"content": "a"}, {"content": "b"}]}),
    ("/chat", {"prompt": "p"}),
    ("/v1/completions", {"prompt": "q"}),
    ("/chat", {}),
    ("/v1/chat/completions", {"messages": "nope"}),
])
def test_routing_text_agrees_with_the_jax_router(path, body):
    assert port_router.FleetRouter.routing_text(path, body) == \
        jax_router.FleetRouter.routing_text(path, body)


def test_routing_text_is_the_port_workers_chat_template():
    from gofr_tpu_torch.serving.openai_compat import _render_messages
    messages = [{"role": "system", "content": "be terse"},
                {"role": "user", "content": "hi"}]
    assert port_router.FleetRouter.routing_text(
        "/v1/chat/completions", {"messages": messages}) == \
        _render_messages(messages)


# ------------------------------------------------------- live proxying
class ScriptedWorker:
    """A port server whose ``POST /chat`` echoes its name, streams a gated
    SSE answer, or answers typed-503 / bare-503 / 429."""

    def __init__(self, name):
        self.name = name
        self.hits = 0
        self.mode = "ok"
        self.started = threading.Event()
        self.release = threading.Event()
        self.closed = threading.Event()
        self.server = ChatServer(("127.0.0.1", 0))
        self.server.post("/chat", self.chat)
        self.server.get("/v1/models", lambda ctx: Raw(
            {"object": "list", "data": [{"id": self.name}]}))
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       args=(0.01,), daemon=True)
        self.thread.start()

    @property
    def address(self):
        return f"127.0.0.1:{self.server.port}"

    def chat(self, ctx):
        self.hits += 1
        if self.mode == "draining":
            return Reply(503, json.dumps({"error": {
                "message": "draining", "details": {"code": "draining"}}})
                .encode(), headers={"Retry-After": "1"})
        if self.mode == "plain_503":
            return Reply(503, b'{"error": {"message": "wedged"}}')
        if self.mode == "rate_limited":
            return Reply(429, json.dumps({"error": {
                "message": "slow down",
                "details": {"code": "rate_limited"}}}).encode(),
                headers={"Retry-After": "2"})
        body = ctx.bind() or {}
        if body.get("stream"):
            def sse():
                try:
                    self.started.set()
                    yield "data: first\n\n"
                    while not self.release.wait(0.005):
                        yield ""
                    yield "data: second\n\n"
                    yield "data: [DONE]\n\n"
                finally:
                    self.closed.set()
            return Stream(sse())
        return {"host": self.name, "echo": body.get("prompt", "")}

    def stop(self):
        self.release.set()
        self.server.shutdown()
        self.server.server_close()


class Fleet:
    def __init__(self, **leader_kw):
        from gofr_tpu_torch.serving.router import RouterConfig
        leader_kw.setdefault("router", RouterConfig(max_retries=2,
                                                    affinity_size=16))
        # members join by hand and never beat: no sweep may evict them
        leader_kw.setdefault("heartbeat_interval_s", 60.0)
        self.server = serve_fleet_leader(**leader_kw)
        self.leader = self.server.leader
        self.router = self.leader.router
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       args=(0.01,), daemon=True)
        self.thread.start()
        self.workers = {}

    def add(self, name):
        w = ScriptedWorker(name)
        self.workers[name] = w
        self.leader.join(name, w.address, 1)
        return w

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.server.port,
                                          timeout=30)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json",
                                  **(headers or {})})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def chat(self, body, headers=None):
        return self.request("POST", "/chat", body, headers)

    def close(self):
        for w in self.workers.values():
            w.stop()
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture()
def fleet():
    f = Fleet()
    f.add("w1")
    f.add("w2")
    yield f
    f.close()


def test_proxies_and_pins_a_session(fleet):
    status, _, body = fleet.chat({"prompt": "hello", "session": "s1"})
    assert status == 201, body
    first = json.loads(body)["data"]["host"]
    for _ in range(3):
        status, _, body = fleet.chat({"prompt": "again", "session": "s1"})
        assert status == 201
        assert json.loads(body)["data"]["host"] == first
    assert fleet.workers[first].hits == 4
    state = fleet.router.debug_state()
    assert state["affinity"]["hits"] >= 3 and state["routed_total"] == 4


def test_session_header_works_like_the_body_field(fleet):
    status, _, body = fleet.chat({"prompt": "x"},
                                 headers={"X-Session-Id": "hdr"})
    assert status == 201
    assert fleet.router.affinity.get("hdr") == \
        json.loads(body)["data"]["host"]


def test_typed_503_fails_over_to_the_survivor(fleet):
    fleet.workers["w1"].mode = "draining"
    fleet.router.affinity.put("s", "w1")
    status, _, body = fleet.chat({"prompt": "failover", "session": "s"})
    assert status == 201, body
    assert json.loads(body)["data"]["host"] == "w2"
    assert fleet.workers["w1"].hits == 1
    assert fleet.router.debug_state()["retries"] == 1
    assert fleet.router.affinity.get("s") == "w2"
    retries = fleet.leader.events.snapshot(kind="router.retry")
    assert [(e["cause"], e["attrs"]["host"]) for e in retries] == \
        [("draining", "w1")]


def test_429_mirrors_at_once_with_retry_after(fleet):
    for w in fleet.workers.values():
        w.mode = "rate_limited"
    status, headers, _ = fleet.chat({"prompt": "x"})
    assert status == 429 and headers.get("Retry-After") == "2"
    assert sum(w.hits for w in fleet.workers.values()) == 1


def test_untyped_503_is_not_retried(fleet):
    for w in fleet.workers.values():
        w.mode = "plain_503"
    status, _, _ = fleet.chat({"prompt": "x"})
    assert status == 503
    assert sum(w.hits for w in fleet.workers.values()) == 1


def test_all_hosts_draining_mirrors_the_last_503(fleet):
    for w in fleet.workers.values():
        w.mode = "draining"
    status, headers, body = fleet.chat({"prompt": "x"})
    assert status == 503 and headers.get("Retry-After") == "1"
    assert json.loads(body)["error"]["details"]["code"] == "draining"


def test_a_dead_member_fails_over_by_connect_error(fleet):
    fleet.leader.join("w0", "127.0.0.1:1", 1)   # nothing listens there
    fleet.router.affinity.put("s", "w0")
    status, _, body = fleet.chat({"prompt": "x", "session": "s"})
    assert status == 201, body
    failovers = fleet.leader.events.snapshot(kind="router.failover")
    assert [e["cause"] for e in failovers] == ["connect_error"]


def test_sse_passes_through_a_leave_mid_stream(fleet):
    """The stream in flight on w1 ends with its terminal chunk while the
    leave takes w1 out of the next plan at once."""
    w1 = fleet.workers["w1"]
    fleet.router.affinity.put("s", "w1")
    result = {}

    def stream():
        result["answer"] = fleet.chat({"prompt": "x", "stream": True,
                                       "session": "s"})

    t = threading.Thread(target=stream)
    t.start()
    assert w1.started.wait(30)
    status, _, _ = fleet.request("POST", "/control/leave",
                                 {"host_id": "w1"})
    assert status == 201
    assert fleet.router.affinity.get("s") is None
    status, _, body = fleet.chat({"prompt": "after", "session": "s"})
    assert status == 201 and json.loads(body)["data"]["host"] == "w2"
    hits = w1.hits
    w1.release.set()
    t.join(30)
    status, headers, body = result["answer"]
    assert status == 200
    assert headers["Content-Type"] == "text/event-stream"
    text = body.decode()
    assert text == "data: first\n\ndata: second\n\ndata: [DONE]\n\n"
    assert w1.hits == hits


def test_client_abort_cancels_the_upstream_and_counts(fleet):
    """The client leaves after the first event while the worker is
    quiet: the proxy's idle polls let the server see it go, closing the
    proxied stream closes the worker's connection (its generator is
    closed before the worker is released), and the abort is counted."""
    w1 = fleet.workers["w1"]
    fleet.router.affinity.put("s", "w1")
    sock = __import__("socket").create_connection(
        ("127.0.0.1", fleet.server.port), timeout=30)
    body = json.dumps({"prompt": "x", "stream": True,
                       "session": "s"}).encode()
    sock.sendall(b"POST /chat HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    got = b""
    while b"data: first" not in got:
        got += sock.recv(4096)
    sock.close()
    assert w1.closed.wait(30), "the worker's stream was never closed"
    assert not w1.release.is_set()
    assert fleet.router.debug_state()["client_aborts"] == 1
    text = fleet.server.metrics.render_prometheus()
    assert "app_router_client_aborts 1" in text
    status, _, _ = fleet.chat({"prompt": "after"})
    assert status == 201


def test_v1_models_passes_through_from_a_member(fleet):
    status, headers, body = fleet.request("GET", "/v1/models")
    assert status == 200
    assert headers["Content-Type"] == "application/json"
    assert json.loads(body)["data"][0]["id"] in ("w1", "w2")


def test_no_members_is_a_typed_503():
    f = Fleet()
    try:
        status, headers, body = f.chat({"prompt": "x"})
        assert status == 503 and headers.get("Retry-After") == "1"
        assert json.loads(body)["error"]["details"]["code"] == "no_members"
        status, _, body = f.request("GET", "/v1/models")
        assert status == 503
        assert json.loads(body)["error"]["details"]["code"] == "no_members"
    finally:
        f.close()


def test_router_metrics_and_debug_fleet(fleet):
    assert fleet.chat({"prompt": "x"})[0] == 201
    status, _, body = fleet.request("GET", "/debug/fleet")
    assert status == 200
    doc = json.loads(body)["data"]
    assert doc["router"]["routed_total"] == 1
    assert doc["router"]["policy"] == "prefix"
    text = fleet.server.metrics.render_prometheus()
    assert "app_router_routed{" in text
    assert "app_router_cache_hit_ratio" in text


def test_standby_router_answers_typed_not_leader():
    from gofr_tpu_torch.serving.router import RouterConfig
    f = Fleet(rank=1, router=RouterConfig(max_retries=0))
    try:
        status, _, body = f.chat({"prompt": "hi"})
        assert status == 503
        assert json.loads(body)["error"]["details"]["code"] == "not_leader"
    finally:
        f.close()


def test_converging_takeover_answers_retryable_503():
    from gofr_tpu_torch.serving.router import RouterConfig
    f = Fleet(rank=1, router=RouterConfig(max_retries=0))
    try:
        f.leader.ensure_active(worker_epoch=1)
        status, headers, body = f.chat({"prompt": "hi"})
        assert status == 503
        assert json.loads(body)["error"]["details"]["code"] == \
            "leader_takeover"
        assert int(headers["Retry-After"]) >= 1
        f.leader.join("w1", "127.0.0.1:1", 1)
        assert f.leader.leadership()["converging"] is False
    finally:
        f.close()


def test_concurrent_routing_loses_no_count():
    """More threads than cores note routes and pin sessions under a tiny
    switch interval: the counts and the affinity map stay exact."""
    import sys
    router = port_router.FleetRouter(FakeLeader([member("w1"),
                                                 member("w2")]))

    def work(k):
        for i in range(200):
            router._note_routed({"host_id": f"w{1 + i % 2}",
                                 "covered": i % 3, "affinity": False},
                                f"s{k}-{i % 5}", retried=i % 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    state = router.debug_state()
    assert state["routed_total"] == 3200 == sum(state["routed"].values())
    assert state["routed"] == {"w1": 1600, "w2": 1600}
    assert state["retries"] == 1600
    assert state["affinity"]["entries"] == 80
    assert state["cache_hit_ratio"] == round(16 * 133 / 3200, 4)
