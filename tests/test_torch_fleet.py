"""The port's fleet plane against the JAX package's, on the CPU at the
tiny config: metrics federation byte for byte, the event merger, the
flight recorder's fleet summary, the engine's prefix digest hash for hash
(paged, the pool's view, slot), the leader's state under one join /
heartbeat / evict / quarantine sequence, a port worker joining a JAX
leader (planned to by JAX's router) and a JAX worker joining the port
leader (planned to by the port's), leader HA over real HTTP (fencing,
the candidate walk, takeover), and ``serve_fleet_leader`` /
``join_fleet`` end to end with two port engines. Live tests bind port 0
and wait on events and counts."""

import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.metrics import registry as jax_registry
from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving import control_plane as jax_cp
from gofr_tpu.serving import events as jax_events
from gofr_tpu.serving import observability as jax_obs
from gofr_tpu.serving import router as jax_router
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu_torch import metrics as port_metrics
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving import control_plane as port_cp
from gofr_tpu_torch.serving import events as port_events
from gofr_tpu_torch.serving import observability as port_obs
from gofr_tpu_torch.serving import router as port_router
from gofr_tpu_torch.serving.app import (build_engine, build_server,
                                        join_fleet, serve_fleet_leader)
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.faults import FaultPlan
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.serving.logger import (Logger, clear_fleet_context,
                                           current_fleet_context)
from gofr_tpu_torch.service import probe_leader, resolve_leader
from gofr_tpu_torch.tracing import InMemoryExporter, Tracer

from .apputil import AppRunner

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_fleet_context():
    yield
    clear_fleet_context()
    from gofr_tpu.logging.logger import clear_fleet_context as jax_clear
    jax_clear()


def _wait(cond, what, timeout_s=60.0):
    """Poll ``cond`` until true; a generous deadline that only catches a
    hang, never a bound on how fast the fleet should be."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"never happened: {what}")
        time.sleep(0.01)


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, args=(0.01,),
                              daemon=True)
    thread.start()
    return thread


def _close(server):
    server.shutdown()
    server.server_close()


# ------------------------------------------------- metrics federation
def _write_both(seed):
    """The same seeded writes on a JAX and a port manager."""
    rng = np.random.default_rng(seed)
    managers = (jax_registry.Manager(), port_metrics.Manager())
    for m in managers:
        m.new_counter("jobs_total", "jobs")
        m.new_up_down_counter("inflight", "in flight")
        m.new_gauge("temp", "temperature")
        m.new_histogram("lat", "latency", buckets=(0.01, 0.1, 1.0))
    for _ in range(40):
        op = int(rng.integers(0, 4))
        label = {"queue": str(rng.choice(["a", "b", "c"]))}
        value = float(np.round(rng.uniform(0, 2), 3))
        for m in managers:
            if op == 0:
                m.add_counter("jobs_total", value, **label)
            elif op == 1:
                m.delta_up_down_counter("inflight", value - 1.0, **label)
            elif op == 2:
                m.set_gauge("temp", value, **label)
            else:
                m.record_histogram("lat", value, **label)
    return managers


@pytest.mark.parametrize("seed", range(3))
def test_snapshot_merge_and_federation_equal_the_jax_packages(seed):
    hosts = ("h0", "h1", "h2")
    snaps = [_write_both(seed * 10 + i) for i in range(len(hosts))]
    jax_snaps = {h: s[0].snapshot() for h, s in zip(hosts, snaps)}
    port_snaps = {h: s[1].snapshot() for h, s in zip(hosts, snaps)}
    assert json.dumps(port_snaps) == json.dumps(jax_snaps)
    assert json.dumps(port_metrics.merge_snapshots(port_snaps)) == \
        json.dumps(jax_registry.merge_snapshots(jax_snaps))
    labels = {h: {"host": h, "rank": str(i)} for i, h in enumerate(hosts)}
    want = jax_registry.render_federated(jax_snaps, labels)
    assert port_metrics.render_federated(port_snaps, labels) == want
    assert port_metrics.render_federated(port_snaps) == \
        jax_registry.render_federated(jax_snaps)
    assert 'host="h2",queue="a",rank="2"' in want


def test_mismatched_histogram_layouts_stay_per_host():
    a, b = port_metrics.Manager(), port_metrics.Manager()
    a.new_histogram("lat", "l", buckets=(0.1,))
    b.new_histogram("lat", "l", buckets=(0.5,))
    a.record_histogram("lat", 0.05)
    b.record_histogram("lat", 0.05)
    snaps = {"a": a.snapshot(), "b": b.snapshot()}
    assert port_metrics.merge_snapshots(snaps) == \
        jax_registry.merge_snapshots(snaps)


# --------------------------------------------------- event merging
def test_fleet_event_merger_equals_the_jax_one():
    digests = []
    for host, base, offset in (("w0", 100.0, 0.5), ("w1", 100.2, -0.3)):
        events = [{"seq": i + 1, "ts": base + 0.1 * i, "host": host,
                   "kind": "fleet.evict", "severity": "warn",
                   "epoch": i % 2} for i in range(5)]
        digests.append((host, {"now": 200.0 - offset, "host": host,
                               "seq": 5, "dropped": {"x": 1},
                               "events": events}, 200.0))
    outs = []
    for mod in (port_events, jax_events):
        merger = mod.FleetEventMerger(capacity_per_host=4)
        for host, digest, received in digests:
            merger.ingest(host, digest, received=received)
            merger.ingest(host, digest, received=received)  # dedup by seq
        outs.append((merger.timeline(), merger.timeline(since=100.5),
                     merger.timeline(kind="fleet.evict", n=3),
                     merger.to_jsonl(n=2), merger.header()))
    assert outs[0] == outs[1]


def test_ledger_digest_matches_the_jax_ledgers_shape():
    clock = iter(range(100, 200)).__next__
    got = port_events.EventLedger(port_events.EventLedgerConfig(
        digest_size=2), host="h", clock=clock)
    clock2 = iter(range(100, 200)).__next__
    want = jax_events.EventLedger(jax_events.EventLedgerConfig(
        digest_size=2), host="h", clock=clock2)
    for ledger in (got, want):
        for cause in ("a", "b", "c"):
            ledger.emit("fleet.evict", cause=cause)
    assert got.digest() == want.digest()
    assert port_events.NO_EVENTS.digest()["events"] == []


# ---------------------------------------------------- fleet summary
def test_fleet_summary_equals_the_jax_recorders(monkeypatch):
    recs = (port_obs.FlightRecorder(), jax_obs.FlightRecorder())
    blocks = {"goodput_source": lambda: {"goodput_ratio": 0.5,
                                         "busy_s": 2.0, "useful_s": 1.0,
                                         "waste_s": {"padding": 1.0}},
              "prefix_digest_source": lambda: {"page": 64, "hashes": ["a"]},
              "cost_source": lambda: {"decode/0": {"mean_s": 0.01, "n": 3}},
              "integrity_source": lambda: {"seq": 2, "probe_digests": {
                  "g0": "d"}}}
    for rec in recs:
        for name, fn in blocks.items():
            setattr(rec, name, fn)
        for i in range(12):
            with monkeypatch.context() as m:
                m.setattr(time, "time", lambda i=i: 1000.0 + 0.1 * i)
                rec.record_pass("decode", dur=0.001 * (i % 5),
                                occupancy=i % 8, queue_depth=i % 3,
                                tokens=8)
    assert recs[0].fleet_summary() == recs[1].fleet_summary()
    recs[0].cost_source = lambda: 1 / 0   # a broken source drops out
    assert "costs" not in recs[0].fleet_summary()


# ------------------------------------------------------ prefix digest
def _converted_tiny():
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny(), "cpu")
    return jparams, tparams


def _waves():
    rng = np.random.default_rng(21)
    first = [rng.integers(0, 256, size=n).tolist() for n in (20, 40, 70)]
    tail = [rng.integers(0, 256, size=n).tolist() for n in (9, 11, 7)]
    second = [first[0][:17] + tail[0], first[2][:50] + tail[1], tail[2]]
    return [first, second]


def _serve_waves(engine, waves, params):
    engine.start()
    try:
        for wave in waves:
            batch = [engine.submit(p, params) for p in wave]
            _wait(lambda: all(r.finished_at is not None or r.error
                              for r in batch), "a wave ended")
            assert all(r.error is None for r in batch)
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def jax_digests():
    """The JAX engine's digest after the waves, on the paged layout (its
    prefix cache) and the slot layout (none)."""
    jparams, tparams = _converted_tiny()
    common = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
                  decode_steps_per_pass=4, prefix_cache=True,
                  prefix_digest_hashes=3)
    out = {"tparams": tparams}
    jeng = jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                        compile_cache_dir=None, **common),
        implementation="xla")
    _serve_waves(jeng, _waves(),
                 JaxSamplingParams(temperature=0.0, max_new_tokens=3))
    jeng._prefix_digest_dirty = True
    jeng._refresh_prefix_digest()
    out["paged"] = jeng.prefix_digest()
    out["paged_summary_keys"] = set(jeng.recorder.fleet_summary())
    out["paged_hits"] = jeng.stats["prefix_hits"]
    slot = jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="slot", compile_cache_dir=None, **common),
        implementation="xla")
    slot._refresh_prefix_digest()
    out["slot"] = slot.prefix_digest()
    return out


@pytest.mark.parametrize("layout", ["paged", "view", "slot"])
def test_prefix_digest_equals_the_jax_engines(jax_digests, layout):
    kw = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefix_cache=True,
              prefix_digest_hashes=3)
    if layout == "view":
        kw["paged_attention"] = "view"
    if layout == "slot":
        kw["kv_layout"] = "slot"
    teng = llama_engine(jax_digests["tparams"], LlamaConfig.tiny(),
                        EngineConfig(**kw), device="cpu")
    _serve_waves(teng, _waves(),
                 SamplingParams(temperature=0.0, max_new_tokens=3))
    teng._refresh_prefix_digest()
    want = jax_digests["slot" if layout == "slot" else "paged"]
    assert teng.prefix_digest() == want
    if layout == "slot":
        assert want is None
        return
    # 4 keys pinned, the newest 3 hashed, in LRU order
    assert want["entries"] == 4 and len(want["hashes"]) == 3
    assert teng.stats["prefix_hits"] == jax_digests["paged_hits"] == 1
    summary = teng.recorder.fleet_summary()
    assert summary["prefix_digest"] == want
    assert set(summary) == jax_digests["paged_summary_keys"]


def test_the_digest_tracks_the_cache_and_skips_a_clean_rebuild():
    engine = build_engine(LlamaConfig.tiny(), device="cpu",
                          engine_config=EngineConfig(
                              max_batch=2, max_seq=64, page_size=4,
                              prefix_digest_hashes=2, seed=0))
    keys = [tuple(range(n)) for n in (4, 8, 12)]
    for k in keys:
        engine._prefix_cache[k] = []
    engine._prefix_digest_dirty = True
    engine._refresh_prefix_digest()
    d = engine.prefix_digest()
    assert d["page"] == 4 and d["entries"] == 3
    assert d["hashes"] == [port_router.prefix_hash(k) for k in keys[-2:]]
    engine._prefix_cache[tuple(range(20, 28))] = []   # no dirty mark
    engine._refresh_prefix_digest()
    assert engine.prefix_digest() is d
    engine._attach_prefix(0, list(keys[0]) + [1], 4)  # an LRU touch
    assert engine._prefix_digest_dirty
    engine._reset_pages()
    engine._refresh_prefix_digest()
    assert engine.prefix_digest()["hashes"] == []
    off = build_engine(LlamaConfig.tiny(), device="cpu",
                       engine_config=EngineConfig(max_batch=2, max_seq=64,
                                                  page_size=4,
                                                  prefix_digest_hashes=0))
    assert off.recorder.prefix_digest_source is None


# ------------------------------------------- leader parity (no HTTP)
def _summary(p95, occ, costs=None, probe=None, seq=0):
    out = {"pass_p95_s": p95, "pass_p50_s": p95 / 2, "occupancy_mean": occ,
           "busy_s": 10.0, "useful_s": 6.0,
           "waste_s": {"padding": 3.0, "bubble": 1.0}}
    if costs:
        out["costs"] = costs
    if probe:
        out["integrity"] = {"seq": seq, "probe_digests": probe}
    return out


def _leader_sequence(mod, metrics):
    """One join / heartbeat / evict / quarantine / rejoin sequence;
    the leader's views after each step, clocks left out."""
    leader = mod.ControlPlaneLeader(coordinator="10.0.0.1:8476",
                                    metrics=metrics, host_id="leader",
                                    fleet=mod.FleetConfig(
                                        integrity_clean_probes=2))
    views = []

    def view():
        topo = leader.topology()
        for m in topo["members"].values():
            m.pop("last_seen")
        status = leader.fleet_status()
        for h in status["hosts"].values():
            h.pop("last_seen_age_s")
        views.append({"topology": topo, "status": status,
                      "routing": leader.routing_view(),
                      "generation": leader.generation,
                      "metrics": metrics.render_prometheus(
                          prefix="app_fleet_")})

    assignments = [leader.join(h, f"127.0.0.1:90{i}", 2).to_dict()
                   for i, h in enumerate(("c", "a", "b", "d"))]
    view()
    costs = {"decode/0": {"mean_s": 0.01, "n": 4}}
    slow = {"decode/0": {"mean_s": 0.05, "n": 4}}
    for seq in (1, 2):
        for h, p95, occ, c, digest in (
                ("a", 0.01, 0.5, costs, "good"),
                ("b", 0.012, 0.6, costs, "good"),
                ("c", 0.05, 0.9, slow, "bad" if seq else "good"),
                ("d", 0.011, 0.4, costs, "good")):
            a, changed = leader.heartbeat(
                h, 1, {"status": "UP"},
                _summary(p95, occ, c, {"g0": digest}, seq))
            assignments.append((a.to_dict(), changed))
        view()
    leader.evict("d", reason="manual")
    view()
    # degraded gossip evicts at once; the quarantined host heals
    a, changed = leader.heartbeat("b", 1, {"status": "DEGRADED"})
    assignments.append((a, changed))
    for seq in (3, 4, 5):
        for h in ("a", "c"):
            leader.heartbeat(h, 5, {"status": "UP"},
                             _summary(0.01, 0.5, costs, {"g0": "good"},
                                      seq))
        leader.join("e", "127.0.0.1:905", 1)
        leader.heartbeat("e", 6, {"status": "UP"},
                         _summary(0.01, 0.5, costs, {"g0": "good"}, seq))
        view()
    return views, assignments, leader


def test_port_and_jax_leaders_agree_on_one_sequence():
    got, got_assign, port = _leader_sequence(port_cp, port_metrics.Manager())
    want, want_assign, jax_leader = _leader_sequence(
        jax_cp, jax_registry.Manager())
    assert got_assign == want_assign
    for g, w in zip(got, want):
        assert g == w
    # the sequence did what it claims: c quarantined, then healed
    statuses = [v["status"]["integrity"]["quarantined"] for v in got]
    assert "c" in statuses[2] and statuses[-1] == {}
    assert [e["attrs"]["outlier"] for e in port.events.snapshot(
        kind="fleet.integrity_divergence")] == ["c"]
    assert [i["reason"] for i in port.incidents.list()] == \
        [i["reason"] for i in jax_leader.incidents.list()] == \
        ["integrity_divergence"]
    assert got[2]["status"]["fleet"]["stragglers"] == ["c"]


def test_dist_init_args_hand_off_to_torch_distributed():
    a = port_cp.ShardAssignment(host_id="h", rank=1, world_size=4,
                                n_devices=1, generation=7,
                                coordinator="10.0.0.1:8476")
    assert a.dist_init_args() == {"init_method": "tcp://10.0.0.1:8476",
                                  "world_size": 4, "rank": 1}
    assert a.to_dict() == jax_cp.ShardAssignment(
        host_id="h", rank=1, world_size=4, n_devices=1, generation=7,
        coordinator="10.0.0.1:8476").to_dict()


# ---------------------------------------------- across the packages
def _tiny_server(**cfg):
    # the byte tokenizer's specials (bos = 257) need a 260-token vocab
    engine = build_engine(LlamaConfig.tiny().scaled(vocab_size=260),
                          device="cpu",
                          engine_config=EngineConfig(
                              max_batch=2, max_seq=128, page_size=16,
                              seed=0, **cfg))
    server = build_server(engine, port=0, name="tiny",
                          logger=Logger(out=open("/dev/null", "w")))
    return engine, server


def _chat(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/chat", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_a_port_worker_joins_a_jax_leader_and_jax_plans_to_it():
    holder = {}

    def build(app):
        holder["leader"] = app.serve_fleet_leader(host_id="jax-leader")

    prompt = "the shared system prompt of family A, long enough " * 2
    with AppRunner(build=build) as runner:
        engine, server = _tiny_server()
        _serve(server)
        engine.start()
        try:
            status, _ = _chat(server.port, {"prompt": prompt + "q1",
                                            "max_tokens": 2,
                                            "temperature": 0})
            assert status == 201
            _wait(lambda: engine.prefix_digest() and
                  engine.prefix_digest()["hashes"], "a digest")
            agent = join_fleet(server, f"http://127.0.0.1:{runner.port}",
                               host_id="port-worker",
                               heartbeat_interval_s=60.0)
            leader = holder["leader"]
            leader.join("jax-other", "127.0.0.1:1", 1)
            agent._heartbeat_once()
            plan = jax_router.FleetRouter(leader).plan(
                ByteTokenizer().encode(prompt + "q2"))
            assert plan[0]["host_id"] == "port-worker"
            assert plan[0]["covered"] > 0
            assert plan[0]["address"] == f"127.0.0.1:{server.port}"
            assert agent.assignment.world_size == 2
            host = leader.fleet_status()["hosts"]["port-worker"]
            assert host["federated"] and host["status"] == "UP"
        finally:
            engine.stop()
            _close(server)
        assert agent._thread is None   # stopped with the server


def test_a_jax_worker_joins_the_port_leader_and_the_port_plans_to_it():
    server = serve_fleet_leader(router=port_router.RouterConfig())
    _serve(server)
    tokens = list(range(1, 40))
    digest = {"page": 16, "entries": 1, "pages": 2,
              "hashes": [jax_router.prefix_hash(tokens[:32])]}
    try:
        agent = jax_cp.WorkerAgent(
            f"http://127.0.0.1:{server.port}", host_id="jax-worker",
            address="127.0.0.1:7", heartbeat_interval_s=60.0,
            summary_source=lambda: {"active_slots": 3,
                                    "prefix_digest": digest})
        agent.join()
        agent._heartbeat_once()
        server.leader.join("port-other", "127.0.0.1:8", 1)
        plan = server.leader.router.plan(tokens)
        assert [(c["host_id"], c["covered"]) for c in plan] == \
            [("jax-worker", 32), ("port-other", 0)]
        assert agent.assignment.rank == 0 and agent.epoch == 1
        assert agent.deregister() is True
        assert "jax-worker" not in server.leader.topology()["members"]
    finally:
        _close(server)


# ------------------------------------------------------------- HA
def _leader(rank=0, candidates=(), **kw):
    server = serve_fleet_leader(
        rank=rank, host_id=f"leader-{rank}", coordinator="10.0.0.1:8476",
        fleet=port_cp.FleetConfig(leader_candidates=tuple(candidates)),
        logger=Logger(out=open("/dev/null", "w")), **kw)
    _serve(server)
    return server


def _agent(port, host_id, **kw):
    kw.setdefault("heartbeat_interval_s", 0.05)
    return port_cp.WorkerAgent(f"http://127.0.0.1:{port}", host_id=host_id,
                               n_devices=2, **kw)


def _ha_agent(ports, host_id, **kw):
    candidates = tuple(f"http://127.0.0.1:{p}" for p in ports)
    kw.setdefault("fleet", port_cp.FleetConfig(
        leader_candidates=candidates, missed_acks_before_failover=1))
    return _agent(ports[0], host_id, **kw)


@pytest.mark.parametrize("probes,known", [
    ([(0, True, 1), (1, True, 2), (2, False, 0)], 1),
    ([(0, True, 1), (2, False, 0)], 2),
    ([], 0),
    ([(1, True, 1), (0, True, 1)], 1),
    ([(1, False, 0), (2, False, 3)], 4),
])
def test_the_election_is_the_jax_packages(probes, known):
    docs = [{"rank": r, "url": f"u{r}", "active": a, "epoch": e}
            for r, a, e in probes]
    assert port_cp.WorkerAgent._choose_candidate(docs, known) == \
        jax_cp.WorkerAgent._choose_candidate(docs, known)


def test_a_standby_refuses_and_a_takeover_activates_above_all_epochs():
    standby = port_cp.ControlPlaneLeader(rank=1)
    with pytest.raises(port_cp.NotLeader):
        standby.join("w1", "127.0.0.1:1", 1)
    assert standby.ensure_active(worker_epoch=1)
    assert standby.active and standby.epoch == 2
    assert not standby.ensure_active(worker_epoch=0)
    leader = port_cp.ControlPlaneLeader(rank=0)
    with pytest.raises(port_cp.StaleLeader):
        leader.heartbeat("w1", -1, epoch=9)
    assert leader.active is False


def test_a_revived_stale_leader_is_fenced_then_reelected_higher():
    server = _leader()
    try:
        w = _agent(server.port, "w1")
        w.join()
        w.epoch = 3                # a newer leader was elected elsewhere
        w._heartbeat_once()        # 409 stale_leader -> fence -> walk
        assert w.failovers.get("stale_leader") == 1
        state = server.leader.leadership()
        assert state["stale_rejects"] >= 1
        assert state["active"] is True and state["epoch"] == 4
        assert w.epoch == 4
    finally:
        _close(server)


def test_missed_acks_walk_the_candidates_and_take_over():
    s0, s1 = _leader(0), _leader(1)
    try:
        w = _ha_agent((s0.port, s1.port), "w1",
                      summary_source=lambda: {"active_slots": 0})
        w.join()
        assert w.epoch == 1
        s0.leader.faults = FaultPlan.parse("leader_down:times=0")
        w._heartbeat_once()        # miss -> walk -> takeover of rank 1
        assert w.failovers.get("missed_acks") == 1
        assert s1.leader.active and s1.leader.epoch == 2 and w.epoch == 2
        assert [m["host_id"] for m in s1.leader.routing_view()] == ["w1"]
        assert s1.leader.leadership()["converging"] is False
        assert [e["cause"] for e in s1.leader.events.snapshot(
            kind="fleet.failover")] == ["takeover"]
        urls = (f"http://127.0.0.1:{s0.port}", f"http://127.0.0.1:{s1.port}")
        assert probe_leader(urls[0]) is None      # down: no answer
        got = resolve_leader(urls)
        assert (got["rank"], got["epoch"]) == (1, 2)
    finally:
        _close(s0)
        _close(s1)


def test_a_partitioned_host_alone_elects_the_standby():
    s0 = _leader(0, faults="leader_partition:request=w1,times=0")
    s1 = _leader(1)
    try:
        w2 = _ha_agent((s0.port, s1.port), "w2")
        w2.join()
        w1 = _ha_agent((s0.port, s1.port), "w1")
        assert w1._locate_leader()
        assert s1.leader.active and "w1" in s1.leader.topology()["members"]
        w2._heartbeat_once()
        assert w2.failovers == {}
    finally:
        _close(s0)
        _close(s1)


def test_a_stale_epoch_replay_is_rejected_and_rejoined():
    server = _leader()
    try:
        w = _agent(server.port, "w1")
        w.join()
        server.leader.faults = FaultPlan.parse("stale_epoch_replay:at=1")
        w._heartbeat_once()
        assert w.failovers.get("stale_leader") == 1
        assert w.epoch == server.leader.epoch == 1
        assert "w1" in server.leader.topology()["members"]
    finally:
        _close(server)


def test_a_leave_in_a_takeover_window_lands_on_the_new_leader():
    s0, s1 = _leader(0), _leader(1)
    try:
        x = _ha_agent((s0.port, s1.port), "x")
        y = _ha_agent((s0.port, s1.port), "y")
        x.join()
        y.join()
        s0.leader.faults = FaultPlan.parse("leader_down:times=0")
        done: list = []
        t = threading.Thread(
            target=lambda: done.append(x.deregister(rounds=400)))
        t.start()
        y._heartbeat_once()        # miss -> walk -> rank 1 active
        t.join(60)
        assert done == [True]
        hosts = s1.leader.topology()["members"]
        assert "x" not in hosts and "y" in hosts
        x._heartbeat_once()        # a departed host is never re-adopted
        assert "x" not in s1.leader.topology()["members"]
    finally:
        _close(s0)
        _close(s1)


# ------------------------------------------------ membership, live
def test_ranks_evictions_and_degraded_gossip_over_http():
    # the silent host is evicted after 1 s; the beating ones (every
    # 0.05 s) would need a 1 s stall to be
    server = _leader(heartbeat_interval_s=0.5, eviction_misses=2)
    leader = server.leader
    try:
        seen = []
        c = _agent(server.port, "host-c",
                   on_assignment=lambda s: seen.append(s.generation))
        a = _agent(server.port, "host-a")
        b = _agent(server.port, "host-b")
        for w in (c, a, b):
            w.join()
        assert (a.assignment.rank, b.assignment.rank) == (0, 1)
        c._heartbeat_once()
        assert (c.assignment.rank, c.assignment.world_size) == (2, 3)
        assert seen == [1, 3]
        # b falls silent: the sweeper evicts it, the others close up
        a.start()
        c.start()
        _wait(lambda: leader.topology()["world_size"] == 2
              and c.assignment.rank == 1, "b evicted, c re-ranked")
        m = leader.metrics
        assert m.get("app_fleet_evictions").get(
            reason="heartbeat_timeout") == 1.0
        # DEGRADED gossip is evicted at once, DOWN keeps gossiping
        c.stop()
        state = {"status": "DEGRADED"}
        c.health_source = lambda: dict(state)
        c._heartbeat_once()
        assert c.assignment is None
        assert m.get("app_fleet_evictions").get(reason="degraded") == 1.0
        state["status"] = "DOWN"
        c.join()
        c._heartbeat_once()
        assert leader.health_check()["status"] == "DEGRADED"
        status, body = _get_json(server.port, "/.well-known/health")
        assert status == 200
        assert body["data"]["checks"]["control_plane"]["details"][
            "degraded_hosts"] == ["host-c"]
        a.stop()
    finally:
        _close(server)
    assert leader._running is False    # the sweeper stopped with it


@pytest.mark.parametrize("stall, evicted", [
    (None, True),             # 1.0 s of silence against a 0.6 s budget
    ((-0.1, 0.8), False),     # the leader itself paused 0.8 s of it
    ((-2.0, 0.8), True),      # a pause before the last beat credits none
    ((-0.1, 0.05), True),     # lateness under half an interval: no stall
])
def test_sweeper_credits_its_own_stall(stall, evicted):
    """A member is evicted for silence it owes to itself, not for the
    time the leader's own sweeper was paused (a long collection, a
    starved host)."""
    leader = port_cp.ControlPlaneLeader(heartbeat_interval_s=0.2,
                                        eviction_misses=3)
    leader.join("h", "127.0.0.1:1", 1)
    now = time.time()
    leader._members["h"].last_seen = now - 1.0
    if stall is not None:
        leader._note_stall(now + stall[0], stall[1])
    leader._sweep_once()
    assert ("h" not in leader.topology()["members"]) is evicted
    assert leader.stall_count == (stall is not None and stall[1] > 0.1)


@pytest.mark.parametrize("beat_s, delays", [
    (0.15, [0.2, 0.05, 0.05, 0.05]),   # the next beat: one interval on
    (0.3, [0.2, 0.0, 0.0, 0.0]),       # from the last one's start
])
def test_agent_beats_at_a_fixed_cadence(monkeypatch, beat_s, delays):
    """An assigned agent's beat is due one interval after the previous
    beat began, so a slow beat does not add its own length to the
    silence the leader sees."""
    clock = [100.0]
    fake_time = type("T", (), {"monotonic": staticmethod(lambda: clock[0]),
                               "time": staticmethod(time.time),
                               "sleep": staticmethod(time.sleep)})
    monkeypatch.setattr(port_cp, "time", fake_time)
    agent = port_cp.WorkerAgent("http://127.0.0.1:9", host_id="h",
                                heartbeat_interval_s=0.2)
    agent.join = lambda *a, **k: None
    agent.assignment = port_cp.ShardAssignment("h", 0, 1, 1, 1, "")
    waited = []

    class Wake:
        def wait(self, delay):
            waited.append(round(delay, 6))
            clock[0] += delay
            if len(waited) == len(delays):
                agent._running = False

        def set(self):
            pass

        def clear(self):
            pass

    def beat():
        clock[0] += beat_s

    agent._wake = Wake()
    agent._heartbeat_once = beat
    agent.start()
    agent._thread.join(30)
    assert waited == delays


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, json.loads(resp.read())


# ----------------------------------------------- the fleet, end to end
def test_serve_fleet_leader_and_join_fleet_route_by_prefix():
    exporter = InMemoryExporter()
    # beats every 0.05 s; nothing here is meant to be evicted
    leader_server = serve_fleet_leader(
        router=port_router.RouterConfig(), heartbeat_interval_s=0.05,
        eviction_misses=400, tracer=Tracer(exporter=exporter),
        logger=Logger(out=open("/dev/null", "w")))
    _serve(leader_server)
    leader = leader_server.leader
    url = f"http://127.0.0.1:{leader_server.port}"
    workers = []
    try:
        for name in ("w0", "w1"):
            engine, server = _tiny_server()
            _serve(server)
            engine.start()
            agent = join_fleet(server, url, host_id=name,
                               heartbeat_interval_s=0.05)
            workers.append((name, engine, server, agent))
        _wait(lambda: len(leader.routing_view()) == 2, "both joined")
        family = "a family system prompt that fills two pages " * 2
        status, body = _chat(leader_server.port, {
            "prompt": family + "first", "max_tokens": 2, "temperature": 0})
        assert status == 201
        first = leader.router.debug_state()["routed"]
        owner = next(iter(first))
        engines = {n: e for n, e, _, _ in workers}

        def digest_seen():
            hosts = [m["host_id"] for m in leader.routing_view()
                     if (m["summary"].get("prefix_digest") or {})
                     .get("hashes")]
            return hosts == [owner]
        _wait(digest_seen, "the owner's digest at the leader")
        hits = engines[owner].stats["prefix_hits"]
        for n in range(3):
            status, body = _chat(leader_server.port, {
                "prompt": family + f"follow-up {n}", "max_tokens": 2,
                "temperature": 0})
            assert status == 201
        assert leader.router.debug_state()["routed"] == {owner: 4}
        assert engines[owner].stats["prefix_hits"] == hits + 3
        # federation: each worker's series under its host label
        with urllib.request.urlopen(url + "/control/fleet/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
        for name, *_ in workers:
            assert f'app_engine_active_slots{{host="{name}"' in text
            assert f'app_gpu_device_count{{host="{name}"' in text
        assert "app_fleet_world_size 2" in text
        assert "app_router_routed{" in text
        # the fleet context rides the worker's spans and the leader's
        assert current_fleet_context()["host_id"] in ("w0", "w1")
        spans = [s for s in exporter.spans if s.name == "router.route"]
        assert spans and "host_id" in spans[0].attributes
    finally:
        for _, engine, server, agent in workers:
            engine.stop()
            _close(server)
            assert agent._thread is None
        _close(leader_server)
