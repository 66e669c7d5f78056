"""The port's ``App`` against JAX's ``App``, booted on free ports, on the
CPU.

Both serve an engine on the same converted tiny weights (``LlamaConfig.
tiny()`` at vocabulary 260, the byte tokenizer's; JAX's ``llama_engine``
on ``paged_attention="xla"``, the port's on the CPU) through
``serve_model`` and ``install_openai_routes``, once without auth and once
with ``enable_api_key_auth`` (a key named ``team-a``). Each request goes
to both. Compared exactly, ids, timestamps and timings aside
(``test_torch_openai._norm``): statuses, envelopes and the headers
(``X-Trace-Id`` and ``Content-Length`` aside) of alive, health's shape,
the 404 with ``registered_routes`` and the 405 with ``Allow``, every
``/chat`` and ``/v1`` case of ``test_torch_openai.CASES`` (unary and
SSE; tokens and ``usage`` equal) and every request's
``integrity.request_digest``; the 401 without a key and the tenant label
with one; the ``app_http_response`` label sets (route patterns); a
``subscribe`` handler over the in-memory broker; ``on_start`` /
``on_shutdown`` order; the typed 503 of a request sent during the
SIGTERM drain, with the requests in flight completing alike; a chat
handler over a websocket (``/ws/chat``, user code written once for each
package's engine) streaming the same tokens with equal digests. On the
port alone: ``REQUEST_TIMEOUT`` answers 408 and frees the slot, a client
that leaves mid-stream (over HTTP or a websocket) cancels its request, a
plain stream or websocket handler is never run on the loop's thread, and
``model_serving.build_app`` needs CUDA unless asked for the CPU.
"""

import asyncio
import http.client
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.app import App as JaxApp
from gofr_tpu.config.env import DictConfig as JaxDictConfig
from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.openai_compat import \
    install_openai_routes as jax_install_openai
from gofr_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config.env import DictConfig
from gofr_tpu_torch.handler import ThreadPump
from gofr_tpu_torch.http.response import Stream
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.handlers import POLL_S
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.openai_compat import install_openai_routes
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.websocket import connect as ws_connect

from .test_torch_openai import CASES, MODEL, _events, _norm
from .torch_parity import AppThread, time_limit

torch.set_num_threads(2)

COMMON = dict(max_batch=2, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefix_cache=False)
KEY, TENANT = "key-a", "team-a"
TOPIC = "jobs"
CONFIG = {"HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "parity",
          "PUBSUB_BACKEND": "MEMORY", "HTTP_HOST": "127.0.0.1"}


@pytest.fixture(scope="module")
def weights():
    jparams = jax_llama_init(jax.random.key(0),
                             JaxLlamaConfig.tiny().scaled(vocab_size=260))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny().scaled(vocab_size=260),
                              "cpu")
    return jparams, tparams


def _capture(engine):
    made, inner = [], engine.submit

    def submit(*args, **kwargs):
        made.append(inner(*args, **kwargs))
        return made[-1]

    engine.submit = submit
    return made


def _port_engine(tparams, **overrides):
    return llama_engine(tparams, LlamaConfig.tiny().scaled(vocab_size=260),
                        EngineConfig(**{**COMMON, **overrides}), device="cpu")


def _jax_ws_chat(engine, tok):
    """A websocket chat handler on JAX's engine: one frame per token,
    then ``{"done", "digest"}``."""
    async def ws_chat(ctx):
        body = ctx.bind()
        req = engine.submit(tok.encode(body["prompt"]), JaxSamplingParams(
            temperature=0.0, max_new_tokens=int(body["max_tokens"])))
        n = 0
        gen = engine.stream_request(req)
        try:
            async for token in gen:
                n += 1
                await ctx.write_message_to_socket(
                    {"token": token, "text": tok.decode([token])})
        finally:
            await gen.aclose()
        return {"done": n, "digest": req.digest}
    return ws_chat


def _port_ws_chat(app, engine, tok):
    """The same handler on the port's engine: the submit and the token
    iterator on the app's pool (``ThreadPump``), which closes the
    iterator, cancelling the request, once the socket is gone."""
    async def ws_chat(ctx):
        body = ctx.bind()
        loop = asyncio.get_running_loop()
        req = await loop.run_in_executor(app.executor, lambda: engine.submit(
            tok.encode(body["prompt"]), SamplingParams(
                temperature=0.0, max_new_tokens=int(body["max_tokens"]))))
        pump = ThreadPump(engine.stream_request(req, timeout_s=POLL_S),
                          ctx.client_gone, ctx.mark_gone, app.executor, loop)
        n = 0
        try:
            async for token in pump:
                if token is None:
                    continue
                n += 1
                await ctx.write_message_to_socket(
                    {"token": token, "text": tok.decode([token])})
        finally:
            await pump.aclose()
        return {"done": n, "digest": req.digest}
    return ws_chat


class _Side:
    """One package's app over its engine, started; ``log`` keeps the
    hooks' calls, ``received`` the subscriber's messages."""

    def __init__(self, app, engine, keyed):
        self.app, self.engine = app, engine
        self.log, self.received = [], []
        self.made = _capture(engine)
        if keyed:
            app.enable_api_key_auth(KEY, key_names={KEY: TENANT})
        app.on_start(lambda: self.log.append("start-1"))
        app.on_start(lambda c: self.log.append(("start-2", c is app.container)))

        async def third():
            self.log.append("start-3")
        app.on_start(third)
        app.on_shutdown(lambda: self.log.append("stop-1"))

        def on_job(ctx):
            self.received.append(ctx.bind())
        app.subscribe(TOPIC, on_job)
        self.runner = AppThread(app)

    def __enter__(self):
        self.runner.__enter__()
        self.port = self.runner.port
        return self

    def __exit__(self, *exc):
        self.runner.__exit__(*exc)
        self.engine.stop()


class _Pair:
    def __init__(self, weights, keyed):
        jeng = jax_llama_engine(
            weights[0], JaxLlamaConfig.tiny().scaled(vocab_size=260),
            JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                            compile_cache_dir=None, **COMMON),
            implementation="xla")
        japp = JaxApp(config=JaxDictConfig(CONFIG))
        japp.serve_model("llama", jeng, JaxByteTokenizer())
        jax_install_openai(japp, jeng, JaxByteTokenizer(), model=MODEL)
        japp.websocket("/ws/chat", _jax_ws_chat(jeng, JaxByteTokenizer()))
        teng = _port_engine(weights[1])
        tapp = App(config=DictConfig(CONFIG))
        tapp.serve_model("llama", teng, ByteTokenizer())
        install_openai_routes(tapp, teng, ByteTokenizer(), model=MODEL)
        tapp.websocket("/ws/chat", _port_ws_chat(tapp, teng, ByteTokenizer()))
        self.keyed = keyed
        self.jax = _Side(japp, jeng, keyed)
        self.port = _Side(tapp, teng, keyed)
        self.headers = {"X-Api-Key": KEY} if keyed else {}

    def __enter__(self):
        self.jax.__enter__()
        try:
            self.port.__enter__()
        except BaseException:
            self.jax.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        try:
            self.port.__exit__(*exc)
        finally:
            self.jax.__exit__(*exc)

    def both(self, method, path, body=None, headers=None):
        """(port answer, jax answer), each (status, headers, body)."""
        hdrs = {**self.headers, **(headers or {})}
        return (_call(self.port.port, method, path, body, hdrs),
                _call(self.jax.port, method, path, body, hdrs))


@pytest.fixture(scope="module", params=["open", "keyed"])
def pair(request, weights):
    with _Pair(weights, request.param == "keyed") as p:
        yield p


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = body if isinstance(body, (bytes, type(None))) \
            else json.dumps(body)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        headers = {k: v for k, v in resp.getheaders()
                   if k not in ("X-Trace-Id", "Content-Length")}
        raw = resp.read()
        if headers.get("Content-Type", "").startswith("text/event-stream"):
            return resp.status, headers, _norm(_events(raw))
        try:
            return resp.status, headers, _norm(json.loads(raw))
        except ValueError:
            return resp.status, headers, raw
    finally:
        conn.close()


# ------------------------------------------------------------- probes
@time_limit(60)
def test_alive_and_health_like_jax(pair):
    got, want = pair.both("GET", "/.well-known/alive")
    assert got == want and got[0] == 200
    got, want = pair.both("GET", "/.well-known/health")
    assert (got[0], got[1]) == (want[0], want[1]) == (200, got[1])
    g, w = got[2]["data"], want[2]["data"]
    assert g["status"] == w["status"] == "UP"
    assert set(g) == set(w) and set(g["details"]) == set(w["details"])
    assert set(g["checks"]) == set(w["checks"]) == {"pubsub", "tpu"}
    gt, wt = g["checks"]["tpu"], w["checks"]["tpu"]
    assert gt["status"] == wt["status"] and set(gt["details"]) == \
        set(wt["details"])
    assert gt["details"]["engines"]["llama"]["status"] == \
        wt["details"]["engines"]["llama"]["status"] == "UP"
    assert gt["details"]["devices"][0]["platform"] == "cpu"


@time_limit(60)
def test_unknown_route_and_method_like_jax(pair):
    got, want = pair.both("GET", "/no/such/route")
    assert got == want and got[0] == 404
    assert "/chat" in got[2]["error"]["registered_routes"]
    got, want = pair.both("GET", "/chat")
    assert got == want and got[0] == 405 and got[1]["Allow"] == "POST"
    got, want = pair.both("OPTIONS", "/chat")
    assert got == want and got[0] == 200


# --------------------------------------------------------- the serving
@time_limit(120)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_serving_answers_like_jax(pair, case):
    _, status, method, path, body = case
    before = (len(pair.port.made), len(pair.jax.made))
    got, want = pair.both(method, path, body)
    assert got == want
    assert got[0] == status
    port_reqs = pair.port.made[before[0]:]
    jax_reqs = pair.jax.made[before[1]:]
    assert [r.digest for r in port_reqs] == [r.digest for r in jax_reqs]
    assert all(r.digest for r in port_reqs if not r.error)
    if path == "/chat" and status == 201:
        assert got[2]["data"]["usage"]["tenant"] == (
            TENANT if pair.keyed else "anonymous")


@time_limit(60)
def test_auth_refusal_like_jax(pair):
    body = {"prompt": "x", "max_tokens": 2, "temperature": 0}
    got = _call(pair.port.port, "POST", "/chat", body)
    want = _call(pair.jax.port, "POST", "/chat", body)
    assert got == want
    assert got[0] == (401 if pair.keyed else 201)
    if pair.keyed:
        assert got[1]["WWW-Authenticate"] == "ApiKey"
        got = _call(pair.port.port, "POST", "/chat", body,
                    {"X-Api-Key": "wrong"})
        want = _call(pair.jax.port, "POST", "/chat", body,
                     {"X-Api-Key": "wrong"})
        assert got == want and got[0] == 401
    # the probes stay open
    got = _call(pair.port.port, "GET", "/.well-known/alive")
    assert got[0] == 200


@time_limit(60)
def test_route_pattern_labels_like_jax(pair):
    pair.both("GET", "/items/123/raw")

    def labels(side):
        conn = http.client.HTTPConnection(
            "127.0.0.1", side.runner.metrics_port, timeout=30)
        try:
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
        finally:
            conn.close()
        return {ln.split("{", 1)[1].split("}")[0] for ln in text.splitlines()
                if ln.startswith("app_http_response_count{")}

    got, want = labels(pair.port), labels(pair.jax)
    assert got == want
    assert any('path="<unmatched>"' in label for label in got)
    assert not any("/items/123" in label for label in got)
    assert any('path="/chat"' in label for label in got)


@time_limit(60)
def test_subscribe_over_the_in_memory_broker_like_jax(pair):
    for side in (pair.port, pair.jax):
        for job in ({"n": 1}, {"n": 2}):
            side.runner.call(side.app.container.pubsub.publish(TOPIC, job))
    deadline = time.time() + 20
    while time.time() < deadline and not (
            len(pair.port.received) >= 2 and len(pair.jax.received) >= 2):
        time.sleep(0.01)
    assert pair.port.received == pair.jax.received == [{"n": 1}, {"n": 2}]
    del pair.port.received[:], pair.jax.received[:]


def test_start_hooks_ran_like_jax(pair):
    assert pair.port.log == pair.jax.log == [
        "start-1", ("start-2", True), "start-3"]


# ------------------------------------------------------- the port alone
def _slowed(engine, seconds):
    inner = engine._decode_dispatch

    def slow():
        time.sleep(seconds)
        inner()

    engine._decode_dispatch = slow
    return inner


def _wait(cond, timeout_s):
    deadline = time.time() + timeout_s
    while time.time() < deadline and not cond():
        time.sleep(0.005)
    return cond()


@time_limit(90)
def test_a_client_leaving_mid_stream_cancels_its_request(pair):
    eng = pair.port.engine
    inner = _slowed(eng, 0.03)
    try:
        before = len(pair.port.made)
        data = json.dumps({"messages": [{"role": "user", "content": "hi"}],
                           "max_tokens": 100, "temperature": 0,
                           "stream": True}).encode()
        sock = socket.create_connection(("127.0.0.1", pair.port.port),
                                        timeout=30)
        extra = "".join(f"{k}: {v}\r\n" for k, v in pair.headers.items())
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n%sContent-Length:"
                     b" %d\r\n\r\n%s" % (extra.encode(), len(data), data))
        got = b""
        while got.count(b'"content"') < 3:
            chunk = sock.recv(4096)
            assert chunk, got
            got += chunk
        req, = pair.port.made[before:]
        sock.close()
        at_close = len(req.generated)
        # the engine frees the slot before it ends the request and gives
        # its pages back: wait for all three
        assert _wait(lambda: all(r is None for r in eng.active)
                     and req.done.is_set()
                     and sorted(eng._free_pages) == list(range(eng._n_pages)),
                     30.0)
    finally:
        eng._decode_dispatch = inner
    assert req.cancelled and req.done.is_set()
    # the pump sees the close at its next chunk, the engine retires the
    # slot at its next dispatch: a few passes at most
    passes_after = (len(req.generated) - at_close) \
        / eng.config.decode_steps_per_pass
    assert passes_after <= 6, (at_close, len(req.generated))
    assert sorted(eng._free_pages) == list(range(eng._n_pages))


@time_limit(60)
def test_plain_handlers_and_streams_stay_off_the_loop_thread(pair):
    threads = {}

    def plain(ctx):
        threads["handler"] = threading.current_thread().name

        def chunks():
            threads["stream"] = threading.current_thread().name
            yield 'data: {"n": 1}\n\n'
            yield ""
            yield 'data: {"n": 2}\n\n'
        return Stream(chunks())

    async def coroutine(ctx):
        threads["async"] = threading.current_thread().name
        return {"ok": True}

    pair.port.app.router.add("POST", "/threads", plain)
    pair.port.app.router.add("POST", "/threads/async", coroutine)
    status, _, events = _call(pair.port.port, "POST", "/threads", {},
                              pair.headers)
    assert status == 200 and events == [{"n": 1}, {"n": 2}]
    status, _, body = _call(pair.port.port, "POST", "/threads/async", {},
                            pair.headers)
    assert status == 201 and body == {"data": {"ok": True}}
    loop_thread = pair.port.runner._thread.name
    assert threads["async"] == loop_thread
    assert threads["handler"].startswith("app-handler")
    assert threads["stream"].startswith("app-handler")


async def _ws_chat(port, headers, prompt, max_tokens, close_after=None):
    """Token frames and the closing frame of one ``/ws/chat`` message
    (none with ``close_after``: the client closes after that many)."""
    conn = await ws_connect(f"ws://127.0.0.1:{port}/ws/chat",
                            headers=headers)
    await conn.send({"prompt": prompt, "max_tokens": max_tokens})
    frames = []
    try:
        while True:
            msg = json.loads((await conn.recv()).text())
            if "token" not in msg:
                return frames, msg
            frames.append(msg)
            if close_after is not None and len(frames) >= close_after:
                return frames, None
    finally:
        await conn.close()


WS_PROMPTS = ["hello over a socket", "the paged cache keeps every token",
              "x"]


@time_limit(120)
def test_websocket_chat_streams_like_jax(pair):
    """The same prompts over each app's ``/ws/chat``: the same token
    frames, a closing frame counting them, equal request digests (the
    engine's ``integrity.request_digest``)."""
    for prompt in WS_PROMPTS:
        got = asyncio.run(_ws_chat(pair.port.port, pair.headers, prompt, 12))
        want = asyncio.run(_ws_chat(pair.jax.port, pair.headers, prompt, 12))
        assert got == want
        frames, done = got
        assert done["done"] == len(frames) == 12 and done["digest"]
        assert pair.port.made[-1].digest == pair.jax.made[-1].digest \
            == done["digest"]


@time_limit(90)
def test_a_socket_closed_mid_generation_cancels_its_request(pair):
    eng = pair.port.engine
    inner = _slowed(eng, 0.03)
    try:
        before = len(pair.port.made)
        frames, _ = asyncio.run(_ws_chat(pair.port.port, pair.headers,
                                         "leave early", 100, close_after=3))
        assert len(frames) == 3
        req, = pair.port.made[before:]
        at_close = len(req.generated)
        assert _wait(lambda: all(r is None for r in eng.active), 30.0)
    finally:
        eng._decode_dispatch = inner
    assert req.cancelled and req.done.is_set()
    passes_after = (len(req.generated) - at_close) \
        / eng.config.decode_steps_per_pass
    assert passes_after <= 6, (at_close, len(req.generated))
    assert len(req.generated) < 100
    assert sorted(eng._free_pages) == list(range(eng._n_pages))
    assert _wait(lambda: len(pair.port.app.container.ws_manager) == 0, 10)


@time_limit(120)
def test_the_drain_refuses_alike_and_finishes_in_flight_work(pair):
    """Last for each pair: the drain stops both apps."""
    body = {"prompt": "drain me", "max_tokens": 100, "temperature": 0}
    answers = {}
    for name, side in (("port", pair.port), ("jax", pair.jax)):
        inner = _slowed(side.engine, 0.03)
        before = len(side.made)
        flights: list = [None, None]

        def fly(i, side=side, flights=flights):
            flights[i] = _call(side.port, "POST", "/chat", body,
                               pair.headers)

        workers = [threading.Thread(target=fly, args=(i,)) for i in (0, 1)]
        for w in workers:
            w.start()
        assert _wait(lambda: len(side.made) >= before + 2 and all(
            r.generated for r in side.made[before:before + 2]), 30)
        stopping = asyncio.run_coroutine_threadsafe(
            side.app._graceful_stop(), side.runner.loop)
        assert _wait(lambda: side.engine._draining, 20)
        refused = _call(side.port, "POST", "/chat", body, pair.headers)
        stopping.result(60)
        for w in workers:
            w.join(60)
        side.engine._decode_dispatch = inner
        answers[name] = (refused, flights, side.log[-1],
                         side.app._stop_event.is_set())
    assert answers["port"] == answers["jax"]
    refused, flights, last_hook, stopped = answers["port"]
    assert refused[0] == 503 and refused[1]["Retry-After"].isdigit()
    assert refused[2]["error"]["details"]["code"] == "draining"
    assert [f[0] for f in flights] == [201, 201]
    assert last_hook == "stop-1" and stopped


# ------------------------------------------- apps of their own, port only
@time_limit(90)
def test_request_timeout_answers_408_and_frees_the_slot(weights):
    eng = _port_engine(weights[1])
    made = _capture(eng)
    app = App(config=DictConfig({**CONFIG, "REQUEST_TIMEOUT": "0.5"}))
    app.serve_model("llama", eng, ByteTokenizer())
    inner = _slowed(eng, 0.05)
    try:
        with AppThread(app) as runner:
            status, _, body = _call(runner.port, "POST", "/chat", {
                "prompt": "slow", "max_tokens": 120, "temperature": 0})
            assert (status, body) == (408, {"error": {
                "message": "request timed out"}})
            req, = made
            assert _wait(lambda: req.done.is_set(), 20)
            assert req.cancelled and len(req.generated) < 120
            assert _wait(lambda: all(r is None for r in eng.active), 20)
            assert sorted(eng._free_pages) == list(range(eng._n_pages))
    finally:
        eng._decode_dispatch = inner
        eng.stop()


@time_limit(60)
def test_plain_websocket_handlers_run_off_the_loop_thread():
    """A plain websocket handler runs on the app's pool: while one waits,
    ``/.well-known/alive`` (on the loop) and another socket's coroutine
    handler answer."""
    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
    release, seen = threading.Event(), {}

    @app.websocket("/ws/wait")
    def wait(ctx):
        seen["plain"] = threading.current_thread().name
        release.wait(20)
        return {"released": True}

    @app.websocket("/ws/quick")
    async def quick(ctx):
        seen["async"] = threading.current_thread().name
        return {"quick": True}

    async def go(port):
        slow = await ws_connect(f"ws://127.0.0.1:{port}/ws/wait")
        await slow.send("x")
        for _ in range(500):
            if "plain" in seen:
                break
            await asyncio.sleep(0.01)
        alive = await asyncio.to_thread(_call, port, "GET",
                                        "/.well-known/alive")
        fast = await ws_connect(f"ws://127.0.0.1:{port}/ws/quick")
        await fast.send("y")
        quick_reply = json.loads((await fast.recv()).text())
        release.set()
        slow_reply = json.loads((await slow.recv()).text())
        await fast.close()
        await slow.close()
        return alive, quick_reply, slow_reply

    with AppThread(app) as runner:
        alive, quick_reply, slow_reply = asyncio.run(
            asyncio.wait_for(go(runner.port), 30))
        loop_thread = runner._thread.name
    assert alive[0] == 200 and quick_reply == {"quick": True}
    assert slow_reply == {"released": True}
    assert seen["plain"].startswith("app-handler")
    assert seen["async"] == loop_thread != seen["plain"]


HELD = 40  # requests in flight: more than any fixed pool of 32 threads


@pytest.mark.parametrize("max_waiting", [0, 8])
@time_limit(120)
def test_requests_past_32_in_flight_reach_admission_and_probes_answer(
        weights, max_waiting):
    """The engine's thread is held before its first admission, so every
    request stays in flight, each holding a handler thread. All 40 reach
    ``engine.submit``: with no queue limit all are queued; with
    ``max_waiting`` 8, 8 are queued and 32 get the scheduler's typed 503
    while the rest are still held. Meanwhile alive, health and the
    metrics scrape answer. Released, every queued request completes."""
    eng = _port_engine(weights[1], max_waiting=max_waiting)
    made = _capture(eng)
    gate, inner = threading.Event(), eng._admit

    def held():
        gate.wait()
        inner()

    eng._admit = held
    app = App(config=DictConfig(CONFIG))
    app.serve_model("llama", eng, ByteTokenizer())
    answers: list = [None] * HELD
    try:
        with AppThread(app) as runner:
            try:
                _hold_and_release(runner, made, eng, answers, max_waiting,
                                  gate)
            finally:
                gate.set()
    finally:
        gate.set()
        eng.stop()


def _hold_and_release(runner, made, eng, answers, max_waiting, gate):
    body = {"prompt": "hold", "max_tokens": 4, "temperature": 0}

    def fly(i):
        answers[i] = _call(runner.port, "POST", "/chat", body)

    workers = [threading.Thread(target=fly, args=(i,), daemon=True)
               for i in range(HELD)]
    for w in workers:
        w.start()
    assert _wait(lambda: len(made) == HELD, 30), len(made)
    queued = HELD if max_waiting == 0 else max_waiting
    assert eng.waiting.qsize() == queued
    if max_waiting:
        assert _wait(lambda: sum(a is not None for a in answers)
                     == HELD - queued, 30)
        for status, headers, refused in filter(None, answers):
            assert status == 503 and headers["Retry-After"]
            assert refused["error"]["details"]["code"] == "queue_full"
    status, _, alive = _call(runner.port, "GET", "/.well-known/alive")
    assert (status, alive) == (200, {"data": {"status": "UP"}})
    status, _, health = _call(runner.port, "GET", "/.well-known/health")
    assert status == 200 and "tpu" in health["data"]["checks"]
    conn = http.client.HTTPConnection("127.0.0.1", runner.metrics_port,
                                      timeout=10)
    try:
        conn.request("GET", "/metrics")
        scrape = conn.getresponse()
        assert scrape.status == 200 and b"app_gpu_device_count" \
            in scrape.read()
    finally:
        conn.close()
    gate.set()
    for w in workers:
        w.join(60)
    done = [a for a in answers if a is not None and a[0] == 201]
    assert len(done) == queued
    assert all(len(a[2]["data"]["tokens"]) == 4 for a in done)


def _hooks(log):
    def start():
        log.append("start")

    def down_1():
        log.append("down-1")

    async def down_2():
        log.append("down-2")
    return start, down_1, down_2


@time_limit(60)
def test_shutdown_hooks_and_plain_hooks_run_like_jax():
    logs = {}
    for name, app in (("port", App(config=DictConfig(CONFIG))),
                      ("jax", JaxApp(config=JaxDictConfig(CONFIG)))):
        log = []
        start, down_1, down_2 = _hooks(log)
        app.on_start(start)
        app.on_shutdown(down_1)
        app.on_shutdown(down_2)
        with AppThread(app):
            pass
        logs[name] = log
    assert logs["port"] == logs["jax"] == ["start", "down-1", "down-2"]


def test_build_app_needs_cuda_unless_asked_for_the_cpu():
    from gofr_tpu_torch.serving import model_serving
    if torch.cuda.is_available():
        pytest.skip("the refusal is what a machine without CUDA gives")
    with pytest.raises(RuntimeError):
        model_serving.build_app(DictConfig({**CONFIG,
                                            "MODEL_PRESET": "tiny"}))
    app = model_serving.build_app(DictConfig({**CONFIG,
                                              "MODEL_PRESET": "tiny"}),
                                  device="cpu")
    paths = app.router.registered_paths()
    assert {"/chat", "/v1/chat/completions", "/v1/completions",
            "/v1/models", "/debug/engine"} <= set(paths)
    assert app.container.get_model(model_serving.MODEL_NAME) is not None
