"""The port engine's recovery plane against the JAX engine's, on the CPU
at the tiny config (the JAX engine with ``paged_attention="interpret"``,
one 16-row bucket, so the 30- and 60-token prompts walk in chunks).

- Per-pass prefill containment at the three sites (the group prefill,
  its collect, the chunk walk): a pass that raises once fails only its
  own requests on both engines, the rest finish with the clean run's
  tokens, and the next wave's digests are the clean run's.
- The restart supervisor: ``RestartPolicy.backoff_for`` equal to JAX's;
  ``pass_raise`` within budget giving equal tokens, digests, restarts and
  recovered counts; the budget spent ending both DOWN with the same
  event order and a ``restart_budget`` incident bundle; the salvage
  rules white-box; a restart that reallocates nothing and captures
  nothing.
- Typed refusals: ``engine_down`` from a stopped or crashed engine, and
  through the port's app ``engine_down`` / ``engine_restart`` as 503
  with ``Retry-After`` on ``/chat`` and ``/v1``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving import faults as jax_faults
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import GenRequest as JaxGenRequest
from gofr_tpu.serving.engine import RestartPolicy as JaxRestartPolicy
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import (EngineConfig, GenRequest,
                                           RestartPolicy, SamplingParams)
from gofr_tpu_torch.serving.faults import FaultPlan
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.openai_compat import install_openai_routes
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(2)

COMMON = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefill_batch=4, prefill_buckets=(16,))
N_NEW = 9
#: two prompts in the bucket (one group prefill) and two that walk
PROMPTS = [[(7 * i + 3) % 256 for i in range(n)] for n in (5, 12, 30, 60)]
GROUP, WALK = (0, 1), (2, 3)


def _jax_params():
    return JaxSamplingParams(temperature=0.0, max_new_tokens=N_NEW)


def _params():
    return SamplingParams(temperature=0.0, max_new_tokens=N_NEW)


def _is_port(engine) -> bool:
    return isinstance(engine.config, EngineConfig)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    LlamaConfig.tiny(), "cpu")


@pytest.fixture(scope="module")
def jeng(weights):
    """One JAX engine, compiled by its first case and re-armed by
    ``_rearm`` for each."""
    return jax_llama_engine(
        weights[0], JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="interpret",
                        compile_cache_dir=None, **COMMON),
        implementation="xla")


def _rearm(jeng, faults: str = "", policy=None):
    jeng.faults = jax_faults.FaultPlan.parse(faults)
    if jeng.faults is not jax_faults.NO_FAULTS:
        jeng.faults.events = jeng.events
    jeng.config.restart_policy = policy
    jeng._restarts = 0
    jeng._last_crash = None
    jeng.incidents._last.clear()         # no debounce across cases
    return jeng


def _port(weights, **kw):
    return llama_engine(weights[1], LlamaConfig.tiny(),
                        EngineConfig(**{**COMMON, **kw}), device="cpu")


def _serve(engine, prompts=PROMPTS, timeout_s=120.0, stop=True):
    """Queue ``prompts`` before ``start()`` (both engines then admit one
    batch), wait until each ended, then stop."""
    params = _params() if _is_port(engine) else _jax_params()
    engine.waiting.reopen()
    reqs = [engine.submit(p, params) for p in prompts]
    engine.start()
    try:
        deadline = time.time() + timeout_s
        while time.time() < deadline and any(
                r.finished_at is None and r.error is None for r in reqs):
            time.sleep(0.005)
    finally:
        if stop:
            engine.stop()
    return reqs


@pytest.fixture(scope="module")
def clean(weights, jeng):
    """Two waves on each engine, no fault."""
    want = [_serve(_rearm(jeng)) for _ in range(2)]
    port = _port(weights)
    got = [_serve(port) for _ in range(2)]
    for a, b in zip(want, got):
        assert [r.generated for r in a] == [r.generated for r in b]
        assert all(r.error is None for r in a + b)
    return want, got


# ------------------------------------------------------ prefill containment
class _Exploding:
    """First tokens whose read fails (a collect that raises)."""

    def __array__(self, *args, **kwargs):
        raise RuntimeError("planted collect fault")

    def numpy(self):
        raise RuntimeError("planted collect fault")


def _once(fn, fault):
    """``fn`` with its first call replaced by ``fault()``."""
    state = {"left": 1}

    def wrapped(*args, **kwargs):
        if state["left"]:
            state["left"] -= 1
            return fault(fn, *args, **kwargs)
        return fn(*args, **kwargs)
    return wrapped


def _raise(fn, *args, **kwargs):
    raise RuntimeError("planted prefill fault")


def _explode_toks(fn, *args, **kwargs):
    toks, k, v = fn(*args, **kwargs)
    return _Exploding(), k, v


def _plant(engine, site: str):
    """Make one pass of ``site`` fail on ``engine``: the group prefill's
    call, its first tokens' read, or a chunk call of the walk."""
    if _is_port(engine):
        if site == "group":
            engine._prefill_fn = _once(engine._prefill_fn, _raise)
        elif site == "collect":
            engine._to_host = _once(
                engine._to_host,
                lambda fn, *a, **k: (_Exploding(), None))
        else:
            engine._chunk_fn = _once(engine._chunk_fn, _raise)
        return
    if site in ("group", "collect"):
        getter = engine._get_prefill
        fault = _raise if site == "group" else _explode_toks
        state = {"left": 1}

        def get(bucket, group):
            fn = getter(bucket, group)
            if state["left"]:
                state["left"] -= 1
                return _once(fn, fault)
            return fn
        engine._get_prefill = get
    else:
        getter = engine._get_chunk_prefill
        state = {"left": 1}

        def get_chunk(*args, **kwargs):
            fn = getter(*args, **kwargs)
            if state["left"]:
                state["left"] -= 1
                return _once(fn, _raise)
            return fn
        engine._get_chunk_prefill = get_chunk


@pytest.mark.parametrize("site", ["group", "collect", "walk"])
def test_a_failed_prefill_pass_fails_only_its_requests(weights, jeng, clean,
                                                       site):
    want_clean, _ = clean
    failing = GROUP if site in ("group", "collect") else WALK
    out = []
    for engine in (_rearm(jeng), _port(weights)):
        saved = {k: engine.__dict__.get(k) for k in
                 ("_get_prefill", "_get_chunk_prefill")}
        _plant(engine, site)
        try:
            first = _serve(engine)
            second = _serve(engine)
        finally:
            for k, v in saved.items():
                if v is None:
                    engine.__dict__.pop(k, None)
        out.append(([i for i, r in enumerate(first) if r.error is not None],
                    [r.generated for i, r in enumerate(first)
                     if i not in failing],
                    [r.digest for r in second], engine._failed))
    jax_view, port_view = out
    assert port_view == jax_view
    assert port_view[0] == list(failing)
    # the requests outside the failing pass, and the whole next wave,
    # come out as in the clean run
    assert port_view[1] == [r.generated for i, r in
                            enumerate(want_clean[0]) if i not in failing]
    assert port_view[2] == [r.digest for r in want_clean[1]]
    assert port_view[3] is None          # never crashed


def test_a_failed_prefill_pass_logs_and_keeps_the_engine_up(weights):
    lines = []

    class _Log:
        def error(self, message, **fields):
            lines.append(message)

        def warn(self, message, **fields):
            pass

    engine = _port(weights)
    engine.logger = _Log()
    _plant(engine, "group")
    reqs = [engine.submit(p, _params()) for p in PROMPTS]
    engine.start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline and any(r.finished_at is None
                                             for r in reqs):
            time.sleep(0.005)
        assert engine.health_check()["status"] == "UP"
    finally:
        engine.stop()
    assert [r.error for r in reqs[:2]] == ["planted prefill fault"] * 2
    assert any(line.startswith("prefill failed") for line in lines)
    # the failed group's pages went back: only the prefix cache holds any
    assert engine._page_refs.sum() == engine._cached_pages


# --------------------------------------------------------------- supervisor
@pytest.mark.parametrize("attempt", range(1, 9))
def test_backoff_for_equals_jax(attempt):
    for kw in ({}, {"backoff_s": 0.1, "backoff_mult": 3.0,
                    "max_backoff_s": 2.0}):
        assert RestartPolicy(**kw).backoff_for(attempt) == \
            JaxRestartPolicy(**kw).backoff_for(attempt)


def _events(engine, kinds) -> list:
    return [e["kind"] for e in engine.events.snapshot()
            if e["kind"] in kinds]


def test_pass_raise_within_budget_matches_jax(weights, jeng, clean):
    policy = dict(max_restarts=3, backoff_s=0.01)
    out = []
    for engine in (_rearm(jeng, "pass_raise:at=2", JaxRestartPolicy(**policy)),
                   _port(weights, faults="pass_raise:at=2",
                         restart_policy=RestartPolicy(**policy))):
        metrics = None
        if _is_port(engine):
            from gofr_tpu_torch.metrics import Manager
            metrics = Manager()
            engine.attach_metrics(metrics)
        before = len(engine.events.snapshot())
        reqs = _serve(engine)
        health = engine.health_check()
        kinds = [e["kind"] for e in engine.events.snapshot()[before:]
                 if e["kind"].startswith("engine.")]
        out.append(([r.generated for r in reqs], [r.digest for r in reqs],
                     [(r.reject.code if r.reject else None) for r in reqs],
                     [r.recovered for r in reqs], health.get("restarts"),
                     "injected fault: pass_raise" in health["last_crash"],
                     kinds))
        if metrics is not None:
            restarts = metrics.get("app_engine_restarts").get()
            recovered = metrics.get("app_engine_requests_recovered").get()
    jax_view, port_view = out
    assert port_view == jax_view
    codes, recovered_flags = port_view[2], port_view[3]
    assert port_view[4] == 1 and port_view[5]
    assert sum(recovered_flags) >= 1 and "engine_restart" in codes
    assert (restarts, recovered) == (1.0, float(sum(recovered_flags)))
    # a recovered request replays invisibly: the clean run's tokens
    clean_first = clean[0][0]
    for i, flag in enumerate(recovered_flags):
        if flag:
            assert port_view[0][i] == clean_first[i].generated
    assert port_view[6][:2] == ["engine.restart", "engine.recovery"]


def test_a_restart_reallocates_and_captures_nothing(weights):
    engine = _port(weights, faults="pass_raise:at=2",
                   restart_policy=RestartPolicy(backoff_s=0.01))
    engine.warmup(prompt_lens=(5, 12))
    pools = [engine.k_cache.data_ptr(), engine.v_cache.data_ptr()]
    captures = engine.stats["graph_captures"]
    reqs = _serve(engine)
    assert engine._restarts == 1
    assert [engine.k_cache.data_ptr(), engine.v_cache.data_ptr()] == pools
    assert engine.stats["graph_captures"] == captures
    assert all(r.error is None or r.reject.code == "engine_restart"
               for r in reqs)
    # no ring buffer of the decode graph is left busy, every page is back
    assert not any(engine._decode_graph._ring_busy)
    assert engine._page_refs.sum() == engine._cached_pages


def test_the_spent_budget_ends_both_down_with_a_bundle(weights, jeng):
    policy = dict(max_restarts=2, backoff_s=0.01)
    kinds = ("fault.trip", "engine.restart", "engine.recovery",
             "engine.crash", "incident.open")
    out = []
    for engine in (_rearm(jeng, "pass_raise:times=0",
                          JaxRestartPolicy(**policy)),
                   _port(weights, faults="pass_raise:times=0",
                         restart_policy=RestartPolicy(**policy))):
        before = len(engine.events.snapshot())
        spooled = len(engine.incidents.list())
        reqs = _serve(engine, prompts=PROMPTS[:1], stop=False)
        deadline = time.time() + 30
        while time.time() < deadline and \
                engine.health_check()["status"] != "DOWN":
            time.sleep(0.01)
        health = engine.health_check()
        late = engine.submit(PROMPTS[0], _params() if _is_port(engine)
                             else _jax_params())
        engine.stop()
        bundles = engine.incidents.list()[spooled:]
        bundle = engine.incidents.get(bundles[-1]["id"])
        out.append((health["status"], health["restarts"],
                    "injected fault" in health["error"],
                    [k for k in (e["kind"] for e in
                                 engine.events.snapshot()[before:])
                     if k in kinds],
                    [b["reason"] for b in bundles], sorted(bundle["state"]),
                    bundle["cause"], bundle["format"],
                    late.reject.code, late.reject.retry_after_s,
                    reqs[0].error))
    jax_view, port_view = out
    assert port_view == jax_view
    assert port_view[:3] == ("DOWN", 2, True)
    assert port_view[3] == ["fault.trip", "engine.restart", "engine.recovery",
                            "fault.trip", "engine.restart",
                            "engine.recovery", "fault.trip",
                            "incident.open", "engine.crash"]
    assert port_view[4] == ["restart_budget"]
    assert port_view[8] == "engine_down"


def _whitebox(engine, cls, params):
    fresh = cls(prompt_tokens=[1, 2, 3], params=params)
    fresh.slot = 0
    mid = cls(prompt_tokens=[4, 5, 6], params=params)
    mid.slot = 1
    mid.first_token_at = time.time()
    mid.generated.append(42)
    gone = cls(prompt_tokens=[7, 8], params=params)
    gone.slot = 2
    gone.cancelled = True
    engine.active[0], engine.active[1], engine.active[2] = fresh, mid, gone
    engine._running = True      # the supervisor runs on a live engine only
    try:
        first = engine._recover(RuntimeError("boom"))
    finally:
        engine._running = False
    view = (first, fresh in engine._requeued, fresh.recovered, fresh.slot,
            fresh.error, mid.error, mid.reject.code, mid.reject.retry_after_s,
            gone.finished_at is not None, gone.error, engine._restarts,
            engine._last_crash, all(r is None for r in engine.active))
    engine._running = True
    try:
        second = engine._recover(RuntimeError("again"))
    finally:
        engine._running = False
    return view + (second,)


def test_the_salvage_rules_match_jax(weights, jeng):
    policy = dict(max_restarts=1, backoff_s=0.01)
    want = _whitebox(_rearm(jeng, policy=JaxRestartPolicy(**policy)),
                     JaxGenRequest, _jax_params())
    jeng._requeued.clear()
    jeng._requeued_set.clear()
    got = _whitebox(_port(weights, restart_policy=RestartPolicy(**policy)),
                    GenRequest, _params())
    assert got == want
    assert got[:4] == (True, True, True, -1)
    assert got[6] == "engine_restart" and got[-1] is False


def test_no_policy_keeps_a_crash_terminal(weights):
    engine = _port(weights, faults="pass_raise")
    engine.active[0] = GenRequest(prompt_tokens=[1], params=_params())
    engine._running = True
    try:
        assert engine._recover(RuntimeError("boom")) is False
    finally:
        engine._running = False
        engine.active[0] = None


def test_a_sticky_device_error_refuses_the_restart(weights):
    engine = _port(weights, restart_policy=RestartPolicy())

    def dead():
        from gofr_tpu_torch.serving.engine import DeviceLost
        raise DeviceLost("CUDA context unusable: planted")

    engine._reset_runtime_state = dead
    engine._running = True
    try:
        assert engine._recover(RuntimeError("boom")) is False
    finally:
        engine._running = False
    assert engine._restarts == 0
    [bundle] = engine.incidents.list()
    assert bundle["reason"] == "restart_budget"
    assert "CUDA context unusable" in bundle["cause"]


# ------------------------------------------------------------ typed refusals
def test_a_stopped_or_crashed_engine_refuses_like_jax(weights, jeng):
    got_engine = _port(weights, restart_policy=RestartPolicy(backoff_s=0.5))
    got_engine.stop()
    want = _rearm(jeng, policy=JaxRestartPolicy(backoff_s=0.5))
    want.stop()
    got = got_engine.submit(PROMPTS[0], _params())
    ref = want.submit(PROMPTS[0], _jax_params())
    assert (got.error, got.reject.code, got.reject.retry_after_s) == \
        (ref.error, ref.reject.code, ref.reject.retry_after_s) == \
        ("engine not accepting requests", "engine_down", 1.0)
    crashed = _port(weights, faults="pass_raise")
    _serve(crashed, prompts=PROMPTS[:1])
    late = crashed.submit(PROMPTS[0], _params())
    assert late.reject.code == "engine_down"
    # a crashed engine starts again on its resident state
    crashed.faults = FaultPlan.parse("")
    again = _serve(crashed, prompts=PROMPTS[:1])
    assert again[0].error is None
    assert again[0].generated == _serve(_port(weights),
                                        prompts=PROMPTS[:1])[0].generated


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode(), resp.headers
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), exc.headers


@pytest.fixture
def app_engine():
    cfg = LlamaConfig.tiny().scaled(vocab_size=260)
    engine = llama_engine(
        llama_init(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
        EngineConfig(**{**COMMON, "max_batch": 8}), device="cpu")
    server = build_server(engine, port=0, name="tiny", env={})
    install_openai_routes(server, engine, ByteTokenizer(), model="tiny")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield engine, server.server_address[1]
    server.shutdown()
    server.server_close()
    engine.stop()


def test_chat_and_v1_answer_engine_down_as_typed_503(app_engine):
    engine, port = app_engine
    engine.stop()
    status, body, headers = _post(port, "/chat", {"prompt": "hi",
                                                  "max_tokens": 4})
    assert status == 503 and headers["Retry-After"] == "1"
    assert json.loads(body)["error"]["details"]["code"] == "engine_down"
    status, body, headers = _post(port, "/v1/completions",
                                  {"prompt": "hi", "max_tokens": 4})
    assert status == 503 and headers["Retry-After"] == "1"
    assert json.loads(body)["error"]["details"]["type"] == "server_error"


def test_a_mid_stream_restart_answers_typed_503(app_engine):
    engine, port = app_engine
    engine.faults = FaultPlan.parse("pass_raise:at=2")
    engine.config.restart_policy = RestartPolicy(backoff_s=0.01)
    asks = [("/chat", {"prompt": "hello there", "max_tokens": 24,
                       "temperature": 0}),
            ("/chat", {"prompt": "a streamed one", "max_tokens": 24,
                       "temperature": 0, "stream": True}),
            ("/v1/completions", {"prompt": "and the openai one",
                                 "max_tokens": 24, "temperature": 0})]
    got = [None] * len(asks)
    threads = []
    for i, (path, body) in enumerate(asks):
        threads.append(threading.Thread(
            target=lambda i=i, path=path, body=body: got.__setitem__(
                i, _post(port, path, body))))
        threads[-1].start()
        deadline = time.time() + 30
        while engine.waiting.qsize() < i + 1 and time.time() < deadline:
            time.sleep(0.005)
    engine.start()
    for t in threads:
        t.join(timeout=60)
    (s0, b0, h0), (s1, b1, h1), (s2, b2, h2) = got
    assert s0 == 503 and h0["Retry-After"] == "1"
    assert json.loads(b0)["error"]["details"]["code"] == "engine_restart"
    assert s1 == 200 and "[DONE]" not in b1
    last = json.loads(b1.strip().split("\n\n")[-1][len("data: "):])
    assert last["details"]["code"] == "engine_restart"
    assert s2 == 503 and h2["Retry-After"] == "1"
    assert engine.health_check()["status"] == "UP"
    assert engine.health_check()["restarts"] == 1
