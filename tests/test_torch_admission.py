"""Admission: the port's copy of the tenant/lane scheduler against the
JAX one, starvation preemption in the port's engine against the JAX
engine, and the typed refusals through both HTTP stacks, on the CPU.

One scripted multi-tenant trace (puts from four tenants in two lanes,
request and prompt-token rate limits, the capacity bound, pops across
share-debt refreshes, a readmit, the starvation check with its rate
cap, close and reopen) runs through ``gofr_tpu.serving.scheduler`` and
``gofr_tpu_torch.serving.scheduler`` on one fake clock, under both
policies: every return value, pop order, rejection (code, tenant,
``retry_after_s``), ``Retry-After`` header, counter and lane depth must
agree. Two background requests fill a two-slot engine; an interactive
one arriving behind them must preempt the newest (both engines: one
preemption, equal tokens for every request). A second rapid request
under ``RateLimit(rps=0.5)`` gets 429 and a request past
``max_waiting`` gets 503, each with ``Retry-After`` and the same
``details`` from the JAX app and the port's.
"""

import http.client
import json
import math
import threading
import time
from dataclasses import dataclass, field

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving import scheduler as jax_sched
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.handlers import make_chat_handler as jax_chat_handler
from gofr_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving import scheduler as port_sched
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine

from .apputil import AppRunner

torch.set_num_threads(2)


class _Clock:
    """``time.monotonic`` and ``time.time`` for both scheduler modules:
    the trace advances it by hand."""

    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now

    def time(self) -> float:
        return self.now


@dataclass
class _Params:
    max_new_tokens: int


@dataclass
class _Req:
    name: str
    tenant: str | None
    prompt_tokens: list
    params: _Params
    lane: str = "interactive"
    submitted_at: float = 0.0
    reject: object = None
    extra: dict = field(default_factory=dict)


#: (op, args): put (name, tenant, lane, prompt len, max new), pop (n),
#: tick (seconds), readmit (name), starving, preempted, close, reopen
TRACE = [
    ("put", ("a1", "a", "interactive", 10, 50)),
    ("put", ("a2", "a", "interactive", 10, 50)),
    ("put", ("b1", "b", "interactive", 90, 10)),
    ("put", ("b2", "b", "interactive", 90, 10)),
    ("put", ("b3", "b", "interactive", 90, 10)),     # prompt tokens: 429
    ("put", ("n1", "batch", "interactive", 5, 5)),   # a background tenant
    ("put", ("n2", None, "background", 5, 300)),
    ("put", ("c1", "c", "interactive", 3, 3)),
    ("put", ("c2", "c", "interactive", 3, 3)),
    ("put", ("c3", "c", "interactive", 3, 3)),       # requests: 429
    ("put", ("a3", "a", "interactive", 10, 50)),     # capacity: 503
    ("pop", 3),
    ("tick", 0.3),
    ("starving", None),                              # the head waited 0.3
    ("tick", 0.3),
    ("starving", None),                              # past 0.5: preempt
    ("preempted", None),
    ("starving", None),                              # rate-capped
    ("put", ("c3", "c", "interactive", 3, 3)),       # refilled
    ("pop", 2),
    ("tick", 0.6),                                   # debts reset
    ("starving", None),
    ("put", ("a3", "a", "interactive", 10, 50)),
    ("readmit", "b1"),
    ("pop", 4),
    ("put", ("d1", "d", "background", 4, 4)),
    ("pop", 16),
    ("pop", 1),
    ("put", ("a4", "a", "interactive", 10, 50)),
    ("close", None),
    ("put", ("a5", "a", "interactive", 10, 50)),     # closed: no reject
    ("pop", 16),
    ("pop", 1),                                      # closed and empty
    ("reopen", None),
    ("put", ("a5", "a", "interactive", 10, 50)),
    ("pop", 2),
]


def _run_trace(mod, policy, monkeypatch) -> list:
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    config = mod.SchedulerConfig(
        policy=policy, weights={"a": 2.0}, background_tenants=("batch",),
        rate_limits={"*": mod.RateLimit(rps=1.0),
                     "b": mod.RateLimit(prompt_tps=100.0, prompt_burst=200)},
        starvation_s=0.5, preempt_min_interval_s=1.0)
    sched = mod.Scheduler(config, capacity=7)
    reqs, log = {}, []
    for op, arg in TRACE:
        if op == "put":
            name, tenant, lane, n_prompt, n_new = arg
            req = _Req(name, tenant, list(range(n_prompt)), _Params(n_new),
                       lane=lane, submitted_at=clock.now)
            reqs[name] = req
            ok = sched.put(req)
            rej = req.reject
            log.append((op, name, ok, req.lane, None if rej is None else (
                rej.code, rej.tenant, rej.retry_after_s, rej.message,
                mod.retry_after_header(rej))))
        elif op == "pop":
            got = sched.pop_batch(arg, first_wait_s=0.0)
            log.append((op, None if got is None else [r.name for r in got]))
        elif op == "tick":
            clock.now += arg
        elif op == "readmit":
            sched.readmit(reqs[arg])
            log.append((op, arg))
        elif op == "starving":
            log.append((op, sched.starving_interactive()))
        elif op == "preempted":
            sched.note_preempted()
        else:
            getattr(sched, op)()
        log.append(("qsize", sched.qsize()))
    state = sched.state(fresh=True)
    log.append(("counters", state["counters"], state["lanes"],
                {t: v["queued"] for t, v in state["tenants"].items()}))
    return log


@pytest.mark.parametrize("policy", ["fair", "fifo"])
def test_the_scheduler_copy_replays_the_jax_trace(policy, monkeypatch):
    want = _run_trace(jax_sched, policy, monkeypatch)
    got = _run_trace(port_sched, policy, monkeypatch)
    assert got == want
    rejects = {entry[4][0] for entry in got
               if entry[0] == "put" and entry[4] is not None}
    assert rejects == {"rate_limited", "queue_full"}
    # only the fair policy preempts for a starving lane
    assert (("starving", True) in got) == (policy == "fair")


@pytest.fixture(scope="module")
def weights():
    config = JaxLlamaConfig.tiny().scaled(vocab_size=260)
    jparams = jax_llama_init(jax.random.key(0), config)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny().scaled(vocab_size=260),
                              "cpu")
    return jparams, tparams


COMMON = dict(max_batch=2, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefix_cache=False)


def _fold_once(jeng):
    """The JAX engine's ``_preempt`` folding each generated token into
    the prompt once (see ``tests/test_torch_scheduling.py``)."""
    inner, folded = jeng._preempt, {}

    def preempt(slot):
        req = jeng.active[slot]
        if req is None:
            return inner(slot)
        emitted = req.generated
        req.generated = emitted[folded.get(id(req), 0):]
        try:
            inner(slot)
        finally:
            req.generated = emitted
        folded[id(req)] = len(emitted)

    jeng._preempt = preempt
    return jeng


def _starve(engine, params_cls):
    """Two background requests take both slots; once both decode, an
    interactive one arrives. Returns the three requests, finished."""
    rng = np.random.default_rng(5)
    background = [engine.submit(rng.integers(0, 256, n).tolist(),
                                params_cls(temperature=0.0,
                                           max_new_tokens=60),
                                lane="background") for n in (10, 12)]
    engine.start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                len(r.generated) >= 1 for r in background):
            time.sleep(0.001)
        interactive = engine.submit(rng.integers(0, 256, 8).tolist(),
                                    params_cls(temperature=0.0,
                                               max_new_tokens=8))
        reqs = background + [interactive]
        while time.time() < deadline and any(
                r.finished_at is None and r.error is None for r in reqs):
            time.sleep(0.005)
    finally:
        engine.stop()
    assert all(r.error is None and r.finished_at is not None for r in reqs)
    return reqs


def test_a_starving_interactive_request_preempts_like_the_jax_engine(
        weights):
    jax_cfg = jax_sched.SchedulerConfig(starvation_s=1e-3,
                                        preempt_min_interval_s=0.0)
    port_cfg = port_sched.SchedulerConfig(starvation_s=1e-3,
                                          preempt_min_interval_s=0.0)
    jeng = _fold_once(jax_llama_engine(
        weights[0], JaxLlamaConfig.tiny().scaled(vocab_size=260),
        JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                        compile_cache_dir=None, scheduler=jax_cfg, **COMMON),
        implementation="xla"))
    teng = llama_engine(weights[1], LlamaConfig.tiny().scaled(vocab_size=260),
                        EngineConfig(scheduler=port_cfg, **COMMON),
                        device="cpu")
    want = _starve(jeng, JaxSamplingParams)
    got = _starve(teng, SamplingParams)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [len(r.generated) for r in got] == [60, 60, 8]
    for eng in (teng, jeng):
        assert eng.stats["preemptions"] == 1
        assert eng.waiting.counters["preemptions"] == 1
        assert eng.waiting.counters["readmitted"] == 1
    # the newer background request was the victim and was recomputed
    victim = got[1]
    assert victim.folded > 0 and got[0].folded == 0
    # the interactive one got its slot before the victim came back
    assert got[2].finished_at < victim.finished_at


def _post(port, body, path="/chat"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers(weights):
    """The JAX app and the port's server over engines on the same
    weights (``max_waiting=1``), each engine warmed by one request and
    stopped until a test starts it: (engine, port, scheduler module,
    sampling params class) per side."""
    jeng = jax_llama_engine(
        weights[0], JaxLlamaConfig.tiny().scaled(vocab_size=260),
        JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                        compile_cache_dir=None, max_waiting=1, **COMMON),
        implementation="xla")
    teng = llama_engine(weights[1], LlamaConfig.tiny().scaled(vocab_size=260),
                        EngineConfig(max_waiting=1, **COMMON), device="cpu")
    server = build_server(teng, port=0, tenant_of=lambda headers: "anonymous")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    runner = AppRunner(build=lambda app: app.post(
        "/chat", jax_chat_handler(jeng, JaxByteTokenizer())))
    with runner as app:
        sides = [(jeng, app.port, jax_sched, JaxSamplingParams),
                 (teng, server.server_address[1], port_sched,
                  SamplingParams)]
        for eng, port, _, _ in sides:
            eng.start()
            try:       # the JAX engine compiles here, not inside a test
                assert _post(port, {"prompt": "hi", "max_tokens": 2,
                                    "temperature": 0})[0] == 201
            finally:
                eng.stop()
        yield sides
    server.shutdown()
    server.server_close()
    for eng in (jeng, teng):
        eng.stop()


def test_a_second_rapid_request_is_rate_limited_with_retry_after(servers):
    answers = []
    for eng, port, sched, _ in servers:
        eng.waiting.reconfigure(sched.SchedulerConfig(
            rate_limits={"*": sched.RateLimit(rps=0.5)}))
        eng.start()
        try:
            body = {"prompt": "hi", "max_tokens": 2, "temperature": 0}
            first = _post(port, body)
            second = _post(port, body)
        finally:
            eng.stop()
            eng.waiting.reconfigure(sched.SchedulerConfig())
        assert first[0] == 201
        answers.append(second)
    (jstatus, jheaders, jbody), (status, headers, body) = answers
    assert status == jstatus == 429
    # whole seconds, rounded up: the bucket refills 0.5 a second
    for h, b in ((headers, body), (jheaders, jbody)):
        assert h["Retry-After"] == str(max(1, math.ceil(
            b["error"]["details"]["retry_after_s"])))
    assert body["error"]["message"] == jbody["error"]["message"] == \
        "rate limit exceeded for tenant 'anonymous'"
    for key in ("code", "tenant"):
        assert body["error"]["details"][key] == jbody["error"]["details"][key]
    assert body["error"]["details"]["code"] == "rate_limited"
    assert abs(body["error"]["details"]["retry_after_s"]
               - jbody["error"]["details"]["retry_after_s"]) < 0.5


def test_a_request_past_max_waiting_is_refused_with_retry_after(servers):
    answers = []
    for eng, port, _, params_cls in servers:
        # two long requests hold both slots (each dispatch slowed, so
        # they outlast the test's requests), one request waits, and the
        # next finds the queue full
        inner = eng._decode_dispatch

        def slow(inner=inner):
            time.sleep(0.1)
            inner()

        eng._decode_dispatch = slow
        eng.start()
        held = {}
        first = threading.Thread(target=lambda: held.update(
            a=_post(port, {"prompt": "hi", "max_tokens": 2,
                           "temperature": 0})))
        try:
            blockers, deadline = [], time.time() + 30
            for _ in range(2):      # one at a time: the queue holds one
                blockers.append(eng.submit([1, 2, 3], params_cls(
                    temperature=0.0, max_new_tokens=120)))
                while time.time() < deadline and not blockers[-1].generated:
                    time.sleep(0.005)
            assert all(b.error is None for b in blockers)
            first.start()
            while eng.waiting.qsize() < 1 and time.time() < deadline:
                time.sleep(0.005)
            answers.append(_post(port, {"prompt": "hey", "max_tokens": 2}))
            assert all(b.finished_at is None for b in blockers)
            for b in blockers:
                eng.cancel(b)
            first.join(timeout=60)
        finally:
            eng.stop()
            eng._decode_dispatch = inner
        assert held["a"][0] == 201
    (jstatus, jheaders, jbody), (status, headers, body) = answers
    assert status == jstatus == 503
    assert headers["Retry-After"] == jheaders["Retry-After"] == "1"
    assert body == jbody == {"error": {
        "message": "engine overloaded: waiting queue full",
        "details": {"code": "queue_full", "tenant": "anonymous",
                    "retry_after_s": 1.0}}}
