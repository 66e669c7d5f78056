"""Workload capture and replay in the port (``observability.
WorkloadRecorder``, ``salted_token_hash``, ``serving/replay.py``) against
the JAX package's, on the CPU at the tiny config.

``salted_token_hash`` and the recorder's records, header, status and
JSONL are the JAX ones for the same requests (plain and redacted, a
bounded ring). A workload captured on the JAX engine (with
``paged_attention="interpret"``) replays on the port engine with 0
divergences, and one captured on the port replays on the JAX engine
with 0; both files hold the same header and record keys. A replay under
``logit_corrupt`` locates its divergent requests (index, first
divergent token) and counts them in ``app_replay_divergence``. The
app's ``/debug/workload`` routes arm, stop and serve the capture, and a
redacted capture is refused by the replay.
"""

import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving import observability as jax_obs
from gofr_tpu.serving import replay as jax_replay
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu_torch.metrics import Manager
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.serving import observability as port_obs
from gofr_tpu_torch.serving import replay as port_replay
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine

torch.set_num_threads(2)

COMMON = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefill_batch=4, prefill_buckets=(16,))
N_NEW = 9
PROMPTS = [[(7 * i + 3) % 256 for i in range(n)] for n in (5, 12, 30, 60)]


@pytest.mark.parametrize("tokens", [[], [0], [1, 2, 3], list(range(300))])
@pytest.mark.parametrize("salt", ["", "abc", "0f" * 8])
def test_salted_token_hash_matches_jax(tokens, salt):
    assert port_obs.salted_token_hash(tokens, salt) == \
        jax_obs.salted_token_hash(tokens, salt)
    assert port_obs.WORKLOAD_FORMAT == jax_obs.WORKLOAD_FORMAT
    assert port_obs.WORKLOAD_VERSION == jax_obs.WORKLOAD_VERSION


def _fake(i: int, **kw):
    """A finished request as both recorders read it."""
    params = SimpleNamespace(temperature=0.0, top_p=1.0, top_k=0,
                             max_new_tokens=8)
    base = dict(prompt_tokens=[1, 2, 3 + i], generated=[4, 5, 6][:1 + i],
                params=params, submitted_at=100.0 + i,
                first_token_at=100.5 + i, finished_at=101.0 + i,
                tenant="t" if i else None, cancelled=False, error=None,
                digest="d" * 32 if i != 1 else None, probe="")
    base.update(kw)
    req = SimpleNamespace(**base)
    req.ttft_ms = ((req.first_token_at - req.submitted_at) * 1000.0
                   if req.first_token_at is not None else None)
    return req


@pytest.mark.parametrize("redact", [False, True])
def test_recorder_records_and_header_match_jax(redact):
    reqs = [_fake(0), _fake(1), _fake(2, error="boom"),
            _fake(3, cancelled=True, first_token_at=None)]
    out = []
    for mod in (jax_obs, port_obs):
        rec = mod.WorkloadRecorder(3, redact=redact, engine_seed=7)
        rec._salt = "fixed"
        rec.goodput_source = lambda: {"busy_s": 1.0, "useful_s": 0.5}
        rec.cost_source = lambda: {"decode/0": {"kind": "decode", "n": 1}}
        rec.record(reqs[0])                  # not capturing: dropped
        rec.start()
        rec.started_at = 50.0
        for req in reqs:
            rec.record(req)
        rec.stop()
        out.append((rec.to_jsonl(), rec.to_jsonl(2), rec.status(),
                    rec.snapshot()))
    assert out[0] == out[1]
    header, *lines = out[1][0].splitlines()
    assert json.loads(header)["dropped"] == 1 and len(lines) == 3


@pytest.fixture(scope="module")
def weights():
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    LlamaConfig.tiny(), "cpu")


@pytest.fixture(scope="module")
def jeng(weights):
    return jax_llama_engine(
        weights[0], JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="interpret",
                        compile_cache_dir=None, workload_capture=True,
                        **COMMON),
        implementation="xla")


def _port(weights, **kw):
    return llama_engine(weights[1], LlamaConfig.tiny(),
                        EngineConfig(**{**COMMON, **kw}), device="cpu")


def _capture(engine) -> str:
    """The prompts queued before ``start()`` on a capturing engine; the
    workload file it holds then."""
    jax_side = not isinstance(engine.config, EngineConfig)
    params = (JaxSamplingParams if jax_side else SamplingParams)(
        temperature=0.0, max_new_tokens=N_NEW)
    engine.waiting.reopen()
    engine.workload.start()
    reqs = [engine.submit(p, params) for p in PROMPTS]
    engine.start()
    try:
        deadline = time.time() + 120
        while time.time() < deadline and any(r.finished_at is None
                                             for r in reqs):
            time.sleep(0.005)
    finally:
        engine.stop()
    assert all(r.error is None for r in reqs)
    return engine.workload.to_jsonl()


def _gated(engine, n: int):
    """Admit nothing until ``n`` requests are queued, so the replay's
    first admission takes them all, as the capture's did."""
    if isinstance(engine.config, EngineConfig):
        inner = engine._pop_waiting

        def pop(k, wait_s):
            if engine.waiting.qsize() < n and not engine._requeued \
                    and all(r is None for r in engine.active):
                time.sleep(0.001)
                return []
            return inner(k, 0.0)
        engine._pop_waiting = pop
    else:
        inner = engine.waiting.pop_batch

        def pop_batch(k, first_wait_s=0.0, drain_wait_s=0.0):
            if engine.waiting.qsize() < n and not engine._requeued \
                    and all(r is None for r in engine.active):
                time.sleep(0.001)
                return []
            return inner(k, first_wait_s=0.0, drain_wait_s=drain_wait_s)
        engine.waiting.pop_batch = pop_batch


def _keys(text: str):
    header, *records = (json.loads(line) for line in text.splitlines())
    return sorted(header), [sorted(r) for r in records]


@pytest.fixture(scope="module")
def captures(weights, jeng):
    port = _port(weights, workload_capture=True)
    return _capture(jeng), _capture(port)


def test_both_packages_write_the_same_file_shape(captures):
    jax_text, port_text = captures
    assert _keys(jax_text) == _keys(port_text)
    jax_records = [json.loads(line) for line in jax_text.splitlines()[1:]]
    port_records = [json.loads(line) for line in port_text.splitlines()[1:]]
    strip = ("t", "ttft_ms", "tpot_ms", "e2e_ms")
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in port_records] == \
        [{k: v for k, v in r.items() if k not in strip}
         for r in jax_records]


def test_a_jax_capture_replays_on_the_port(weights, captures):
    workload = port_replay.parse_workload(captures[0])
    engine = _port(weights, seed=workload["header"]["engine_seed"])
    _gated(engine, len(PROMPTS))
    try:
        report = port_replay.replay_workload(engine, workload, speed=50.0)
    finally:
        engine.stop()
    assert report["compared"] == len(PROMPTS)
    assert report["divergent"] == 0 and report["bit_identical"]
    assert report["digest_divergence"] == []


def test_a_port_capture_replays_on_jax(jeng, captures):
    workload = jax_replay.parse_workload(captures[1])
    jeng.workload.stop()
    _gated(jeng, len(PROMPTS))
    jeng.waiting.reopen()
    try:
        report = jax_replay.replay_workload(jeng, workload, speed=50.0)
    finally:
        jeng.stop()
        del jeng.waiting.pop_batch
    assert report["compared"] == len(PROMPTS)
    assert report["divergent"] == 0 and report["bit_identical"]


def test_a_corrupted_replay_locates_its_divergence(weights, captures):
    workload = port_replay.parse_workload(captures[1])
    engine = _port(weights, faults="logit_corrupt:at=3,times=2")
    metrics = Manager()
    engine.attach_metrics(metrics)
    _gated(engine, len(PROMPTS))
    try:
        report = port_replay.replay_workload(engine, workload, speed=50.0)
    finally:
        engine.stop()
    assert report["divergent"] >= 1 and not report["bit_identical"]
    first = report["divergences"][0]
    assert first["kind"] == "token" and 0 <= first["index"] < len(PROMPTS)
    assert first["first_divergent_token"] < N_NEW
    assert metrics.get("app_replay_divergence").get() == \
        report["divergent"]
    assert engine.faults.fired == {"logit_corrupt": 2}


def test_a_redacted_capture_is_refused(weights):
    engine = _port(weights, workload_capture=True, capture_redact=True)
    text = _capture(engine)
    header = json.loads(text.splitlines()[0])
    record = json.loads(text.splitlines()[1])
    assert header["redacted"] and "prompt_hash" in record
    assert "prompt_tokens" not in record
    with pytest.raises(ValueError, match="redacted"):
        port_replay.replay_workload(engine, port_replay.parse_workload(text))


def _call(base, method, path, body=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read().decode()


def test_debug_workload_routes_arm_stop_and_serve(weights):
    cfg = LlamaConfig.tiny().scaled(vocab_size=260)
    engine = llama_engine(llama_init(cfg, torch.Generator().manual_seed(0),
                                     "cpu"), cfg, EngineConfig(**COMMON),
                          device="cpu")
    server = build_server(engine, port=0, name="tiny", env={})
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    engine.start()
    try:
        status, body = _call(base, "POST", "/debug/workload/start", {})
        state = json.loads(body)["data"]
        assert status == 201 and state["model"] == "tiny"
        assert state["workload"]["capturing"]
        for prompt in ("one", "two"):
            assert _call(base, "POST", "/chat",
                         {"prompt": prompt, "max_tokens": 3,
                          "temperature": 0})[0] == 201
        status, body = _call(base, "POST", "/debug/workload/stop")
        assert json.loads(body)["data"]["workload"]["records"] == 2
        status, text = _call(base, "GET", "/debug/workload?n=1")
        workload = port_replay.parse_workload(text)
        assert status == 200 and len(workload["records"]) == 1
        assert workload["header"]["recorded"] == 2
        status, body = _call(base, "POST", "/debug/workload/start",
                             {"redact": True})
        assert json.loads(body)["data"]["workload"]["redact"] is True
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
