"""The port engine's accounting and integrity planes against the JAX
engine's, on the CPU at the tiny config.

Both engines serve the same converted weights and prompts (the JAX one
with ``paged_attention="interpret"``, its Pallas kernels interpreted;
one 16-row bucket, so the longer prompts walk in chunks). One JAX
engine is compiled once and re-armed between cases (a new fault plan,
integrity plane, goodput meter and cost model); the port engines are
built per case. Compared: the digest each engine stamps, the goodput
ledger's passes by kind and pad rows, the cost table's signatures and
pass counts, the usage rollup; ``logit_corrupt`` diverging the same
digests; one golden-probe mismatch episode on each; ``pass_raise`` and
``nan_logits`` ending both DOWN with every request failed;
``pass_stall`` giving DEGRADED and one watchdog episode;
``page_exhaustion`` refusing alike; and the port app's ``/metrics``
holding every name the JAX engine registers (``app_tpu_execute_seconds``
as ``app_gpu_execute_seconds``). The port alone: the planes add no
sync, upload or capture, conserve goodput with speculation, and the
``/debug`` routes answer.
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

from gofr_tpu.metrics.registry import Manager as JaxManager
from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving import faults as jax_faults
from gofr_tpu.serving import integrity as jax_integrity
from gofr_tpu.serving.costmodel import CostModel as JaxCostModel
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.observability import GoodputMeter as JaxGoodputMeter
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.serving import events as port_events
from gofr_tpu_torch.serving.app import build_metrics_server, build_server
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine

torch.set_num_threads(2)

COMMON = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefill_batch=4, prefill_buckets=(16,),
              prefix_cache=False)
N_NEW = 9
#: two prompts within the bucket (group prefill; the golden probes) and
#: two that walk
PROMPTS = [[(7 * i + 3) % 256 for i in range(n)] for n in (5, 12, 30, 60)]


def _jax_params():
    return JaxSamplingParams(temperature=0.0, max_new_tokens=N_NEW)


def _params():
    return SamplingParams(temperature=0.0, max_new_tokens=N_NEW)


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


def _rearm(jeng, faults: str = "", golden=None, probe_passes: int = 0):
    jeng.faults = jax_faults.FaultPlan.parse(faults)
    if jeng.faults is not jax_faults.NO_FAULTS:
        jeng.faults.events = jeng.events
    jeng.integrity = jax_integrity.IntegrityPlane(
        golden=golden, probe_passes=probe_passes)
    jeng.goodput = JaxGoodputMeter()
    jeng.costs = JaxCostModel()
    jeng.stats["integrity_failures"] = 0
    return jeng


def _port(weights, **kw):
    return llama_engine(weights[1], LlamaConfig.tiny(),
                        EngineConfig(**{**COMMON, **kw}), device="cpu")


def _serve(engine, params, prompts=PROMPTS, until=None, timeout_s=120.0):
    """Queue ``prompts`` before ``start()`` (both engines then admit one
    batch; an engine stopped before takes submits again once its queue
    reopens), wait for them — and for ``until(engine)`` — then stop."""
    engine.waiting.reopen()
    reqs = [engine.submit(p, params) for p in prompts]
    engine.start()
    try:
        deadline = time.time() + timeout_s
        while time.time() < deadline and (
                any(r.finished_at is None and r.error is None for r in reqs)
                or (until is not None and not until(engine))):
            time.sleep(0.005)
    finally:
        engine.stop()
    return reqs


def _pad_rows(engine) -> list:
    """Each recorded pass's kind and pad rows: empty decode slots, the
    group's dummy rows, the chunk call's pad rows."""
    out = []
    for rec in engine.recorder.snapshot()["passes"]:
        if rec["kind"] == "decode":
            out.append(("decode", engine.config.max_batch - rec["occupancy"]))
        else:
            group = int(rec["sig"].split("/")[2])
            out.append((rec["kind"], group - rec["rows"]))
    return out


@pytest.fixture(scope="module")
def clean(weights, jeng):
    """Both engines over the prompts, no fault."""
    want = _serve(_rearm(jeng), _jax_params())
    jax_view = {"goodput": jeng.goodput.state(), "pads": _pad_rows(jeng),
                "costs": jeng.costs.state()["signatures"],
                "usage": jeng.usage_ledger.rollup(),
                "by_kind": jeng.recorder.summary()["by_kind"]}
    port = _port(weights)
    got = _serve(port, _params())
    return want, jax_view, got, port


def test_engines_stamp_the_same_digests(clean):
    want, _, got, _ = clean
    assert all(r.error is None for r in want + got)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(g.digest is not None and g.digest == w.digest
               for g, w in zip(got, want))


def test_goodput_passes_by_kind_and_pad_rows_match(clean):
    _, jax_view, _, port = clean
    state = port.goodput.state()
    assert state["passes"] == jax_view["goodput"]["passes"]
    assert set(state["by_kind"]) == set(jax_view["goodput"]["by_kind"])
    assert port.recorder.summary()["by_kind"] == jax_view["by_kind"]
    assert _pad_rows(port) == jax_view["pads"]
    assert state["conservation_error_s"] == 0.0
    total = port.goodput.useful_s + sum(port.goodput.waste_s.values())
    assert abs(total - port.goodput.busy_s) <= 1e-9 * port.goodput.busy_s
    # padding is exactly the pad rows' share of each pass's busy time
    pads = sum(pad / (port.config.max_batch if kind == "decode"
                      else int(rec["sig"].split("/")[2])) * rec["dur"]
               for (kind, pad), rec in zip(
                   _pad_rows(port), port.recorder.snapshot()["passes"]))
    assert abs(pads - port.goodput.waste_s["padding"]) <= \
        1e-6 * len(_pad_rows(port))


def test_cost_tables_hold_the_same_signatures(clean):
    _, jax_view, _, port = clean
    sigs = port.costs.state()["signatures"]
    assert sorted(sigs) == sorted(jax_view["costs"])
    assert {k: (v["kind"], v["n"]) for k, v in sigs.items()} == \
        {k: (v["kind"], v["n"]) for k, v in jax_view["costs"].items()}
    assert {"decode/0", "prefill/16/2", "chunk/16/1/None"} <= set(sigs)


def test_usage_rollups_match(clean):
    _, jax_view, _, port = clean
    strip = {"device_s", "queue_s", "e2e_s", "waste_recompute_s",
             "waste_spec_s"}
    assert {t: {k: v for k, v in tot.items() if k not in strip}
            for t, tot in port.usage_ledger.rollup()["tenants"].items()} == \
        {t: {k: v for k, v in tot.items() if k not in strip}
         for t, tot in jax_view["usage"]["tenants"].items()}


def test_logit_corrupt_diverges_the_same_digests(weights, jeng, clean):
    plan = "logit_corrupt:at=4,times=3"
    want = _serve(_rearm(jeng, plan), _jax_params())
    port = _port(weights, faults=plan)
    got = _serve(port, _params())
    assert [g.digest for g in got] == [w.digest for w in want]
    assert [g.digest for g in got] != [r.digest for r in clean[2]]
    assert port.faults.fired == jeng.faults.fired == {"logit_corrupt": 3}
    assert all(len(r.generated) == N_NEW for r in got)


def _probe_episode(engine, ledger_events) -> dict:
    warns = [e for e in ledger_events
             if e["kind"] == "obs.integrity" and e["severity"] == "warn"]
    return {"episodes": engine.integrity.episodes,
            "failures": engine.stats["integrity_failures"],
            "warn_events": len(warns),
            "mismatched": engine.integrity.probes["mismatch"]}


def test_one_golden_mismatch_episode_on_each(weights, jeng, clean,
                                             tmp_path):
    want = clean[0]
    records = [{"prompt_tokens": r.prompt_tokens,
                "params": {"temperature": 0.0, "top_p": 1.0, "top_k": 0,
                           "max_new_tokens": N_NEW},
                "digest": r.digest} for r in want[:2]]
    path = tmp_path / "golden.jsonl"
    jax_integrity.GoldenSet.seal(records).save(str(path))
    plan = "logit_corrupt:request=_integrity"

    def enough(engine):
        return engine.integrity.probes["run"] >= 4

    before = len(jeng.events.snapshot())
    _rearm(jeng, plan, jax_integrity.GoldenSet.load(str(path)), 2)
    jax_reqs = _serve(jeng, _jax_params(), until=enough)
    port = _port(weights, faults=plan, integrity_golden_path=str(path),
                 integrity_probe_passes=2)
    port_reqs = _serve(port, _params(), until=enough)
    jax_ep = _probe_episode(jeng, jeng.events.snapshot()[before:])
    port_ep = _probe_episode(port, port.events.snapshot())
    assert port_ep == jax_ep == {"episodes": 1, "failures": 1,
                                 "warn_events": 1, "mismatched": 1}
    assert port.integrity.probes["run"] >= 4
    # the probes' time left useful for the integrity_probe cause
    assert port.goodput.waste_s["integrity_probe"] > 0
    # the user requests' digests did not move
    assert [r.digest for r in port_reqs] == [r.digest for r in jax_reqs] \
        == [r.digest for r in want]


def test_page_exhaustion_refuses_alike(weights, jeng):
    port = _port(weights, faults="page_exhaustion")
    got = port.submit(PROMPTS[0], _params())
    want = _rearm(jeng, "page_exhaustion").submit(PROMPTS[0], _jax_params())
    assert (got.error, got.reject.code, got.reject.retry_after_s) == \
        (want.error, want.reject.code, want.reject.retry_after_s) == \
        ("kv page pool exhausted; retry shortly", "kv_exhausted", 1.0)
    assert port.submit(PROMPTS[0], _params()).error is None   # times=1
    port.stop()


def _watch_health(engine, seconds: float) -> list:
    seen = []
    deadline = time.time() + seconds
    while time.time() < deadline:
        seen.append(engine.health_check())
        time.sleep(0.02)
    return seen


def test_pass_stall_turns_both_degraded(weights, jeng):
    plan = "pass_stall:seconds=1.0"
    out = []
    for engine in (_rearm(jeng, plan),
                   _port(weights, faults=plan, stall_threshold_s=0.3,
                         watchdog_interval_s=0.05)):
        saved = (engine.config.stall_threshold_s,
                 engine.config.watchdog_interval_s)
        engine.config.stall_threshold_s = 0.3
        engine.config.watchdog_interval_s = 0.05
        engine.waiting.reopen()
        reqs = [engine.submit(p, _params() if engine is not jeng
                              else _jax_params()) for p in PROMPTS[:2]]
        engine.start()
        try:
            seen = _watch_health(engine, 1.3)
            while any(r.finished_at is None for r in reqs):
                time.sleep(0.01)
            after = engine.health_check()
        finally:
            engine.stop()
            (engine.config.stall_threshold_s,
             engine.config.watchdog_interval_s) = saved
        degraded = [h for h in seen if h["status"] == "DEGRADED"]
        stalls = [e for e in engine.events.snapshot()
                  if e["kind"] == "fleet.stall"]
        out.append((bool(degraded), "stalled_for_s" in degraded[0],
                    after["status"], after.get("stalls"),
                    all(r.error is None for r in reqs), len(stalls) >= 1))
    assert out[0] == out[1] == (True, True, "UP", 1, True, True)


def test_nan_logits_ends_both_down(weights, jeng):
    out = []
    for engine in (_rearm(jeng, "nan_logits"),
                   _port(weights, faults="nan_logits")):
        reqs = _serve(engine, _params() if engine is not jeng
                      else _jax_params())
        crashes = [e for e in engine.events.snapshot()
                   if e["kind"] == "engine.crash"]
        out.append((engine.health_check()["status"],
                    sorted({r.error for r in reqs}), crashes[-1]["cause"]))
    assert out[0] == out[1] == (
        "DOWN", ["engine crashed: InjectedFault: injected fault: "
                 "nan_logits"], "InjectedFault: injected fault: nan_logits")


def test_pass_raise_ends_both_down_with_every_request_failed(weights):
    out = []
    for engine in (jax_llama_engine(
            weights[0], JaxLlamaConfig.tiny(),
            JaxEngineConfig(kv_layout="paged", faults="pass_raise",
                            compile_cache_dir=None, **COMMON),
            implementation="xla"),
            _port(weights, faults="pass_raise")):
        params = (_params() if isinstance(engine.config, EngineConfig)
                  else _jax_params())
        reqs = _serve(engine, params)
        late = engine.submit(PROMPTS[0], params)
        out.append((engine.health_check()["status"],
                    sorted({r.error for r in reqs}), late.error is not None,
                    [e["kind"] for e in engine.events.snapshot()
                     if e["kind"] in ("fault.trip", "engine.crash")]))
    assert out[0] == out[1] == (
        "DOWN", ["engine crashed: InjectedFault: injected fault: "
                 "pass_raise"], True, ["fault.trip", "engine.crash"])


# ------------------------------------------------------------ the port alone
def test_the_planes_add_no_sync_upload_or_capture(weights):
    off = dict(flight_recorder_size=0, goodput=False,
               recompile_sentinel=False, cost_model=False, integrity=False,
               events=False, watchdog_interval_s=0, stall_threshold_s=0)
    runs = []
    for kw in (off, {}):
        engine = _port(weights, **kw)
        reqs = _serve(engine, _params())
        runs.append(([r.generated for r in reqs],
                     {k: engine.stats[k] for k in
                      ("sched_syncs", "h2d_transfers", "graph_captures",
                       "decode_passes", "prefill_calls")}))
    assert runs[0] == runs[1]


def test_speculative_passes_feed_the_planes(weights):
    engine = _port(weights, speculative=True, spec_adaptive=False,
                   spec_ngram=2)
    prompt = [5, 6, 7, 8] * 6
    reqs = _serve(engine, _params(), prompts=[prompt, PROMPTS[1]])
    assert all(r.error is None and r.digest for r in reqs)
    g = engine.goodput
    assert "spec_verify" in g.by_kind and engine.stats["spec_passes"] > 0
    assert abs(g.useful_s + sum(g.waste_s.values()) - g.busy_s) <= \
        1e-9 * g.busy_s
    assert any(k.startswith("spec_verify/")
               for k in engine.costs.state()["signatures"])
    assert sum(r.device_s for r in reqs) > 0


def _get(url: str) -> tuple:
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode(), resp.headers
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), exc.headers


@pytest.fixture(scope="module")
def app(weights):
    """The port's app over a warmed engine that served the prompts
    through ``POST /chat``, and its metrics port."""
    # the byte tokenizer's specials (bos = 257) need a 260-token vocab
    engine = llama_engine(
        llama_init(LlamaConfig.tiny().scaled(vocab_size=260),
                   torch.Generator().manual_seed(0), "cpu"),
        LlamaConfig.tiny().scaled(vocab_size=260), EngineConfig(**COMMON),
        device="cpu")
    engine.warmup(prompt_lens=(5, 12))
    server = build_server(engine, port=0, name="tiny")
    metrics_server = build_metrics_server(server.metrics, port=0)
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in (server, metrics_server)]
    engine.start()
    for t in threads:
        t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    for p in ("hello there", "a longer prompt that walks its chunks"):
        req = urllib.request.Request(
            base + "/chat", data=json.dumps(
                {"prompt": p, "max_tokens": 5, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 201
    yield base, f"http://127.0.0.1:{metrics_server.server_address[1]}", \
        engine
    for s in (server, metrics_server):
        s.shutdown()
        s.server_close()
    engine.stop()


def test_port_metrics_hold_every_name_the_jax_engine_registers(app, jeng):
    manager = JaxManager()
    jeng.attach_metrics(manager)
    jax_names = set(manager._metrics)
    jeng.metrics = None
    status, text, headers = _get(app[1] + "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    port_names = {line.split()[2] for line in text.splitlines()
                  if line.startswith("# HELP ")}
    want = (jax_names - {"app_tpu_execute_seconds"}) \
        | {"app_gpu_execute_seconds", "app_uptime_seconds"}
    assert want <= port_names
    assert "app_chat_e2e_seconds_count 2" in text
    assert not text.rstrip().endswith("# EOF")
    req = urllib.request.Request(
        app[1] + "/metrics",
        headers={"Accept": "application/openmetrics-text"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.read().decode().rstrip().endswith("# EOF")


@pytest.mark.parametrize("path", [
    "/debug/engine?n=2", "/debug/efficiency", "/debug/costs",
    "/debug/integrity", "/debug/usage", "/debug/usage?window=5m&tenant=x",
    "/debug/slo", "/debug/scheduler?fresh=1"])
def test_debug_routes_answer(app, path):
    status, body, _ = _get(app[0] + path)
    assert status == 200
    assert set(json.loads(body)["data"]) == {"tiny"}


@pytest.mark.parametrize("path,status", [
    ("/debug/usage?window=banana", 400), ("/debug/events?n=banana", 400),
    ("/debug/events?since=banana", 400), ("/debug/events?model=x", 404),
    ("/debug/events?n=-3", 200)])
def test_debug_routes_refuse_bad_parameters(app, path, status):
    assert _get(app[0] + path)[0] == status


def test_debug_events_parse_as_gofr_events(app):
    status, body, headers = _get(app[0] + "/debug/events?n=50")
    assert status == 200
    assert headers["Content-Type"].startswith("application/jsonl")
    header, events = port_events.parse_events(body)
    assert header["format"] == "gofr-events" and header["version"] == 1
    assert all(e["kind"] in port_events.KINDS for e in events)


def test_health_reads_degraded_as_200(app, monkeypatch):
    engine = app[2]
    monkeypatch.setattr(engine, "health_check",
                        lambda: {"status": "DEGRADED", "stalled_for_s": 1})
    status, body, _ = _get(app[0] + "/.well-known/health")
    assert status == 200 and json.loads(body)["data"]["status"] == "DEGRADED"
