"""The port's tracer (``gofr_tpu_torch/tracing/tracer.py``) and request spans
against the JAX package's, on the CPU.

The ``traceparent`` parser, sampled-flag reader and formatter answer as
JAX's on valid and garbage headers; spans start as children of the
context span, of a remote parent, or of nothing (a garbage header starts
a fresh trace), with JAX's sampling. One ``/chat`` through the port's
app with a ``traceparent`` gives one trace: the HTTP span under the
caller's span, ``engine.request`` under it, and ``engine.queue``,
``engine.prefill``, ``engine.decode`` and ``engine.retire`` under that,
``X-Trace-Id`` on the answer, the trace id as the exemplar of the
latency histograms in OpenMetrics; the engine's span assembly gives the
JAX function's spans for the same request; the stall watchdog exports an
``engine.stall`` span as JAX's does.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from gofr_tpu.logging.logger import current_fleet_context
from gofr_tpu.serving import observability as jax_obs
from gofr_tpu.tracing import tracer as jax_tracer
from gofr_tpu_torch import tracing as port_tracer
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.serving import observability as port_obs
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import EngineConfig
from gofr_tpu_torch.serving.events import NO_EVENTS
from gofr_tpu_torch.serving.glue import llama_engine

torch.set_num_threads(2)

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT = "00f067aa0ba902b7"
HEADERS = [
    f"00-{TRACE}-{PARENT}-01", f"00-{TRACE}-{PARENT}-00",
    f"  00-{TRACE}-{PARENT}-01  ", f"00-{TRACE.upper()}-{PARENT}-03",
    f"00-{'0' * 32}-{PARENT}-01", f"00-{TRACE}-{'0' * 16}-01",
    f"00-{TRACE[:-1]}-{PARENT}-01", f"00-{TRACE}-{PARENT}",
    f"00-{TRACE}-{PARENT}-zz", f"00-{'g' * 32}-{PARENT}-01",
    "garbage", "", None, "---", f"00-{TRACE}-{PARENT}-01-extra",
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parsing_matches_jax(header):
    assert port_tracer.extract_traceparent(header) == \
        jax_tracer.extract_traceparent(header)
    if header:
        assert port_tracer._traceparent_sampled(header) == \
            jax_tracer._traceparent_sampled(header)


@pytest.mark.parametrize("sampled", [True, False])
def test_format_traceparent_matches_jax(sampled):
    assert port_tracer.format_traceparent(TRACE, PARENT, sampled) == \
        jax_tracer.format_traceparent(TRACE, PARENT, sampled)


def _tracer(mod, ratio=1.0):
    exporter = mod.InMemoryExporter()
    return mod.Tracer(exporter=exporter, ratio=ratio), exporter


def _own(attributes: dict) -> dict:
    """A span's attributes without the JAX tracer's fleet resource
    attributes (process-wide, set by the control plane; the port has
    none)."""
    fleet = current_fleet_context()
    return {k: v for k, v in attributes.items() if k not in fleet}


@pytest.mark.parametrize("header", [f"00-{TRACE}-{PARENT}-01",
                                    f"00-{TRACE}-{PARENT}-00", "garbage",
                                    None])
def test_span_parentage_and_sampling_match_jax(header):
    out = []
    for mod in (jax_tracer, port_tracer):
        tracer, exporter = _tracer(mod)
        with tracer.start_span("outer", traceparent=header) as outer:
            with tracer.start_span("inner") as inner:
                assert tracer.current_span() is inner
            assert tracer.current_span() is outer
        assert tracer.current_span() is None
        remote = header is not None and header.startswith("00-")
        out.append((outer.trace_id == TRACE, outer.parent_id,
                    inner.trace_id == outer.trace_id,
                    inner.parent_id == outer.span_id, outer.sampled,
                    [s.name for s in exporter.spans], remote))
    assert out[0] == out[1]
    if header == "garbage":
        # a garbage header starts a fresh trace
        assert out[1][:2] == (False, None) and out[1][4]


def test_ratio_zero_samples_nothing_and_the_exporter_is_bounded():
    tracer, exporter = _tracer(port_tracer, ratio=0.0)
    tracer.start_span("dropped").end()
    assert exporter.spans == []
    exporter = port_tracer.InMemoryExporter(max_spans=2)
    tracer = port_tracer.Tracer(exporter=exporter)
    for i in range(3):
        span = tracer.start_span(f"s{i}")
        span.end()
        span.end()                       # a second end exports nothing
    assert [s.name for s in exporter.spans] == ["s1", "s2"]
    assert exporter.dropped == 1


def _request(**kw):
    params = SimpleNamespace(temperature=0.0, top_p=1.0, top_k=0,
                             max_new_tokens=4)
    base = dict(trace=(TRACE, PARENT), prompt_tokens=[1, 2, 3],
                generated=[4, 5, 6], params=params, submitted_at=10.0,
                admitted_at=10.1, first_token_at=10.3, finished_at=11.0,
                slot=2, cancelled=False, error=None, tenant="acme",
                events=[("prefill", 10.1, 10.3, {"bucket": 16, "rows": 1})])
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [{}, {"error": "boom", "tenant": None},
                                {"first_token_at": None, "generated": []}])
def test_engine_span_assembly_matches_jax(kw):
    out = []
    for tmod, omod in ((jax_tracer, jax_obs), (port_tracer, port_obs)):
        tracer, exporter = _tracer(tmod)
        omod.emit_engine_spans(tracer, _request(**kw))
        ids = {s.span_id: s.name for s in exporter.spans}
        out.append([(s.name, ids.get(s.parent_id, s.parent_id), s.start_time,
                     s.end_time, s.status, _own(s.attributes))
                    for s in exporter.spans])
    assert out[0] == out[1]
    assert out[1][0][:2] == ("engine.request", PARENT)


def test_the_stall_watchdog_exports_an_engine_stall_span():
    out = []
    for tmod, omod in ((jax_tracer, jax_obs), (port_tracer, port_obs)):
        tracer, exporter = _tracer(tmod)
        engine = SimpleNamespace(
            tracer=tracer, stats={}, logger=None, metrics=None,
            events=NO_EVENTS,
            recorder=SimpleNamespace(dump=lambda *a, **k: None),
            health_check=lambda: {"status": "DEGRADED", "stalled_for_s": 3.0,
                                  "active_slots": 2, "waiting": 1})
        dog = omod.StallWatchdog(engine)
        assert dog.check_once() and not dog.check_once()
        out.append([(s.name, _own(s.attributes)) for s in exporter.spans])
    assert out[0] == out[1] == [("engine.stall", {
        "stalled_for_s": 3.0, "active_slots": 2, "waiting": 1})]


@pytest.fixture(scope="module")
def app():
    cfg = LlamaConfig.tiny().scaled(vocab_size=260)
    engine = llama_engine(
        llama_init(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
        EngineConfig(max_batch=4, max_seq=128, page_size=16, seed=0,
                     decode_steps_per_pass=4, prefill_batch=4,
                     prefill_buckets=(16,)), device="cpu")
    tracer, exporter = _tracer(port_tracer)
    server = build_server(engine, port=0, name="tiny", tracer=tracer, env={})
    threading.Thread(target=server.serve_forever, daemon=True).start()
    engine.start()
    yield server, engine, exporter
    server.shutdown()
    server.server_close()
    engine.stop()


def _chat(server, headers, prompt="a prompt that walks two chunks"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.server_address[1]}/chat",
        data=json.dumps({"prompt": prompt, "max_tokens": 6,
                         "temperature": 0}).encode(),
        headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers["X-Trace-Id"]


def _wait_for(exporter, trace_id, name):
    deadline = time.time() + 10
    while time.time() < deadline:
        spans = [s for s in exporter.spans if s.trace_id == trace_id]
        if any(s.name == name for s in spans):
            return spans
        time.sleep(0.01)
    raise AssertionError(f"no {name} span in trace {trace_id}")


def test_one_chat_is_one_trace_from_http_to_retire(app):
    server, engine, exporter = app
    status, trace_id = _chat(server,
                             {"traceparent": f"00-{TRACE}-{PARENT}-01"})
    assert status == 201 and trace_id == TRACE
    spans = _wait_for(exporter, TRACE, "POST /chat")
    by_id = {s.span_id: s for s in spans}
    http = next(s for s in spans if s.name == "POST /chat")
    assert http.parent_id == PARENT and http.attributes["http.status"] == 201
    root = next(s for s in spans if s.name == "engine.request")
    assert root.parent_id == http.span_id
    children = [s.name for s in spans if s.parent_id == root.span_id]
    assert children[0] == "engine.queue"
    assert children[-2:] == ["engine.decode", "engine.retire"]
    assert set(children[1:-2]) == {"engine.prefill"} and len(children) >= 4
    assert all(by_id[s.parent_id] is not None for s in spans
               if s.parent_id in by_id)
    text = server.metrics.render_openmetrics()
    assert f'trace_id="{TRACE}"' in text


def test_a_garbage_traceparent_starts_a_fresh_trace(app):
    server, _, exporter = app
    status, trace_id = _chat(server, {"traceparent": "00-not-a-header-01"},
                             prompt="short")
    assert status == 201 and trace_id != TRACE and len(trace_id) == 32
    spans = _wait_for(exporter, trace_id, "POST /chat")
    http = next(s for s in spans if s.name == "POST /chat")
    assert http.parent_id is None
    assert any(s.name == "engine.request" and s.parent_id == http.span_id
               for s in spans)


def test_every_answer_carries_x_trace_id(app):
    server, _, exporter = app
    url = f"http://127.0.0.1:{server.server_address[1]}"
    for path in ("/.well-known/health", "/debug/engine"):
        with urllib.request.urlopen(url + path, timeout=30) as resp:
            assert len(resp.headers["X-Trace-Id"]) == 32
    try:
        urllib.request.urlopen(url + "/nowhere", timeout=30)
    except urllib.error.HTTPError as exc:
        assert exc.code == 404 and len(exc.headers["X-Trace-Id"]) == 32
