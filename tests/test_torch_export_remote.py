"""The port's trace exporters (``tracing/export.py``), remote log levels
(``logging/remote.py``), usage telemetry (``telemetry.py``) and version
against the JAX package's: the exporters POST to a stdlib collector on
loopback (OTLP/HTTP JSON and Zipkin v2), and for the same spans the bytes
the port's and JAX's exporters POST are equal; the remote-level poller
and the telemetry ping answer alike on the same inputs, against a local
endpoint (telemetry's ``url`` argument: no public host is reached), and
``App.start`` runs the poller as JAX's does.
"""

import asyncio
import functools
import http.server
import json
import threading
import time

import pytest

from gofr_tpu import telemetry as jax_telemetry
from gofr_tpu import version as jax_version
from gofr_tpu.config.env import DictConfig as JaxDictConfig
from gofr_tpu.container.container import Container as JaxContainer
from gofr_tpu.logging import logger as jax_logger
from gofr_tpu.logging import remote as jax_remote
from gofr_tpu.tracing import export as jax_export
from gofr_tpu.tracing import tracer as jax_tracer
from gofr_tpu_torch import telemetry, version
from gofr_tpu_torch.config.env import DictConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.logging import logger as port_logger
from gofr_tpu_torch.logging import remote
from gofr_tpu_torch.logging.logger import DEBUG, INFO, MockLogger
from gofr_tpu_torch.tracing import Tracer
from gofr_tpu_torch.tracing import export
from gofr_tpu_torch.tracing import tracer as port_tracer

from .torch_parity import AppThread
from .torch_wire import dead_port, wait_until


def async_test(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return asyncio.run(fn(*args, **kwargs))
    return wrapper


class Collector:
    """A stdlib HTTP endpoint on a thread: keeps each POST's (path, raw
    body) and answers a GET with ``{"level": self.level}``."""

    def __init__(self, level: str = "INFO") -> None:
        collector = self
        self.posts: list = []
        self.level = level

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                size = int(self.headers.get("Content-Length", 0))
                collector.posts.append((self.path, self.rfile.read(size)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                body = json.dumps({"level": collector.level}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def collector():
    c = Collector()
    yield c
    c.close()


# ------------------------------------------------------------ trace export
@pytest.mark.parametrize("kind,path", [("OTLPHTTPExporter", "/v1/traces"),
                                       ("ZipkinExporter", "/api/v2/spans")])
def test_exporter_posts_spans(collector, kind, path):
    """A span through the tracer reaches the collector on the exporter's
    path, with the service name, the span's name, ids and times."""
    exporter = getattr(export, kind)(f"http://127.0.0.1:{collector.port}",
                                     service_name="svc",
                                     flush_interval_s=0.1)
    tracer = Tracer(service_name="svc", exporter=exporter)
    try:
        with tracer.start_span("GET /users") as span:
            span.set_attribute("http.status", 200)
        assert wait_until(lambda: collector.posts)
        got_path, raw = collector.posts[0]
        payload = json.loads(raw)
        assert got_path == path
        if kind == "OTLPHTTPExporter":
            rs = payload["resourceSpans"][0]
            assert {"key": "service.name",
                    "value": {"stringValue": "svc"}} in \
                rs["resource"]["attributes"]
            one = rs["scopeSpans"][0]["spans"][0]
            assert (one["name"], one["traceId"], one["spanId"]) == \
                ("GET /users", span.trace_id, span.span_id)
            assert int(one["endTimeUnixNano"]) >= \
                int(one["startTimeUnixNano"])
        else:
            assert payload[0]["name"] == "GET /users"
            assert payload[0]["localEndpoint"] == {"serviceName": "svc"}
            assert payload[0]["duration"] >= 1
            assert payload[0]["tags"] == {"http.status": "200"}
    finally:
        exporter.close()


def test_exporter_survives_dead_collector():
    exporter = export.OTLPHTTPExporter(f"http://127.0.0.1:{dead_port()}",
                                       flush_interval_s=0.05,
                                       timeout_s=0.2)
    tracer = Tracer(service_name="svc", exporter=exporter)
    with tracer.start_span("doomed"):
        pass
    assert wait_until(lambda: exporter.dropped >= 1)
    exporter.close()


def _spans(tracer_module, tracer) -> list:
    """The same three spans (a root, a child with attributes, an error)
    with fixed ids and times, as ``tracer_module``'s Span objects."""
    span = tracer_module.Span
    return [
        span(name="POST /chat", trace_id="ab" * 16, span_id="01" * 8,
             parent_id=None, start_time=1700000000.25, tracer=tracer,
             end_time=1700000000.75, attributes={"http.status": 200}),
        span(name="sql INSERT", trace_id="ab" * 16, span_id="02" * 8,
             parent_id="01" * 8, start_time=1700000000.5, tracer=tracer,
             end_time=1700000000.5005,
             attributes={"db": "postgres", "rows": 1}),
        span(name="job 7", trace_id="cd" * 16, span_id="03" * 8,
             parent_id=None, start_time=1700000001.0, tracer=tracer,
             status="ERROR: boom")]


@pytest.mark.parametrize("kind", ["OTLPHTTPExporter", "ZipkinExporter"])
def test_exported_bytes_equal_jax(collector, kind):
    """For the same batch of spans (ids and times fixed), the port's
    exporter and JAX's POST the same bytes to the same path (one batch
    posted by the exporters' own ``_post``, as their worker does)."""
    posted = {}
    for side, module, tracer_module in (
            ("port", export, port_tracer), ("jax", jax_export, jax_tracer)):
        before = len(collector.posts)
        exporter = getattr(module, kind)(
            f"http://127.0.0.1:{collector.port}", service_name="svc",
            flush_interval_s=0.05)
        tracer = tracer_module.Tracer(service_name="svc")
        exporter._post(_spans(tracer_module, tracer))
        exporter.close()
        posted[side] = collector.posts[before:]
        assert exporter.sent == 3
    assert posted["port"] == posted["jax"]
    assert len(posted["port"]) == 1


@pytest.mark.parametrize("env,kind,endpoint", [
    ({"TRACE_EXPORTER": "otlp", "TRACER_URL": "http://127.0.0.1:4318"},
     "OTLPHTTPExporter", "http://127.0.0.1:4318"),
    ({"TRACE_EXPORTER": "jaeger", "TRACER_HOST": "jaeger.internal"},
     "OTLPHTTPExporter", "http://jaeger.internal:4318"),
    ({"TRACE_EXPORTER": "zipkin", "TRACER_HOST": "tempo.internal"},
     "ZipkinExporter", "http://tempo.internal:9411"),
    ({"TRACE_EXPORTER": "zipkin", "TRACER_HOST": "h", "TRACER_PORT": "1"},
     "ZipkinExporter", "http://h:1")])
def test_container_wires_network_exporters(env, kind, endpoint):
    """``TRACE_EXPORTER`` / ``TRACER_URL`` / ``TRACER_HOST`` /
    ``TRACER_PORT`` give the exporter and endpoint JAX's container
    gives."""
    port = Container.create(DictConfig({"APP_NAME": "traced", **env}))
    jax = JaxContainer.create(JaxDictConfig({"APP_NAME": "traced", **env}))
    try:
        for c in (port, jax):
            assert type(c.tracer.exporter).__name__ == kind
            assert c.tracer.exporter.endpoint == endpoint
            assert c.tracer.exporter.service_name == "traced"
    finally:
        port.tracer.exporter.close()
        jax.tracer.exporter.close()


# ------------------------------------------------------- remote log level
class _FakeResponse:
    def __init__(self, payload, ok=True):
        self._payload = payload
        self.ok = ok

    def json(self):
        return self._payload


class _FakeService:
    """The port's service surface: a plain ``get`` (the poller runs it on
    a worker thread)."""

    def __init__(self, payload, ok=True):
        self.payload = payload
        self.ok = ok
        self.calls = 0

    def get(self, path):
        self.calls += 1
        return _FakeResponse(self.payload, self.ok)


@pytest.mark.parametrize("payload", [
    {"data": [{"serviceName": "x", "logLevel": {"LOG_LEVEL": "DEBUG"}}]},
    {"level": "WARN"}, {"data": {"LOG_LEVEL": "ERROR"}},
    {"data": [{"LOG_LEVEL": "NOTICE"}, {"LOG_LEVEL": "ERROR"}]},
    {"data": ["junk", {"logLevel": {"LOG_LEVEL": "FATAL"}}]},
    {"nope": 1}, {"level": 3}, "garbage", None, [1]])
def test_parse_level_response_equals_jax(payload):
    assert remote.parse_level_response(payload) == \
        jax_remote.parse_level_response(payload)


@async_test
async def test_poll_applies_level_change():
    logger = MockLogger(level=INFO)
    updater = remote.RemoteLevelUpdater(logger, _FakeService(
        {"level": "DEBUG"}))
    assert await updater.poll_once() is True
    assert logger.level == DEBUG
    assert await updater.poll_once() is False    # same level: no-op
    assert (updater.fetches, updater.applied) == (2, 1)


@pytest.mark.parametrize("service", [
    _FakeService({"level": "TRACE"}), _FakeService({"level": "DEBUG"},
                                                   ok=False)])
@async_test
async def test_poll_rejects_unknown_level_and_failed_fetch(service):
    logger = MockLogger(level=INFO)
    updater = remote.RemoteLevelUpdater(logger, service)
    assert await updater.poll_once() is False
    assert logger.level == INFO                  # not coerced


@async_test
async def test_poll_survives_fetch_failure():
    class Exploding:
        def get(self, path):
            raise ConnectionError("down")
    logger = MockLogger(level=INFO)
    updater = remote.RemoteLevelUpdater(logger, Exploding())
    assert await updater.poll_once() is False
    assert logger.level == INFO


def test_from_config_gated_on_url():
    logger = MockLogger()
    assert remote.from_config(DictConfig(), logger) is None
    for interval, want in (("3", 3.0), ("0", 1.0), ("x", 15.0)):
        updater = remote.from_config(DictConfig({
            "REMOTE_LOG_URL": "http://cfg.svc/level?app=x",
            "REMOTE_LOG_FETCH_INTERVAL": interval}), logger)
        jax = jax_remote.from_config(JaxDictConfig({
            "REMOTE_LOG_URL": "http://cfg.svc/level?app=x",
            "REMOTE_LOG_FETCH_INTERVAL": interval}),
            jax_logger.MockLogger())
        assert (updater.interval_s, updater.path,
                updater.service.base_url) == \
            (jax.interval_s, jax.path, jax.service.base_url) == \
            (want, "/level?app=x", "http://cfg.svc")


@pytest.mark.parametrize("live", [True, False], ids=["live", "dead"])
def test_poll_over_http_equals_jax(collector, live):
    """The port's poller and JAX's, built from the same config, apply
    the same level from a live endpoint, and nothing from a dead one."""
    collector.level = "DEBUG"
    port = collector.port if live else dead_port()
    url = {"REMOTE_LOG_URL": f"http://127.0.0.1:{port}/level"}
    got = {}
    for side, module, config, logger in (
            ("port", remote, DictConfig(url), MockLogger(level=INFO)),
            ("jax", jax_remote, JaxDictConfig(url),
             jax_logger.MockLogger(level=jax_logger.INFO))):
        updater = module.from_config(config, logger)
        got[side] = (asyncio.run(updater.poll_once()),
                     logger.level == (DEBUG if side == "port"
                                      else jax_logger.DEBUG))
    assert got["port"] == got["jax"] == ((True, True) if live
                                         else (False, False))


def test_app_start_runs_the_remote_level_poller(collector):
    """``REMOTE_LOG_URL`` makes ``App.start`` poll the endpoint: a switch
    to DEBUG there reaches the app's logger within two intervals."""
    from gofr_tpu_torch.app import App

    app = App(config=DictConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0",
        "REMOTE_LOG_URL": f"http://127.0.0.1:{collector.port}/level",
        "REMOTE_LOG_FETCH_INTERVAL": "1"}))
    with AppThread(app):
        assert app.logger.level == INFO
        collector.level = "DEBUG"
        t0 = time.monotonic()
        assert wait_until(lambda: app.logger.level == DEBUG, timeout=5)
        assert time.monotonic() - t0 <= 2.5
        collector.level = "INFO"
        assert wait_until(lambda: app.logger.level == INFO, timeout=5)


# ------------------------------------------------------------- telemetry
@pytest.mark.parametrize("value", [None, "", "true", "false", "0", "no",
                                   "off", "OFF ", "1", "yes"])
def test_enabled_flag_parsing(monkeypatch, value):
    """Config first, then the process env (the opt-out the tests and
    ``chip_smoke.py`` set), as JAX reads them."""
    monkeypatch.delenv("GOFR_TELEMETRY", raising=False)
    env = {} if value is None else {"GOFR_TELEMETRY": value}
    assert telemetry.enabled(DictConfig(env)) == \
        jax_telemetry.enabled(JaxDictConfig(env))
    monkeypatch.setenv("GOFR_TELEMETRY", "false")
    assert telemetry.enabled(DictConfig(env)) == \
        jax_telemetry.enabled(JaxDictConfig(env))
    assert telemetry.enabled(DictConfig({})) is False


def test_ping_posts_the_payload_jax_posts(monkeypatch, collector):
    """``ping(container, event, url=...)`` POSTs JAX's payload to a local
    endpoint and reports delivery."""
    monkeypatch.setenv("GOFR_TELEMETRY", "true")
    bodies = {}
    for side, module, container_cls, config in (
            ("port", telemetry, Container, DictConfig),
            ("jax", jax_telemetry, JaxContainer, JaxDictConfig)):
        c = container_cls(config=config({"APP_NAME": "ping-app"}))
        c.app_name, c.app_version = "ping-app", "1.2.3"
        before = len(collector.posts)
        ok = asyncio.run(module.ping(
            c, "start", url=f"http://127.0.0.1:{collector.port}/ping"))
        assert ok is True
        path, raw = collector.posts[before]
        bodies[side] = (path, json.loads(raw))
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"][1]["event"] == "start"
    assert bodies["port"][1]["app_name"] == "ping-app"
    assert bodies["port"][1]["framework_version"] == version.FRAMEWORK


def test_ping_disabled_and_unreachable_never_raise(monkeypatch):
    c = Container(config=DictConfig({"GOFR_TELEMETRY": "false"}))
    assert asyncio.run(telemetry.ping(c, "start")) is False
    monkeypatch.setenv("GOFR_TELEMETRY", "true")
    c2 = Container(config=DictConfig())
    assert asyncio.run(telemetry.ping(
        c2, "start", url=f"http://127.0.0.1:{dead_port()}/x")) is False


def test_payload_and_version_equal_jax():
    c = Container(config=DictConfig())
    j = JaxContainer(config=JaxDictConfig())
    for obj in (c, j):
        obj.app_name, obj.app_version = "a", "v"
    assert telemetry.payload(c, "shutdown") == \
        jax_telemetry.payload(j, "shutdown")
    assert version.FRAMEWORK == jax_version.FRAMEWORK
    assert telemetry.TELEMETRY_URL == jax_telemetry.TELEMETRY_URL
    assert port_logger._LEVEL_NAMES == jax_logger._LEVEL_NAMES
