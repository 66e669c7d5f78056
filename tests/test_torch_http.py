"""The port's HTTP layer, config, logger and container against the JAX
package's, module for module, on the same inputs (no engine, no card).

Compared exactly unless said otherwise: router matches, path params,
405 method lists, static mounts (status, bytes, content type); ``bind``
results and ``BindError`` messages on the same bytes; the responder's
status, headers, content type and body bytes; ``read_request`` on the
same raw requests (chunked, oversize, malformed: the parsed request or
the ``HTTPProtocolError`` status and message); the middleware onion's
order and its CORS headers; logger lines, equal apart from ``time``
(and, under the tracer middleware, the random span id and the
measured ``response_time`` / ``ip``); ``EnvConfig`` overlay precedence;
``Container.create``'s metric families (the JAX ``app_tpu_*`` are the
port's ``app_gpu_*``) and the shape of ``health()``.
"""

import asyncio
import importlib
import io
import json
import os
import time

import pytest

from gofr_tpu.config.env import DictConfig as JaxDictConfig
from gofr_tpu.config.env import EnvConfig as JaxEnvConfig
from gofr_tpu.container.container import Container as JaxContainer
from gofr_tpu.http import errors as jerr
from gofr_tpu.http import middleware as jmw
from gofr_tpu.http import request as jreq
from gofr_tpu.http import response as jresp
from gofr_tpu.http import responder as jresponder
from gofr_tpu.http import router as jrouter
from gofr_tpu.http import server as jserver
from gofr_tpu.logging import logger as jlog
from gofr_tpu.tracing.tracer import Tracer as JaxTracer
from gofr_tpu_torch.config.env import DictConfig, EnvConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.http import errors as terr
from gofr_tpu_torch.http import middleware as tmw
from gofr_tpu_torch.http import request as treq
from gofr_tpu_torch.http import response as tresp
from gofr_tpu_torch.http import responder as tresponder
from gofr_tpu_torch.http import router as trouter
from gofr_tpu_torch.http import server as tserver
from gofr_tpu_torch.logging import logger as tlog
from gofr_tpu_torch.tracing import Tracer

from .torch_parity import time_limit
from .torch_wire import LoopThread, dead_port, side_module

SIDES = {"jax": dict(router=jrouter, req=jreq, resp=jresp, err=jerr,
                     responder=jresponder, server=jserver, mw=jmw, log=jlog),
         "port": dict(router=trouter, req=treq, resp=tresp, err=terr,
                      responder=tresponder, server=tserver, mw=tmw,
                      log=tlog)}


# ---------------------------------------------------------------- router
ROUTES = [("GET", "/users"), ("POST", "/users"), ("GET", "/users/{id}"),
          ("DELETE", "/users/{id}"), ("GET", "/users/{id}/posts/{post}"),
          ("PUT", "/a/b/c"), ("GET", "/")]
LOOKUPS = [("GET", "/users"), ("POST", "/users/"), ("GET", "/users/42"),
           ("HEAD", "/users/42"), ("PATCH", "/users/42"),
           ("GET", "/users/7/posts/x"), ("GET", "/users/7/posts"),
           ("PUT", "/a/b/c"), ("GET", "/a/b"), ("GET", "/"),
           ("GET", "//users//9/"), ("OPTIONS", "/nothing")]


def _router(side, static_dir):
    r = SIDES[side]["router"].Router()
    for method, pattern in ROUTES:
        r.add(method, pattern, lambda ctx: None)
    r.add_static("/static", str(static_dir))
    return r


@pytest.fixture
def static_dir(tmp_path):
    (tmp_path / "index.html").write_text("<h1>home</h1>")
    (tmp_path / "app.js").write_text("var x = 1;")
    (tmp_path / ".env").write_text("SECRET=1")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "index.html").write_text("sub")
    (tmp_path / ".git").mkdir()
    (tmp_path / ".git" / "config").write_text("[core]")
    (tmp_path / "404.html").write_text("custom missing")
    return tmp_path


@pytest.mark.parametrize("method,path", LOOKUPS)
def test_router_matches_like_jax(static_dir, method, path):
    got, want = (_router(s, static_dir) for s in ("port", "jax"))
    g, w = got.match(method, path), want.match(method, path)
    assert (g is None) == (w is None)
    if g is not None:
        assert (g[0].method, g[0].pattern, g[1]) == \
            (w[0].method, w[0].pattern, w[1])
    assert got.registered_methods_for(path) == \
        want.registered_methods_for(path)
    assert got.registered_paths() == want.registered_paths()


@pytest.mark.parametrize("path", [
    "/static", "/static/", "/static/app.js", "/static/sub",
    "/static/.env", "/static/.git/config", "/static/missing.txt",
    "/static/../etc/passwd", "/staticx/app.js"])
def test_static_mounts_serve_like_jax(static_dir, path):
    got, want = (_router(s, static_dir).match_static(path)
                 for s in ("port", "jax"))
    assert got == want


# ------------------------------------------------------------------ bind
BIND_CASES = [
    ("application/json", b'{"a": 1, "b": "x"}', None),
    ("application/json", b"", None),
    ("application/json", b"{not json", None),
    ("", b"[1, 2, 3]", None),
    ("application/x-www-form-urlencoded", b"a=1&b=2&b=3&c=", None),
    ("text/plain; charset=utf-8", "héllo".encode(), None),
    ("application/octet-stream", b"\x00\x01", None),
    ("multipart/form-data; boundary=XX",
     b'--XX\r\nContent-Disposition: form-data; name="f"\r\n\r\nval\r\n'
     b'--XX\r\nContent-Disposition: form-data; name="up"; '
     b'filename="a.txt"\r\nContent-Type: text/plain\r\n\r\nbody\r\n--XX--',
     None),
    ("multipart/form-data", b"--XX\r\n", None),
    ("application/json", b'{"name": "n", "count": "3", "ratio": "0.5", '
     b'"on": "yes", "tags": [1, 2]}', "Item"),
    ("application/json", b'{"count": 3}', "Item"),
    ("application/json", b'{"name": "n", "count": "three"}', "Item"),
    ("application/json", b'[1]', "Item"),
    ("application/json", b'"12"', "int"),
]


def _item_cls(side):
    import dataclasses

    @dataclasses.dataclass
    class Item:
        name: str
        count: int = 0
        ratio: float = 0.0
        on: bool = False
        tags: list[str] | None = None
    return Item


def _bind(side, ctype, body, target):
    mod = SIDES[side]["req"]
    request = mod.HTTPRequest("POST", "/x?q=1&q=2,3", {"Content-Type": ctype},
                              body)
    tgt = {"Item": _item_cls(side), "int": int, None: None}[target]
    try:
        out = request.bind(tgt)
    except mod.BindError as exc:
        return ("BindError", str(exc))
    if hasattr(out, "__dataclass_fields__"):
        return ("dataclass", vars(out))
    return ("ok", out)


@pytest.mark.parametrize("ctype,body,target", BIND_CASES)
def test_bind_and_bind_error_like_jax(ctype, body, target):
    assert _bind("port", ctype, body, target) == \
        _bind("jax", ctype, body, target)


def test_request_accessors_like_jax():
    out = {}
    for side in ("port", "jax"):
        r = SIDES[side]["req"].HTTPRequest(
            "get", "/p%20ath?q=1,2&q=3&e=&x", {"X-Thing": "v", "Host": "h"})
        out[side] = (r.method, r.path, r.param("q"), r.params("q"),
                     r.param("e"), r.param("missing"), r.header("x-thing"),
                     r.host_name(), r.content_type)
    assert out["port"] == out["jax"]


# ------------------------------------------------------------- responder
def _results(side):
    resp, err = SIDES[side]["resp"], SIDES[side]["err"]

    class Custom(Exception):
        status_code = 418

    return [
        ({"k": [1, 2]}, None), ([1, "a"], None), (None, None),
        (resp.Raw({"raw": True}), None),
        (resp.File(b"\x89PNG", "image/png"), None),
        (resp.Redirect("/elsewhere"), None),
        (resp.Response({"v": 1}, metadata={"page": 2},
                       headers={"X-A": "1"}), None),
        (resp.XML({"a": [1, {"b<": "c&d"}]}), None),
        (resp.Partial({"some": 1}, err.ErrorEntityNotFound("id", "7")),
         None),
        (None, err.ErrorInvalidParam("x", "y")),
        (None, err.ErrorMissingParam("z")),
        (None, err.ErrorEntityNotFound()),
        (None, err.ErrorEntityAlreadyExists()),
        (None, err.ErrorRequestTimeout()),
        (None, err.ErrorServiceUnavailable(
            "busy", details={"code": "queue_full"},
            headers={"Retry-After": "2"})),
        (None, err.ErrorTooManyRequests()),
        (None, err.HTTPError("teapot", status_code=418)),
        (None, Custom("custom")),
        (None, ValueError("")),
    ]


@pytest.mark.parametrize("method", ["GET", "POST", "DELETE", "HEAD"])
def test_responder_renders_like_jax(method):
    rendered = {}
    for side in ("port", "jax"):
        responder = SIDES[side]["responder"].Responder()
        rendered[side] = [
            (r.status, r.headers, r.body, r.content_type)
            for r in (responder.respond(res, e, method)
                      for res, e in _results(side))]
    assert rendered["port"] == rendered["jax"]


def test_status_and_level_like_jax():
    for (_, e_port), (_, e_jax) in zip(_results("port"), _results("jax")):
        if e_port is not None:
            assert terr.status_and_level_for(e_port) == \
                jerr.status_and_level_for(e_jax)


def test_serving_responses_are_the_one_hierarchy():
    from gofr_tpu_torch.serving import responses
    assert responses.HTTPError is terr.HTTPError
    assert responses.Raw is tresp.Raw and responses.Stream is tresp.Stream
    assert issubclass(responses.ClientGone, terr.ErrorClientClosedRequest)
    err = responses.ErrorServiceUnavailable("x", headers={"A": "1"})
    rendered = tresponder.Responder().respond(None, err, "POST")
    assert (rendered.status, rendered.headers, json.loads(rendered.body)) \
        == (503, {"A": "1"}, {"error": {"message": "x"}})
    reply = tresponder.Responder().respond(
        responses.Reply(202, b"raw", "text/plain", {"B": "2"}), None, "POST")
    assert (reply.status, reply.body, reply.content_type, reply.headers) \
        == (202, b"raw", "text/plain", {"B": "2"})


# --------------------------------------------------------- read_request
RAW = [
    b"GET /a?b=1 HTTP/1.1\r\nHost: x\r\nX-Y:  z \r\n\r\n",
    b"POST /p HTTP/1.1\r\nContent-Length: 5\r\n\r\nhello",
    b"POST /c HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
    b"5\r\nhello\r\n6;ext=1\r\n world\r\n0\r\n\r\n",
    b"POST /c HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n",
    b"POST /p HTTP/1.1\r\nContent-Length: nope\r\n\r\n",
    b"POST /p HTTP/1.1\r\nContent-Length: %d\r\n\r\n"
    % (64 * 1024 * 1024 + 1),
    b"GET / HTTP/1.1\r\nX: " + b"a" * (70 * 1024) + b"\r\n\r\n",
    b"BROKEN\r\n\r\n",
    b"GET / HTTP/2\r\n\r\n",
    b"GET / HTTP/1.1\r\nno-colon-here\r\n\r\n",
    b"GET / HTTP/1.1\r\nHost: x",
    b"",
]


def _read(side, raw):
    srv = SIDES[side]["server"]

    async def go():
        reader = asyncio.StreamReader(limit=srv.MAX_HEADER_BYTES)
        reader.feed_data(raw)
        reader.feed_eof()
        try:
            req = await srv.read_request(reader, "1.2.3.4:5")
        except srv.HTTPProtocolError as exc:
            return ("error", exc.status, str(exc))
        except asyncio.IncompleteReadError as exc:
            return ("incomplete", len(exc.partial))
        if req is None:
            return None
        return (req.method, req.path, req.query, req.headers, req.body,
                req.client_addr)
    return asyncio.run(go())


@pytest.mark.parametrize("raw", RAW, ids=range(len(RAW)))
def test_read_request_like_jax(raw):
    assert _read("port", raw) == _read("jax", raw)


def test_chain_order_like_jax():
    seen = {}
    for side in ("port", "jax"):
        calls = []

        def mark(name, calls=calls):
            def mw(nxt):
                async def wrapped(req):
                    calls.append(name)
                    return await nxt(req)
                return wrapped
            return mw

        async def core(req, calls=calls):
            calls.append("core")
            return SIDES[side]["responder"].ResponseData()

        handler = SIDES[side]["server"].chain(
            [mark("a"), mark("b"), mark("c")], core)
        asyncio.run(handler(None))
        seen[side] = calls
    assert seen["port"] == seen["jax"] == ["a", "b", "c", "core"]


# ------------------------------------------- middleware, CORS, logging
CORS = {"ACCESS_CONTROL_ALLOW_ORIGIN": "https://a.example",
        "ACCESS_CONTROL_MAX_AGE": "600",
        "ACCESS_CONTROL_EXPOSE_HEADERS": "X-Trace-Id"}
TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


def _run_chain(side, method, path, status=200):
    mod = SIDES[side]
    out, err = io.StringIO(), io.StringIO()
    logger = mod["log"].Logger(out=out, err=err, pretty=False)
    if side == "jax":
        from gofr_tpu.metrics.registry import Manager as JaxManager
        metrics, config, tracer = JaxManager(), JaxDictConfig(CORS), \
            JaxTracer()
    else:
        from gofr_tpu_torch.metrics import Manager
        metrics, config, tracer = Manager(), DictConfig(CORS), Tracer()
    metrics.new_histogram("app_http_response", "http response time")

    async def core(req):
        req.matched_pattern = "/items/{id}" if path.startswith("/items") \
            else None
        logger.info("inside the handler", where="core")
        return mod["responder"].ResponseData(status=status, body=b"{}")

    handler = mod["server"].chain([
        mod["mw"].tracer_middleware(tracer),
        mod["mw"].logging_middleware(logger),
        mod["mw"].cors_middleware(config),
        mod["mw"].metrics_middleware(metrics)], core)
    request = mod["req"].HTTPRequest(
        method, path, {"traceparent": TRACEPARENT}, client_addr="9.9.9.9:1")
    response = asyncio.run(handler(request))
    headers = dict(response.headers)
    trace_id = headers.pop("X-Trace-Id")
    lines = [json.loads(ln) for ln in
             (out.getvalue() + err.getvalue()).splitlines()]
    for line in lines:
        line.pop("time")
        line.pop("span_id", None)
        if isinstance(line["message"], dict):
            for k in ("response_time", "ip"):
                line["message"].pop(k, None)
    labels = sorted(
        ln.split("{", 1)[1] for ln in metrics.render_prometheus().splitlines()
        if ln.startswith("app_http_response_count{"))
    return response.status, headers, trace_id, lines, labels


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/items/7", 200), ("OPTIONS", "/items/7", 200),
    ("POST", "/nowhere", 404), ("GET", "/items/9", 503),
    ("GET", "/.well-known/alive", 200)])
def test_middleware_onion_cors_and_log_lines_like_jax(method, path, status):
    got, want = (_run_chain(s, method, path, status) for s in ("port", "jax"))
    assert got == want
    # the trace id of every line is the inbound traceparent's
    assert got[2] == TRACEPARENT.split("-")[1]
    assert all(line.get("trace_id") == got[2] for line in got[3])


def _log_lines(side, calls):
    mod = SIDES[side]["log"]
    out, err = io.StringIO(), io.StringIO()
    logger = mod.Logger(level=mod.INFO, out=out, err=err, pretty=False)
    mod.set_fleet_context(host_id="h0", rank=1)
    try:
        for level, args, fields in calls:
            getattr(logger, level)(*args, **fields)
        ctx = mod.ContextLogger(logger)
        ctx.warn("from the context logger", n=1)
        logger.change_level(mod.ERROR)
        ctx.warn("muted")
        logger.error({"a": 1})
    finally:
        mod.clear_fleet_context()
    lines = []
    for sink, text in (("out", out.getvalue()), ("err", err.getvalue())):
        for ln in text.splitlines():
            rec = json.loads(ln)
            rec.pop("time")
            lines.append((sink, rec))
    return lines, mod.level_from_string("warn"), \
        mod.level_from_string("bogus")


def test_logger_lines_like_jax():
    calls = [("info", ("hello",), {"k": "v"}),
             ("debug", ("hidden",), {}),
             ("notice", ("x=%s y=%d", "a", 2), {}),
             ("info", ("bad %d", "format"), {}),
             ("warn", ("a", "b", 3), {}),
             ("error", ({"nested": [1, 2]},), {"code": 7}),
             ("log", (object,), {})]
    assert _log_lines("port", calls) == _log_lines("jax", calls)


def test_logger_defaults_to_stderr_and_one_sink():
    """The port's documented deviation: with no sinks every line goes to
    the process's stderr, read at write time; ``out`` alone takes the
    errors too."""
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        tlog.Logger(pretty=False).error("to stderr")
    assert json.loads(buf.getvalue())["message"] == "to stderr"
    out = io.StringIO()
    logger = tlog.Logger(out=out, pretty=False)
    logger.info("a")
    logger.error("b")
    assert [json.loads(x)["message"] for x in out.getvalue().splitlines()] \
        == ["a", "b"]
    from gofr_tpu_torch.serving import logger as serving_logger
    assert serving_logger.Logger is tlog.Logger
    assert serving_logger.set_fleet_context is tlog.set_fleet_context


# ---------------------------------------------------------------- config
def test_env_config_overlay_like_jax(tmp_path):
    (tmp_path / ".env").write_text(
        "# base\nA=base\nB='quoted # kept'\nexport C=exported\n"
        "D=trail # comment\nAPP_ENV=stage\nE=1\nbroken line\n=nokey\n")
    (tmp_path / ".stage.env").write_text("A=stage\nF=\"two words\"\n")
    (tmp_path / ".prod.env").write_text("A=prod\n")
    keys = ["A", "B", "C", "D", "E", "F", "G", "APP_ENV"]
    for environ in ({}, {"A": "os", "APP_ENV": "prod"}, {"E": ""}):
        got = EnvConfig(tmp_path, environ=environ)
        want = JaxEnvConfig(tmp_path, environ=environ)
        for key in keys:
            assert got.get(key) == want.get(key), (environ, key)
            assert got.get_or_default(key, "d") == \
                want.get_or_default(key, "d")
        assert got.get_int("E", 5) == want.get_int("E", 5)
        assert got.get_float("A", 1.5) == want.get_float("A", 1.5)
        assert got.get_bool("E") == want.get_bool("E")
    d, jd = DictConfig({"X": "3", "Y": ""}), JaxDictConfig({"X": "3",
                                                           "Y": ""})
    assert [d.get_int("X", 0), d.get_or_default("Y", "z"), d.get("Q")] == \
        [jd.get_int("X", 0), jd.get_or_default("Y", "z"), jd.get("Q")]


def test_config_module_has_no_compile_cache():
    import gofr_tpu_torch.config.env as env
    assert not hasattr(env, "enable_compile_cache")
    assert "compilation" in env.__doc__


# ------------------------------------------------------------- container
CONTAINER_CFG = {"APP_NAME": "svc", "APP_VERSION": "1.2",
                 "LOG_LEVEL": "WARN", "PUBSUB_BACKEND": "MEMORY",
                 "TRACE_EXPORTER": "memory", "TRACER_RATIO": "0.5"}


@time_limit(60)
def test_container_create_and_health_like_jax():
    port = Container.create(DictConfig(CONTAINER_CFG))
    jax_ = JaxContainer.create(JaxDictConfig(CONTAINER_CFG))
    try:
        def families(c, rename=False):
            names = {m.split("{")[0].split(" ")[2] for m in
                     c.metrics.render_prometheus().splitlines()
                     if m.startswith("# TYPE")}
            return {n.replace("app_tpu_", "app_gpu_") if rename else n
                    for n in names}
        assert families(port) == families(jax_, rename=True)
        assert (port.app_name, port.app_version, port.logger.level,
                port.tracer.ratio, type(port.tracer.exporter).__name__,
                type(port.pubsub).__name__) == \
            (jax_.app_name, jax_.app_version, jax_.logger.level,
             jax_.tracer.ratio, type(jax_.tracer.exporter).__name__,
             type(jax_.pubsub).__name__)
        got, want = port.health(), jax_.health()
        assert got["status"] == want["status"] == "UP"
        assert got["checks"] == want["checks"]
        assert set(got["details"]) == set(want["details"])
        assert got["details"]["name"] == want["details"]["name"] == "svc"
        port.register_health_check("extra", _Down())
        jax_.register_health_check("extra", _Down())
        got, want = port.health(), jax_.health()
        assert (got["status"], got["checks"]) == \
            (want["status"], want["checks"])
        for c in (port, jax_):
            c.add_model("m", "engine")
            c.register_service("svc", "client")
        assert (port.get_model("m"), port.get_http_service("svc")) == \
            (jax_.get_model("m"), jax_.get_http_service("svc"))
    finally:
        asyncio.run(port.close())
        asyncio.run(jax_.close())


class _Down:
    def health_check(self):
        return {"status": "DOWN", "error": "planted"}


class _Collector:
    """A stdlib HTTP endpoint on a thread: counts the POSTs it takes (an
    exporter's span batches) and answers a GET with ``{"level": ...}``
    (a remote log-level endpoint)."""

    def __init__(self) -> None:
        import http.server
        import threading
        collector = self
        self.posts: list[bytes] = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                size = int(self.headers.get("Content-Length", 0))
                collector.posts.append(self.rfile.read(size))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                body = b'{"level": "DEBUG"}'
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


@pytest.fixture(scope="module")
def live_backends():
    """One Mini server of the port for each backend a config key can
    name, the brokers on a loop thread, and a collector endpoint."""
    pg = side_module("port", "postgres").MiniPostgresServer(
        user="app", password="s3cr3t")
    my = side_module("port", "mysql").MiniMySQLServer(user="app",
                                                      password="s3cr3t")
    ora = side_module("port", "oracle").MiniOracleServer(
        users={"app": "s3cr3t"})
    rd = side_module("port", "redis").MiniRedisServer()
    for srv in (pg, my, ora, rd):
        srv.start()
    loop = LoopThread()
    brokers = {"kafka": side_module("port", "kafka").MiniKafkaBroker(),
               "nats": side_module("port", "nats").MiniNATSServer(),
               "jetstream":
                   side_module("port", "jetstream").MiniJetStreamServer(),
               "mqtt": side_module("port", "mqtt").MiniMQTTBroker(),
               "google": side_module("port", "google").MiniPubSubEmulator()}
    for broker in brokers.values():
        loop.run(broker.start())
    collector = _Collector()
    ports = {"postgres": pg.port, "mysql": my.port, "oracle": ora.port,
             "redis": rd.port, "collector": collector.port,
             **{k: b.port for k, b in brokers.items()}}
    yield ports
    for broker in brokers.values():
        loop.run(broker.close())
    loop.close()
    for srv in (pg, my, ora, rd, collector):
        srv.close()


def _backend_env(key: str, value: str, port: int) -> dict:
    """The config a user writes for ``key=value`` with its server on
    ``port``."""
    host = "127.0.0.1"
    if key == "DB_DIALECT":
        return {"DB_DIALECT": value, "DB_HOST": host, "DB_PORT": str(port),
                "DB_USER": "app", "DB_PASSWORD": "s3cr3t",
                **({"DB_NAME": "appdb"} if value != "oracle" else {})}
    if key == "REDIS_MODE":
        return {"REDIS_HOST": host, "REDIS_PORT": str(port),
                "REDIS_MODE": value}
    if key == "TRACE_EXPORTER":
        return {"TRACE_EXPORTER": value,
                "TRACER_URL": f"http://{host}:{port}"}
    if key == "REMOTE_LOG_URL":
        return {"REMOTE_LOG_URL": f"http://{host}:{port}/level"}
    if value == "MQTT":
        return {"PUBSUB_BACKEND": value, "MQTT_HOST": host,
                "MQTT_PORT": str(port)}
    return {"PUBSUB_BACKEND": value, "PUBSUB_BROKER": f"{host}:{port}",
            "EVENTHUB_NAME": "hub"}


def _slot_of(side: str, key: str, env: dict):
    """What ``side``'s container builds for ``key``: the slot's class
    name (None for an empty slot) and what a use of it shows: the
    store's health, the broker's health after ``connect_async``, the
    span batches a collector got, the remote level applied."""
    from gofr_tpu.config.env import DictConfig as JaxDict
    container_cls = Container if side == "port" else JaxContainer
    config = (DictConfig if side == "port" else JaxDict)(env)
    c = container_cls.create(config)
    try:
        if key == "DB_DIALECT":
            slot = c.sql
            use = None if slot is None else slot.health_check()["status"]
        elif key == "REDIS_MODE":
            slot = c.redis
            use = slot.health_check()["status"]
        elif key == "TRACE_EXPORTER":
            slot = c.tracer.exporter
            c.tracer.start_span("probe").end()
            slot.close()
            use = None
        elif key == "REMOTE_LOG_URL":
            package = "gofr_tpu_torch" if side == "port" else "gofr_tpu"
            remote = importlib.import_module(f"{package}.logging.remote")
            slot = remote.from_config(config, c.logger)
            use = asyncio.run(slot.poll_once())
        else:
            slot = c.pubsub

            async def connect_and_check():
                await c.connect_async()
                status = slot.health_check()["status"]
                await slot.close()
                return status
            use = asyncio.run(connect_and_check())
        return (None if slot is None else type(slot).__name__), use
    finally:
        if key in ("DB_DIALECT", "REDIS_MODE"):
            asyncio.run(c.close())


BACKEND_KEYS = [("DB_DIALECT", v) for v in
                ("postgres", "cockroachdb", "supabase", "mysql", "oracle")] \
    + [("REDIS_MODE", "network")] \
    + [("TRACE_EXPORTER", v) for v in ("otlp", "jaeger", "zipkin")] \
    + [("REMOTE_LOG_URL", "level")] \
    + [("PUBSUB_BACKEND", v) for v in
       ("KAFKA", "EVENTHUB", "GOOGLE", "NATS", "JETSTREAM", "MQTT")]

_SERVER_OF = {"postgres": "postgres", "cockroachdb": "postgres",
              "supabase": "postgres", "mysql": "mysql", "oracle": "oracle",
              "network": "redis", "otlp": "collector",
              "jaeger": "collector", "zipkin": "collector",
              "level": "collector", "KAFKA": "kafka", "EVENTHUB": "kafka",
              "GOOGLE": "google", "NATS": "nats", "JETSTREAM": "jetstream",
              "MQTT": "mqtt"}


@pytest.mark.parametrize("live", [True, False], ids=["live", "dead"])
@pytest.mark.parametrize("key,value", BACKEND_KEYS,
                         ids=[v for _, v in BACKEND_KEYS])
@time_limit(60)
def test_container_builds_what_jax_builds(live_backends, key, value, live):
    """Every backend key JAX's ``Container.create`` honours builds the
    same kind of slot in the port's, and a use of it shows the same
    outcome: against the port's Mini server, and against a dead port
    (a SQL dialect is logged and left ``None``, the RESP client is kept
    to redial on use, a broker's health is DOWN, a remote-level poll
    applies nothing)."""
    port = live_backends[_SERVER_OF[value]] if live else dead_port()
    env = _backend_env(key, value, port)
    port_slot = _slot_of("port", key, env)
    jax_slot = _slot_of("jax", key, env)
    assert port_slot == jax_slot
    if key == "DB_DIALECT":
        assert (port_slot[0] is not None) == live
    elif key == "TRACE_EXPORTER":
        assert port_slot[0] in ("OTLPHTTPExporter", "ZipkinExporter")
    else:
        assert port_slot[0] is not None


@pytest.mark.parametrize("env,slot", [
    ({"PUBSUB_BACKEND": "MEMORY"}, "pubsub"),
    ({"PUBSUB_BACKEND": "inmemory"}, "pubsub"),
    ({"PUBSUB_BACKEND": "SQS"}, "pubsub"),
    ({"TRACE_EXPORTER": "console"}, "exporter"),
    ({"TRACE_EXPORTER": "gofr"}, "exporter"),
    ({"TRACE_EXPORTER": "memory"}, "exporter"),
    ({"TRACE_EXPORTER": "datadog"}, "exporter"),
    ({"DB_DIALECT": "sqlite"}, "sql"),
    ({"DB_DIALECT": "oracle"}, "sql"),
    ({"DB_DIALECT": "postgres"}, "sql"),
    ({"DB_DIALECT": "mysql", "DB_HOST": "127.0.0.1", "DB_PORT": "x"}, "sql"),
    ({"REDIS_HOST": "localhost"}, "redis"),
    ({"REDIS_HOST": "localhost", "REDIS_MODE": "embedded"}, "redis"),
    ({"MQTT_QOS": "2", "PUBSUB_BACKEND": "MQTT"}, "pubsub")],
    ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items())
    if isinstance(v, dict) else v)
def test_container_builds_the_in_process_slots_jax_builds(env, slot):
    """The keys that need no server (the in-memory broker, the console
    and memory exporters, sqlite, the embedded Redis) and the values JAX
    does not honour (an unknown broker or exporter, a network dialect
    without ``DB_HOST``, a port that is not a number) give the slot
    JAX's container gives: the same class, or none."""
    def kind(c):
        value = c.tracer.exporter if slot == "exporter" \
            else getattr(c, slot)
        return None if value is None else type(value).__name__
    port = Container.create(DictConfig(env))
    jax = JaxContainer.create(JaxDictConfig(env))
    try:
        assert kind(port) == kind(jax)
        if slot == "pubsub" and env.get("PUBSUB_BACKEND") == "MQTT":
            assert port.pubsub.qos == jax.pubsub.qos == 1
    finally:
        asyncio.run(port.close())
        asyncio.run(jax.close())


def test_tracer_stamps_the_log_lines_of_its_span():
    out = io.StringIO()
    logger = tlog.Logger(out=out, pretty=False)
    span = Tracer().start_span("outer", traceparent=TRACEPARENT)
    logger.info("inside")
    span.end()
    logger.info("after")
    inside, after = (json.loads(x) for x in out.getvalue().splitlines())
    assert (inside["trace_id"], inside["span_id"]) == \
        (span.trace_id, span.span_id)
    assert "trace_id" not in after


def test_console_exporter_logs_each_span():
    from gofr_tpu_torch.tracing import ConsoleExporter
    out = io.StringIO()
    logger = tlog.Logger(level=tlog.DEBUG, out=out, pretty=False)
    tracer = Tracer(exporter=ConsoleExporter(logger))
    with tracer.start_span("unit"):
        time.sleep(0.001)
    record = json.loads(out.getvalue().splitlines()[-1])
    assert record["message"].startswith("span unit ")
    assert record["level"] == "DEBUG"


def test_env_is_untouched_by_env_config(tmp_path):
    before = dict(os.environ)
    EnvConfig(tmp_path)
    assert dict(os.environ) == before
