"""The port's service client options (``gofr_tpu_torch/service.py``)
against the JAX package's (``gofr_tpu/service/client.py``), both driven
at one local stdlib server that records what it receives: basic and
API-key auth, custom headers, OAuth2 client credentials against a token
endpoint the test serves (form, bearer, cache, refresh, failure), the
token-bucket rate limit, the health check and its ``HealthConfig``, the
``put`` / ``patch`` / ``delete`` verbs, the order of ``before`` and
``around`` across options, and the circuit breaker's recovery: by its
background health probe when it opened under a call made on an event
loop, by the half-open trial request off a loop. The port's client is
synchronous off a loop; the JAX client's calls run in ``asyncio.run``.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import pytest

from gofr_tpu.service import client as jax_client
from gofr_tpu_torch import service as port_client


class _Recorder(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _answer(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        srv = self.server
        with srv.lock:
            srv.seen.append({"method": self.command, "path": self.path,
                             "headers": {k.lower(): v for k, v in
                                         self.headers.items()},
                             "body": body})
        status, payload = 200, {"ok": True}
        if self.path == "/token":
            form = parse_qs(body.decode())
            srv.token_forms.append(form)
            if srv.token_status != 200:
                status, payload = srv.token_status, {"error": "denied"}
            else:
                payload = {"access_token": f"tok-{len(srv.token_forms)}",
                           "expires_in": srv.expires_in}
        elif self.path == "/fail":
            status = 500
        elif self.path == "/sick":
            status = 503
        elif srv.down and self.path in ("/flaky", "/.well-known/alive"):
            status = 503
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _answer


@pytest.fixture
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    srv.daemon_threads = True
    srv.lock = threading.Lock()
    srv.seen, srv.token_forms = [], []
    srv.token_status, srv.expires_in = 200, 300
    srv.down = False            # /flaky and the health route answer 503
    srv.url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, args=(0.05,),
                              daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(10)


def _reset(srv):
    srv.seen.clear()
    srv.token_forms.clear()


def both(srv, make_options, calls):
    """Run ``calls(service)`` with the port's client and with JAX's, each
    on fresh options; returns [(port result, port requests), (JAX result,
    JAX requests)]."""
    out = []
    for pkg in (port_client, jax_client):
        _reset(srv)
        svc = pkg.new_http_service(srv.url, *make_options(pkg), timeout=10)
        if pkg is jax_client:
            async def run():
                return [await r if asyncio.iscoroutine(r) else r
                        for r in calls(svc)]
            result = asyncio.run(run())
        else:
            result = calls(svc)
        out.append((result, list(srv.seen)))
    return out


def _headers(seen, *names):
    return [{n: r["headers"].get(n) for n in names} for r in seen]


@pytest.mark.parametrize("case", ["basic", "api_key", "api_key_header",
                                  "custom", "custom_then_basic",
                                  "basic_then_custom"])
def test_header_options_equal_jax(server, case):
    def options(pkg):
        return {
            "basic": [pkg.BasicAuth("ada", "s3cr:et")],
            "api_key": [pkg.APIKeyAuth("k-1")],
            "api_key_header": [pkg.APIKeyAuth("k-2", header="X-Key")],
            "custom": [pkg.CustomHeaders({"X-A": "1", "X-B": "2"})],
            "custom_then_basic": [pkg.CustomHeaders({"Authorization": "x"}),
                                  pkg.BasicAuth("u", "p")],
            "basic_then_custom": [pkg.BasicAuth("u", "p"),
                                  pkg.CustomHeaders({"Authorization": "x"})],
        }[case]
    (p_res, p_seen), (j_res, j_seen) = both(
        server, options, lambda s: [s.get("/echo", headers={"X-C": "3"})])
    names = ("authorization", "x-api-key", "x-key", "x-a", "x-b", "x-c")
    assert _headers(p_seen, *names) == _headers(j_seen, *names)
    assert p_res[0].status == j_res[0].status == 200
    got = _headers(p_seen, *names)[0]
    assert got["x-c"] == "3"
    if case == "basic":
        assert got["authorization"] == "Basic YWRhOnMzY3I6ZXQ="
    if case == "custom_then_basic":
        assert got["authorization"].startswith("Basic ")
    if case == "basic_then_custom":
        assert got["authorization"] == "x"


def test_oauth2_fetch_cache_and_refresh_equal_jax(server):
    def options(pkg):
        return [pkg.OAuth2ClientCredentials(
            token_url=server.url + "/token", client_id="id-1",
            client_secret="sec", scopes="read write")]

    (_, p_seen), (_, j_seen) = both(
        server, options, lambda s: [s.get("/a"), s.get("/b")])
    for seen in (p_seen, j_seen):
        assert [r["path"] for r in seen] == ["/token", "/a", "/b"]
        assert seen[0]["method"] == "POST"
        assert seen[0]["headers"]["content-type"] \
            == "application/x-www-form-urlencoded"
        assert parse_qs(seen[0]["body"].decode()) == {
            "grant_type": ["client_credentials"], "client_id": ["id-1"],
            "client_secret": ["sec"], "scope": ["read write"]}
        assert [r["headers"]["authorization"] for r in seen[1:]] \
            == ["Bearer tok-1", "Bearer tok-1"]
    # a token within 30 s of its end is fetched again for each request
    server.expires_in = 20
    (_, p_seen), (_, j_seen) = both(
        server, options, lambda s: [s.get("/a"), s.get("/b")])
    for seen in (p_seen, j_seen):
        assert [r["path"] for r in seen] == ["/token", "/a", "/token", "/b"]
        assert [r["headers"]["authorization"] for r in seen
                if r["path"] != "/token"] == ["Bearer tok-1", "Bearer tok-2"]


def test_oauth2_failed_fetch_raises_like_jax(server):
    server.token_status = 401
    opt = port_client.OAuth2ClientCredentials(
        token_url=server.url + "/token", client_id="i", client_secret="s")
    svc = port_client.new_http_service(server.url, opt)
    with pytest.raises(port_client.ServiceError, match="401"):
        svc.get("/a")
    jopt = jax_client.OAuth2ClientCredentials(
        token_url=server.url + "/token", client_id="i", client_secret="s")
    jsvc = jax_client.new_http_service(server.url, jopt)
    with pytest.raises(jax_client.ServiceError, match="401"):
        asyncio.run(jsvc.get("/a"))
    assert [r["path"] for r in server.seen] == ["/token", "/token"]


def test_rate_limit_bucket_equals_jax(server):
    def calls(s):
        out = []
        for _ in range(3):
            try:
                out.append(s.get("/a"))
            except Exception as exc:  # noqa: BLE001 — recorded
                out.append(exc)
        return out

    results = []
    for pkg in (port_client, jax_client):
        _reset(server)
        svc = pkg.new_http_service(server.url,
                                   pkg.RateLimit(rate=0.001, burst=2))
        if pkg is jax_client:
            async def run():
                out = []
                for _ in range(3):
                    try:
                        out.append(await svc.get("/a"))
                    except Exception as exc:  # noqa: BLE001
                        out.append(exc)
                return out
            got = asyncio.run(run())
        else:
            got = calls(svc)
        results.append(([type(r).__name__ for r in got], len(server.seen)))
    assert results[0] == results[1] == (
        ["Response", "Response", "RateLimitedError"], 2)
    # the bucket refills at ``rate`` a second
    svc = port_client.new_http_service(server.url,
                                       port_client.RateLimit(rate=50, burst=1))
    svc.get("/a")
    with pytest.raises(port_client.RateLimitedError):
        svc.get("/a")
    time.sleep(0.05)
    assert svc.get("/a").ok


@pytest.mark.parametrize("order", ["retry_outer", "limit_outer"])
def test_around_order_equals_jax(server, order):
    """The first option is the outermost ``around``: a retry outside the
    bucket spends a token an attempt and meets the empty bucket; a
    bucket outside the retry spends one for all attempts."""
    def options(pkg):
        retry = pkg.Retry(max_retries=2, backoff_s=0.001)
        limit = pkg.RateLimit(rate=0.001, burst=2)
        return [retry, limit] if order == "retry_outer" else [limit, retry]

    out = []
    for pkg in (port_client, jax_client):
        _reset(server)
        svc = pkg.new_http_service(server.url, *options(pkg))
        try:
            r = svc.get("/fail")
            r = asyncio.run(r) if asyncio.iscoroutine(r) else r
            got = r.status
        except Exception as exc:  # noqa: BLE001
            got = type(exc).__name__
        out.append((got, len(server.seen)))
    assert out[0] == out[1]
    assert out[0] == (("RateLimitedError", 2) if order == "retry_outer"
                      else (500, 3))


def test_health_check_equals_jax(server):
    def checks(pkg, url, *options):
        svc = pkg.new_http_service(url, *options)
        r = svc.health_check()
        return asyncio.run(r) if asyncio.iscoroutine(r) else r

    for pkg in (port_client, jax_client):
        _reset(server)
        assert checks(pkg, server.url) == {"status": "UP"}
        assert server.seen[-1]["path"] == "/.well-known/alive"
        assert checks(pkg, server.url,
                      pkg.HealthConfig(path="/sick", timeout_s=2)) \
            == {"status": "DOWN", "code": 503}
        # an auth option does not touch the probe
        assert checks(pkg, server.url, pkg.APIKeyAuth("k")) \
            == {"status": "UP"}
        assert "x-api-key" not in server.seen[-1]["headers"]
    dead = "http://127.0.0.1:9"          # the discard port: refused
    port_down = checks(port_client, dead)
    jax_down = checks(jax_client, dead)
    assert port_down["status"] == jax_down["status"] == "DOWN"
    assert port_down["error"] and jax_down["error"]


@pytest.mark.parametrize("verb", ["put", "patch", "delete"])
def test_verbs_equal_jax(server, verb):
    (p_res, p_seen), (j_res, j_seen) = both(
        server, lambda pkg: [],
        lambda s: [getattr(s, verb)("/item", json={"v": 1},
                                    params={"q": "x"})])
    for seen in (p_seen, j_seen):
        assert seen[0]["method"] == verb.upper()
        assert seen[0]["path"] == "/item?q=x"
        assert json.loads(seen[0]["body"]) == {"v": 1}
        assert seen[0]["headers"]["content-type"] == "application/json"
    assert p_res[0].json() == j_res[0].json() == {"ok": True}


@pytest.mark.parametrize("path", ["/ok", "/fail"])
def test_each_call_records_service_response_like_jax(server, path):
    """Every call, answered or failed with a status, records one sample
    of ``app_http_service_response`` under the service and the method,
    and one debug line, on both packages."""
    from gofr_tpu.container.container import Container as JaxContainer
    from gofr_tpu.logging.logger import DEBUG as JAX_DEBUG
    from gofr_tpu.logging.logger import MockLogger as JaxMockLogger
    from gofr_tpu_torch.container.container import Container
    from gofr_tpu_torch.logging.logger import DEBUG, MockLogger

    got = {}
    for side, cont_cls, mod, logger in (
            ("jax", JaxContainer, jax_client, JaxMockLogger(level=JAX_DEBUG)),
            ("port", Container, port_client, MockLogger(level=DEBUG))):
        c = cont_cls(logger=logger)
        c.register_framework_metrics()
        svc = mod.HTTPService(server.url, metrics=c.metrics, logger=logger,
                              service_name="billing")
        resp = svc.post(path, json={"n": 1})
        if side == "jax":
            resp = asyncio.run(resp)
        got[side] = (
            resp.status,
            c.metrics.get_histogram_count("app_http_service_response",
                                          service="billing", method="POST"),
            c.metrics.get_histogram_count("app_http_service_response",
                                          service="billing", method="GET"),
            [line["message"].split(" (")[0] for line in logger.lines
             if line["level"] == "DEBUG"])
    assert got["port"] == got["jax"]
    assert got["port"][1:3] == (1, 0)
    assert got["port"][3] == [f"POST billing{path} -> {got['port'][0]}"]


def test_service_name_defaults_to_the_host_and_port(server):
    svc = port_client.HTTPService(server.url)
    jax_svc = jax_client.HTTPService(server.url)
    assert svc.service_name == jax_svc.service_name == \
        server.url.split("//")[1]


def test_breaker_closes_from_its_probe_alone_with_jaxs(server):
    """Both breakers open under calls made on one event loop while the
    upstream is down; it stays down through the first probe and then
    comes back. With no request made, each breaker's probe of the health
    route closes it, the port's at the same probe tick as JAX's."""
    interval = 0.2
    breakers = {"port": port_client.CircuitBreaker(threshold=2,
                                                   interval_s=interval),
                "jax": jax_client.CircuitBreaker(threshold=2,
                                                 interval_s=interval)}
    services = {"port": port_client.HTTPService(server.url, breakers["port"]),
                "jax": jax_client.HTTPService(server.url, breakers["jax"])}

    async def flow():
        server.down = True
        opened, closed = {}, {}
        for _ in range(2):
            for name, svc in services.items():
                assert (await svc.get("/flaky")).status == 503
                if breakers[name].is_open:
                    opened[name] = time.monotonic()
        assert opened.keys() == {"port", "jax"}
        with pytest.raises(port_client.CircuitOpenError):
            await services["port"].get("/flaky")
        requests = len(server.seen)
        await asyncio.sleep(1.5 * interval)   # the first probes see 503
        server.down = False
        deadline = time.monotonic() + 10 * interval
        while len(closed) < 2 and time.monotonic() < deadline:
            for name, cb in breakers.items():
                if name not in closed and not cb.is_open:
                    closed[name] = time.monotonic()
            await asyncio.sleep(0.005)
        return opened, closed, server.seen[requests:]

    opened, closed, after = asyncio.run(flow())
    assert closed.keys() == {"port", "jax"}
    # only probes reached the upstream once the breakers were open:
    # the first (503) and the one that closed each breaker
    assert {r["path"] for r in after} == {"/.well-known/alive"}
    assert len(after) >= 4
    took = {name: closed[name] - opened[name] for name in closed}
    assert took["port"] > 1.5 * interval and took["jax"] > 1.5 * interval
    assert abs(took["port"] - took["jax"]) < interval / 2, took


def test_breaker_off_a_loop_recovers_by_its_trial_as_jaxs(server):
    """Calls made off any loop (the port's synchronous calls; JAX's, an
    ``asyncio.run`` each) start no probe: the circuit stays open until
    the half-open trial request after ``interval_s`` closes it."""
    interval = 0.05
    for pkg in (port_client, jax_client):
        cb = pkg.CircuitBreaker(threshold=2, interval_s=interval)
        svc = pkg.HTTPService(server.url, cb)

        def call(path):
            r = svc.get(path)
            return asyncio.run(r) if asyncio.iscoroutine(r) else r

        server.down = True
        for _ in range(2):
            assert call("/flaky").status == 503
        assert cb.is_open
        server.down = False
        time.sleep(4 * interval)
        assert cb.is_open                  # no probe closed it
        assert call("/flaky").ok and not cb.is_open
