"""Inter-service HTTP client with decorator options (the port's copy of
``gofr_tpu/service/client.py``).

``new_http_service(url, *options)`` builds a client whose options wrap
the transport, in JAX's order: every option's ``before`` edits the
headers (first to last), then the ``around`` chain runs with the first
option outermost. The options:

- :class:`BasicAuth`, :class:`APIKeyAuth` (header ``X-Api-Key`` by
  default), :class:`CustomHeaders`, :class:`OAuth2ClientCredentials`
  (the token fetched with a form POST to ``token_url`` and cached until
  30 s before its ``expires_in``);
- :class:`Retry` (bounded retries with exponential backoff; a 429 / 503
  carrying ``Retry-After`` waits what the server asked, capped);
- :class:`RateLimit` (a token bucket of ``rate`` a second and ``burst``
  capacity; an empty bucket raises :class:`RateLimitedError`);
- :class:`CircuitBreaker` (opens after ``threshold`` consecutive
  failures; when it opens under a call made on an event loop, a task on
  that loop probes the health route every ``interval_s`` and closes it
  on success; besides, one trial request per ``interval_s`` is let
  through half-open and closes it on success);
- :class:`HealthConfig`: the path and timeout of
  :meth:`HTTPService.health_check` (``/.well-known/alive``, 5 s).

Every request carries the active span's ``traceparent`` when the service
has a tracer.

Each call is one ``http.client`` connection, ``Connection: close``, made
synchronously. Called from a thread that runs an event loop (an ``async
def`` handler), :meth:`HTTPService.request`, the verbs and
:meth:`HTTPService.health_check` return an awaitable instead, which
makes the same call on a worker thread (:func:`awaitable_on_loop`), so a
handler written for JAX's coroutine client (``resp = await
svc.get(...)``) runs unchanged and the loop serves other requests while
the call is in flight. Anywhere else they return the :class:`Response`
(the health dict): the agent's heartbeat thread, the router's request
threads and the port's callers on worker threads call it directly.
:func:`probe_leader` / :func:`resolve_leader` walk the
ranked leader candidates' ``GET /control/leader``.

Each call records its seconds (``time.perf_counter``) in the
``app_http_service_response`` histogram under its ``service`` and
``method`` when the service has metrics, and a debug line when it has a
logger, as JAX's client does.
"""

from __future__ import annotations

import asyncio
import base64
import contextvars
import http.client
import json as json_mod
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping
from urllib.parse import urlencode, urlsplit


@dataclass
class Response:
    status: int
    headers: dict[str, str]
    body: bytes

    def json(self) -> Any:
        return json_mod.loads(self.body) if self.body else None

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


class ServiceError(Exception):
    pass


class CircuitOpenError(ServiceError):
    def __init__(self, url: str) -> None:
        super().__init__(f"circuit breaker open for {url}")


class RateLimitedError(ServiceError):
    def __init__(self, url: str) -> None:
        super().__init__(f"client-side rate limit exceeded for {url}")


def _raw_request(method: str, url: str, *, headers: Mapping[str, str],
                 body: bytes, timeout: float) -> Response:
    split = urlsplit(url)
    conn = http.client.HTTPConnection(split.hostname or "localhost",
                                      split.port or 80, timeout=timeout)
    path = split.path or "/"
    if split.query:
        path += "?" + split.query
    try:
        conn.request(method, path, body=body,
                     headers={"Connection": "close", **headers})
        resp = conn.getresponse()
        data = resp.read()
        return Response(status=resp.status,
                        headers={k.lower(): v for k, v in resp.getheaders()},
                        body=data)
    finally:
        conn.close()


# ------------------------------------------------------------- options
#: the transport's failures a retry may ride out
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)

Call = Callable[[str, str, dict, bytes], Response]


class Option:
    """A decorator around the request call; subclasses override
    ``before`` (edit the headers) or ``around`` (wrap the call)."""

    def bind(self, service: "HTTPService") -> None:
        self.service = service

    def before(self, headers: dict[str, str]) -> None:
        pass

    def around(self, call: Call, method: str, path: str, headers: dict,
               body: bytes) -> Response:
        return call(method, path, headers, body)


@dataclass
class BasicAuth(Option):
    username: str
    password: str

    def before(self, headers: dict[str, str]) -> None:
        token = base64.b64encode(
            f"{self.username}:{self.password}".encode()).decode()
        headers["Authorization"] = f"Basic {token}"


@dataclass
class APIKeyAuth(Option):
    api_key: str
    header: str = "X-Api-Key"

    def before(self, headers: dict[str, str]) -> None:
        headers[self.header] = self.api_key


@dataclass
class CustomHeaders(Option):
    headers: dict[str, str] = field(default_factory=dict)

    def before(self, headers: dict[str, str]) -> None:
        headers.update(self.headers)


@dataclass
class OAuth2ClientCredentials(Option):
    """The client-credentials grant: a form POST of ``grant_type``,
    ``client_id``, ``client_secret`` (and ``scope`` when set) to
    ``token_url``; the ``access_token`` is sent as a bearer token and
    fetched again 30 s before its ``expires_in`` (default 300 s) runs
    out. A failed fetch raises :class:`ServiceError`."""

    token_url: str
    client_id: str
    client_secret: str
    scopes: str = ""
    _token: str | None = None
    _expiry: float = 0.0

    def before(self, headers: dict[str, str]) -> None:
        if self._token is None or time.time() >= self._expiry - 30:
            form = {"grant_type": "client_credentials",
                    "client_id": self.client_id,
                    "client_secret": self.client_secret}
            if self.scopes:
                form["scope"] = self.scopes
            resp = _raw_request(
                "POST", self.token_url,
                headers={"Content-Type": "application/x-www-form-urlencoded"},
                body=urlencode(form).encode(), timeout=10.0)
            if not resp.ok:
                raise ServiceError(
                    f"oauth token fetch failed: {resp.status}")
            payload = resp.json() or {}
            self._token = payload.get("access_token", "")
            self._expiry = time.time() + float(payload.get("expires_in", 300))
        headers["Authorization"] = f"Bearer {self._token}"


def parse_retry_after(value: str) -> float | None:
    """RFC 9110 ``Retry-After``: delta-seconds or an HTTP-date -> the
    wait in seconds (floored at 0), or None when absent or unparseable
    (callers fall back to backoff)."""
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    from email.utils import parsedate_to_datetime
    try:
        when = parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    return max(0.0, when.timestamp() - time.time())


@dataclass
class Retry(Option):
    """Bounded retries with exponential backoff; 429 / 503 answers with
    ``Retry-After`` wait what the server asked instead, capped at
    ``max_retry_after_s`` (a plain 429 is the caller's quota, not a
    transient: it is not retried)."""

    max_retries: int = 3
    backoff_s: float = 0.05
    honor_retry_after: bool = True
    max_retry_after_s: float = 30.0

    def _server_wait(self, resp: Response) -> float | None:
        if not self.honor_retry_after or resp.status not in (429, 503):
            return None
        wait = parse_retry_after(resp.headers.get("retry-after", ""))
        if wait is None:
            return None
        return min(wait, self.max_retry_after_s)

    def around(self, call, method, path, headers, body):
        last_exc: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                resp = call(method, path, headers, body)
                if attempt < self.max_retries:
                    wait = self._server_wait(resp)
                    if wait is not None:
                        time.sleep(wait)
                        continue
                    if resp.status >= 500:
                        time.sleep(self.backoff_s * (2 ** attempt))
                        continue
                return resp
            except _TRANSPORT_ERRORS as exc:
                last_exc = exc
                if attempt < self.max_retries:
                    time.sleep(self.backoff_s * (2 ** attempt))
        raise ServiceError(f"request failed after {self.max_retries + 1} "
                           f"attempts: {last_exc!r}")


@dataclass
class RateLimit(Option):
    """Token bucket: ``rate`` requests a second, ``burst`` capacity; a
    request that finds it empty raises :class:`RateLimitedError`."""

    rate: float = 10.0
    burst: int = 10

    def __post_init__(self) -> None:
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def around(self, call, method, path, headers, body):
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens < 1.0:
                raise RateLimitedError(self.service.base_url)
            self._tokens -= 1.0
        return call(method, path, headers, body)


@dataclass
class CircuitBreaker(Option):
    """Opens after ``threshold`` consecutive failures (a raise or a 5xx).
    While open, requests fail fast with :class:`CircuitOpenError` except
    one trial per ``interval_s`` (half-open), whose success closes it.

    Recovery is two-pronged, as in JAX's client: when the breaker opens
    under a call made on an event loop, a task on that loop probes
    :meth:`HTTPService.health_check` every ``interval_s`` and closes it
    on ``UP``, with no request made; a call made off any loop (a worker
    thread, or a loop that has ended) has only the half-open trial."""

    threshold: int = 5
    interval_s: float = 1.0

    def __post_init__(self) -> None:
        self._failures = 0
        self._open = False
        self._last_probe = 0.0
        #: the running probe: (its loop, its concurrent future)
        self._probe_task: tuple | None = None

    @property
    def is_open(self) -> bool:
        return self._open

    def around(self, call, method, path, headers, body):
        if self._open:
            now = time.monotonic()
            if now - self._last_probe < self.interval_s:
                raise CircuitOpenError(self.service.base_url)
            self._last_probe = now  # half-open: this request is the trial
        try:
            resp = call(method, path, headers, body)
        except Exception:
            self._record_failure()
            raise
        if resp.status >= 500:
            self._record_failure()
        else:
            self._failures = 0
            self._open = False
        return resp

    def _record_failure(self) -> None:
        self._failures += 1
        if self._failures >= self.threshold and not self._open:
            self._open = True
            self._last_probe = time.monotonic()
            self._start_probe()

    def _start_probe(self) -> None:
        loop = _caller_loop()
        running = self._probe_task
        if loop is None or (running is not None and not running[1].done()
                            and running[0].is_running()):
            return  # no loop (the half-open trial only), or one runs
        try:
            self._probe_task = (loop, asyncio.run_coroutine_threadsafe(
                self._probe(), loop))
        except RuntimeError:  # the loop has closed
            self._probe_task = None

    async def _probe(self) -> None:
        while self._open:
            await asyncio.sleep(self.interval_s)
            try:
                resp = await self.service.health_check()
                if resp.get("status") == "UP":
                    self._open = False
                    self._failures = 0
            except Exception:  # noqa: BLE001 — a failed probe retries
                continue


@dataclass
class HealthConfig(Option):
    """Where :meth:`HTTPService.health_check` asks, and how long it
    waits."""

    path: str = "/.well-known/alive"
    timeout_s: float = 5.0


# -------------------------------------------------------------- service
class HTTPService:
    """Requests to one base URL through its options, with the active
    span's ``traceparent`` when it has a tracer."""

    def __init__(self, base_url: str, *options: Option,
                 timeout: float = 30.0, logger: Any = None,
                 metrics: Any = None, tracer: Any = None,
                 service_name: str = "") -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self.service_name = service_name or urlsplit(base_url).netloc
        self.options = list(options)
        self.health = next((o for o in self.options
                            if isinstance(o, HealthConfig)), HealthConfig())
        for opt in self.options:
            opt.bind(self)

    def request(self, method: str, path: str, *,
                params: Mapping[str, Any] | None = None,
                json: Any = None, body: bytes | None = None,
                headers: Mapping[str, str] | None = None) -> Any:
        """The :class:`Response` to one request through the options; on
        a thread that runs an event loop, an awaitable of it
        (:func:`awaitable_on_loop`). ``params``, ``json``, ``body``,
        ``headers`` as JAX's."""
        return awaitable_on_loop(self._request, method, path, params=params,
                                 json=json, body=body, headers=headers)

    def _request(self, method: str, path: str, *,
                 params: Mapping[str, Any] | None = None,
                 json: Any = None, body: bytes | None = None,
                 headers: Mapping[str, str] | None = None) -> Response:
        hdrs = {k: str(v) for k, v in (headers or {}).items()}
        if json is not None:
            body = json_mod.dumps(json).encode()
            hdrs.setdefault("Content-Type", "application/json")
        body = body or b""
        if params:
            path = path + ("&" if "?" in path else "?") + urlencode(params)
        if self.tracer is not None:
            self.tracer.inject_headers(hdrs)
        for opt in self.options:
            opt.before(hdrs)

        def base_call(method, path, headers, body):
            return _raw_request(method, self.base_url + path,
                                headers=headers, body=body,
                                timeout=self.timeout)

        call: Call = base_call
        for opt in reversed(self.options):
            call = self._wrap(opt, call)
        start = time.perf_counter()
        try:
            resp = call(method, path, hdrs, body)
        finally:
            elapsed = time.perf_counter() - start
            if self.metrics is not None:
                self.metrics.record_histogram(
                    "app_http_service_response", elapsed,
                    service=self.service_name, method=method)
        if self.logger is not None:
            self.logger.debug(
                f"{method} {self.service_name}{path} -> {resp.status} "
                f"({elapsed * 1000:.1f}ms)")
        return resp

    @staticmethod
    def _wrap(opt: Option, call: Call) -> Call:
        def wrapped(method, path, headers, body):
            return opt.around(call, method, path, headers, body)
        return wrapped

    def get(self, path: str, **kw) -> Any:
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw) -> Any:
        return self.request("POST", path, **kw)

    def put(self, path: str, **kw) -> Any:
        return self.request("PUT", path, **kw)

    def patch(self, path: str, **kw) -> Any:
        return self.request("PATCH", path, **kw)

    def delete(self, path: str, **kw) -> Any:
        return self.request("DELETE", path, **kw)

    def health_check(self) -> Any:
        """``GET`` the :class:`HealthConfig` path, outside the options:
        ``{"status": "UP"}`` on a 2xx, else ``DOWN`` with the ``code``
        or the ``error``; on a thread that runs an event loop, an
        awaitable of it."""
        return awaitable_on_loop(self._health_check)

    def _health_check(self) -> dict:
        try:
            resp = _raw_request("GET", self.base_url + self.health.path,
                                headers={}, body=b"",
                                timeout=self.health.timeout_s)
            if resp.ok:
                return {"status": "UP"}
            return {"status": "DOWN", "code": resp.status}
        except Exception as exc:  # noqa: BLE001 — any failure is DOWN
            return {"status": "DOWN", "error": str(exc)}


#: the event loop a call was made on, as the worker thread that runs it
#: sees it (``asyncio.to_thread`` runs it in a copy of the caller's
#: context)
_CALLER_LOOP: contextvars.ContextVar = contextvars.ContextVar(
    "gofr_caller_loop", default=None)


def _caller_loop() -> asyncio.AbstractEventLoop | None:
    """The loop running on this thread, else the loop of the call this
    worker thread runs for (:func:`awaitable_on_loop`), else None."""
    try:
        return asyncio.get_running_loop()
    except RuntimeError:
        return _CALLER_LOOP.get()


def _for_loop(loop: asyncio.AbstractEventLoop, fn: Callable, args: tuple,
              kw: dict) -> Any:
    _CALLER_LOOP.set(loop)
    return fn(*args, **kw)


def awaitable_on_loop(fn: Callable, *args, **kw) -> Any:
    """``fn(*args, **kw)`` here; on a thread that runs an event loop,
    a coroutine that runs it on a worker thread (the caller's context
    vars, and so its span, go with it, and the loop it was called on:
    the circuit breaker's probe runs there), as JAX's clients are
    awaited."""
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        return fn(*args, **kw)
    return asyncio.to_thread(_for_loop, loop, fn, args, kw)


def new_http_service(base_url: str, *options: Option, **kw) -> HTTPService:
    return HTTPService(base_url, *options, **kw)


# --------------------------------------------------------------- leader
def probe_leader(url: str, *, timeout_s: float = 2.0) -> dict | None:
    """``GET {url}/control/leader`` -> the leadership document
    (``active``, ``epoch``, ``rank``, ``host_id``, ``candidates``,
    ``converging``), or None when the candidate is unreachable or
    answers garbage. Never raises: an absent candidate is a normal input
    to the election."""
    parts = urlsplit(url if "//" in url else "http://" + url)
    conn = http.client.HTTPConnection(parts.hostname or "", parts.port or 80,
                                      timeout=timeout_s)
    try:
        conn.request("GET", "/control/leader")
        resp = conn.getresponse()
        if resp.status != 200:
            return None
        doc = json_mod.loads(resp.read().decode("utf-8"))
        data = doc.get("data", doc)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError, http.client.HTTPException):
        return None
    finally:
        conn.close()


def resolve_leader(candidates, *, epoch_at_least: int = -1,
                   timeout_s: float = 2.0) -> dict | None:
    """Walk the ranked ``candidates`` and return the ACTIVE leader as
    ``{"url", "rank", **leadership}``: the highest epoch wins, ties to
    the lowest rank, and an active candidate below ``epoch_at_least`` (a
    revived stale leader) is skipped. None when none is active."""
    best = None
    for rank, url in enumerate(candidates):
        info = probe_leader(url, timeout_s=timeout_s)
        if info is None or not info.get("active"):
            continue
        epoch = int(info.get("epoch", -1))
        if epoch < epoch_at_least:
            continue
        if best is None or epoch > best["epoch"]:
            best = dict(info, url=url, rank=rank, epoch=epoch)
    return best


__all__ = ["APIKeyAuth", "BasicAuth", "CircuitBreaker", "CircuitOpenError",
           "CustomHeaders", "HTTPService", "HealthConfig",
           "OAuth2ClientCredentials", "Option", "RateLimit",
           "RateLimitedError", "Response", "Retry", "ServiceError",
           "new_http_service", "parse_retry_after", "probe_leader",
           "resolve_leader"]
