"""The port's standard-library HTTP front end, :class:`ChatServer`, beside
the framework's ``App`` (``gofr_tpu_torch/app.py``, which
``serving/model_serving.py`` serves a model through); both wire an
engine with :func:`wire_engine`. :func:`build_server` gives ``POST /chat``
(``handlers.make_chat_handler``), the OpenAI routes
(``openai_compat.install_openai_routes``: ``POST /v1/chat/completions``,
``POST /v1/completions``, ``GET /v1/models``), ``GET
/.well-known/health`` (200 while UP or DEGRADED, 503 when DOWN, as the
JAX app's engine health reads), the ``/debug/*`` routes
(:mod:`.debug`), and ``GET /metrics`` on a server of its own
(:func:`build_metrics_server`, ``METRICS_PORT``, default 2121).
:func:`wire_engine` wires the engine as ``App.serve_model`` does: the
metrics manager (``attach_metrics``: the engine's series, the usage
ledger's, the scheduler's, the event ledger's), a default
``SLOTracker(SLOConfig())`` on the engine's event ledger (the
scheduler's ``slo_source``, so burn-rate shedding is live), and the
logger.

:class:`ChatServer` holds a route table (``post(path, fn)`` /
``get(path, fn)``, the counterpart of ``app.post`` / ``app.get``); a
handler takes a :class:`Context` and answers as the framework's
responder does: a plain value as ``{"data": ...}`` (201 for a POST, 200
for a GET), a ``Raw`` as a bare JSON body (same statuses), a ``Stream``
as ``text/event-stream`` with ``Cache-Control: no-cache`` in chunked
transfer encoding, an ``HTTPError`` as ``{"error": {"message",
"details"?}}`` with its status and headers, any other exception as 500
``internal server error``. A stream cut short (its iterator raised, or
the client left) never gets the terminating zero-length chunk, so the
client sees the truncation. A client that leaves cancels its request:
before every chunk, and while a handler waits for a token, the server
checks the socket (readable with nothing to read: closed), and a write
that fails closes the stream's iterator too. ``tenant_of(headers)``
gives the accounting label a request carries into the scheduler and
``usage`` (default: None for every request); ``request_timeout_s``
bounds a unary answer (then the request is cancelled and the answer is
504). Every request runs inside one span of the server's tracer (as the
JAX app's tracer middleware: a child of an inbound ``traceparent``,
else a fresh trace; ``http.status`` set, an error status on a 5xx), and
every answer carries ``X-Trace-Id``; the engine's ``engine.*`` spans of
the request join that trace.

Run: ``python -m gofr_tpu_torch.serving.app`` on ``HTTP_HOST`` (default
0.0.0.0) and ``HTTP_PORT`` (default 8000), ``/metrics`` on
``METRICS_PORT`` (default 2121), on the CUDA device, with the
model chosen as ``examples/model-serving/main.py`` chooses it
(:func:`app_engine`):

- ``MODEL_PATH``: a local Hugging Face Llama directory (``config.json``,
  ``model.safetensors`` or its sharded index, optionally
  ``tokenizer.json``, which switches on the BPE tokenizer and its
  end-of-text id); ``MODEL_MAX_SEQ`` (default 8192) caps its context,
  ``MODEL_DTYPE`` overrides its dtype;
- else ``MODEL_PRESET`` (default ``llama3_1b``), random weights from
  seed 0, with the byte tokenizer;
- ``MODEL_QUANT=int8|int4`` quantizes the weights in either case (on
  load for a checkpoint): their decode products and every LM head then
  run through the weight-dequantizing GEMM kernel.

:meth:`ChatServer.register_grpc_service` serves a gRPC service (the
chat service of ``serving/grpc_chat.py``) beside the HTTP routes on
``GRPC_PORT`` (default 9000); ``grpc`` is imported there only, and the
module's ``main`` registers none. ``checkpoint.restore_engine`` builds
an engine from the latest checkpoint, for ``build_server``
(``checkpoint.warm_start`` does the same as an ``App``'s on-start hook).

The encoders serve from servers of their own, without an engine:
:func:`embed_app` (``POST /embed``, BERT) and :func:`asr_app` (``POST
/transcribe`` and a pub/sub batch worker, Whisper; the counterpart of
``examples/asr-worker/main.py``).

``PROFILER_ENABLED=1`` adds ``/debug/profile/start|stop`` and ``GET
/debug/profile`` (``torch.profiler`` captures into ``PROFILER_DIR``,
default ``gofr_tpu_profiles`` under the temporary directory).

The health route also carries the ``DeviceRegistry``'s section
(``devices``: the CUDA devices, their memory, DOWN with the error when
the probe fails) and the ``app_gpu_*`` gauges. For a fleet (counterparts
of ``App.serve_fleet_leader`` / ``App.join_fleet``):
:func:`serve_fleet_leader` is a server without an engine holding the
control plane (``serving/control_plane.py``) and, with ``router=``, the
prefix-aware router (``serving/router.py``); :func:`join_fleet` joins a
``build_server`` worker to a leader with a heartbeating ``WorkerAgent``.

Prompts up to the widest bucket prefill through the flash kernel,
longer ones and prefix-cache suffixes walk through the paged chunk
kernel, and every token decodes through the paged decode kernel. The
prefix cache is on, as in the JAX engine.
"""

from __future__ import annotations

import itertools
import json
import os
import select
import socket
import threading
import time
import traceback
from collections.abc import Callable, Mapping
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any
from urllib.parse import parse_qs, urlsplit

import torch

from ..device import DeviceRegistry, resolve_device, worst_status
from ..metrics import Manager
from ..tracing import Tracer
from ..models.hf_checkpoint import (load_llama_checkpoint,
                                    load_whisper_checkpoint,
                                    resolve_serving_dtype)
from ..models.llama import LlamaConfig, llama_init
from ..models.whisper import WhisperConfig, whisper_init
from ..pubsub.inmemory import InMemoryBroker
from .asr import ASRConfig, ASRWorker, LoopThread, Transcriber, \
    make_asr_handler
from .debug import install_debug_routes
from .engine import Engine, EngineConfig
from .glue import llama_engine
from .handlers import make_chat_handler, make_embed_handler
from ..logging.logger import Logger
from .observability import SLOConfig, SLOTracker
from .openai_compat import install_openai_routes
from ..http.errors import ClientGone, HTTPError
from ..http.response import File, Raw, Reply, Stream
from .tokenizer import BPETokenizer, ByteTokenizer

#: a client's connection errors: it is gone
_GONE = (BrokenPipeError, ConnectionResetError, ConnectionAbortedError)
#: an iterator's end
_END = object()


def _peer_gone(sock: socket.socket) -> bool:
    """True when the client closed its end: the socket reads as
    readable with nothing to read (or errors)."""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        return bool(readable) and sock.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError):
        return True


class Context:
    """One request as a handler sees it."""

    def __init__(self, handler: "_Handler", body: bytes) -> None:
        self._handler = handler
        self.server: ChatServer = handler.server
        self.headers = handler.headers
        self.body = body

    def param(self, name: str) -> str | None:
        """The first value of query parameter ``name``, or None."""
        values = parse_qs(urlsplit(self._handler.path).query,
                          keep_blank_values=True).get(name)
        return values[0] if values else None

    def bind(self) -> Any:
        """The JSON body ({} when empty); a 400 when it is not JSON."""
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as exc:
            raise HTTPError(f"invalid JSON body: {exc}",
                            status_code=400) from exc

    @property
    def tenant(self) -> str | None:
        return self.server.tenant_of(self.headers)

    @property
    def request_timeout_s(self) -> float:
        return self.server.request_timeout_s

    def client_gone(self) -> bool:
        return _peer_gone(self._handler.connection)


class _Handler(BaseHTTPRequestHandler):
    server: "ChatServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # quiet: one line per request would swamp the smoke output

    def _send_json(self, status: int, payload: Any,
                   headers: Mapping[str, str] | None = None) -> None:
        self._send_bytes(status, json.dumps(payload).encode(),
                         "application/json", headers)

    def _trace_headers(self) -> None:
        """``X-Trace-Id`` of the request's span, on every answer."""
        span = getattr(self, "_span", None)
        if span is not None:
            self.send_header("X-Trace-Id", span.trace_id)

    def _send_bytes(self, status: int, body: bytes, content_type: str,
                    headers: Mapping[str, str] | None = None) -> None:
        self._status = status
        try:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self._trace_headers()
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)
        except _GONE:
            self.close_connection = True

    def _send_error(self, exc: HTTPError) -> None:
        error: dict[str, Any] = {"message": str(exc)}
        if exc.details is not None:
            error["details"] = exc.details
        self._send_json(exc.status_code, {"error": error}, exc.headers)

    def _send_stream(self, stream: Stream) -> None:
        """Chunked transfer of ``stream``'s chunks; the zero-length
        terminating chunk only when its iterator ran to its end. Before
        every chunk the client is checked; when it is gone, or a write
        fails, or the iterator raises, the iterator is closed (which
        cancels the request it streams) and the connection dropped."""
        chunks = iter(stream.iterator)
        completed = False
        try:
            # the first chunk before the head: a generator that has run
            # runs its cleanup when closed, one that has not does not
            first = next(chunks, _END)
            self._status = 200
            self.send_response(200)
            self.send_header("Content-Type", stream.content_type)
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self._trace_headers()
            for key, value in stream.headers.items():
                self.send_header(key, value)
            self.end_headers()
            for chunk in (chunks if first is _END
                          else itertools.chain([first], chunks)):
                if _peer_gone(self.connection):
                    break
                if isinstance(chunk, str):
                    chunk = chunk.encode()
                if chunk:
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
            else:
                completed = True
                self.wfile.write(b"0\r\n\r\n")
        except _GONE:
            completed = False            # even the terminating chunk failed
        except Exception:  # noqa: BLE001 — the stream failed mid-flight
            traceback.print_exc()
        finally:
            if not completed:
                self.close_connection = True
                close = getattr(chunks, "close", None)
                if close is not None:
                    close()

    def _dispatch(self, method: str) -> None:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length < 0:
            self.close_connection = True
            self._send_json(400, {"error": {"message": "bad content-length"}})
            return
        body = self.rfile.read(length) if length else b""
        path = urlsplit(self.path).path
        routes = self.server.routes
        fn = routes.get((method, path))
        if fn is None:
            if any(p == path for _, p in routes):
                self._send_json(405, {"error": {
                    "message": "method not allowed"}})
            else:
                self._send_json(404, {"error": {
                    "message": "route not registered"}})
            return
        try:
            result = fn(Context(self, body))
        except ClientGone:
            self.close_connection = True
            return
        except HTTPError as exc:
            self._send_error(exc)
            return
        except Exception:  # noqa: BLE001 — panic recovery: a 500
            traceback.print_exc()
            self._send_json(500, {"error": {
                "message": "internal server error"}})
            return
        if isinstance(result, Stream):
            self._send_stream(result)
            return
        if isinstance(result, File):
            self._send_bytes(200, result.content, result.content_type)
            return
        if isinstance(result, Reply):
            self._send_bytes(result.status, result.body, result.content_type,
                             result.headers)
            return
        status = 201 if method == "POST" else 200
        self._send_json(status, result.data if isinstance(result, Raw)
                        else {"data": result})

    def _traced(self, method: str) -> None:
        """Answer the request inside its span (``http.status`` set, an
        error status on a 5xx), ended once the answer is sent."""
        self._status = None
        span = self.server.tracer.start_span(
            f"{method} {urlsplit(self.path).path}",
            traceparent=self.headers.get("traceparent"))
        self._span = span
        try:
            if method == "GET" and \
                    urlsplit(self.path).path == "/.well-known/health":
                health = self.server.health()
                self._send_json(503 if health["status"] == "DOWN" else 200,
                                {"data": health})
            else:
                self._dispatch(method)
        finally:
            if self._status is not None:
                span.set_attribute("http.status", self._status)
                if self._status >= 500:
                    span.set_status(f"ERROR: {self._status}")
            span.end()
            self._span = None

    def do_GET(self) -> None:  # noqa: N802 — http.server's naming
        self._traced("GET")

    def do_POST(self) -> None:  # noqa: N802 — http.server's naming
        self._traced("POST")


class ChatServer(ThreadingHTTPServer):
    """Threading HTTP server with a route table (``post`` / ``get``),
    bound to an engine or, as a fleet leader, to none;
    ``tenant_of(headers)`` labels each request (None: no tenant);
    ``tracer`` spans each request (None: a tracer that exports nothing,
    so answers still carry ``X-Trace-Id``).

    ``GET /.well-known/health`` answers :meth:`health`: the engine's
    health, the device registry's section under ``devices`` and every
    registered check (``health_checks``, a fleet leader's
    ``control_plane``) under ``checks``, with the worst status of them
    (200 while UP or DEGRADED, 503 when DOWN). ``server_close`` runs the
    ``on_close`` hooks first (a fleet agent's stop, a leader's
    sweeper's)."""

    daemon_threads = True

    def __init__(self, address: tuple, engine: Engine | None = None,
                 request_timeout_s: float = 600.0,
                 tenant_of: Callable[[Any], str | None] | None = None,
                 tracer: Tracer | None = None) -> None:
        super().__init__(address, _Handler)
        self.engine = engine
        self.request_timeout_s = request_timeout_s
        self.tenant_of = tenant_of or (lambda headers: None)
        self.tracer = tracer if tracer is not None else Tracer()
        self.routes: dict[tuple[str, str], Callable] = {}
        #: the metrics manager ``build_server`` attached to the engine
        self.metrics: Manager | None = None
        #: the ``ProfilerCapture`` behind ``/debug/profile/*``, when on
        self.profiler = None
        #: the ``DeviceRegistry`` ``build_server`` made, when any
        self.devices: DeviceRegistry | None = None
        #: name -> object with ``health_check()``, in the health route
        self.health_checks: dict[str, Any] = {}
        #: zero-arg callables run by ``server_close``
        self.on_close: list[Callable[[], None]] = []
        #: the ``ControlPlaneLeader`` of ``serve_fleet_leader``, if any
        self.leader = None
        #: the logger ``build_server`` made (the gRPC server logs there)
        self.logger: Logger | None = None
        #: the environment the server reads (``GRPC_PORT``,
        #: ``GRPC_ENABLE_REFLECTION``)
        self.env: Mapping[str, str] = os.environ
        #: the ``GRPCServer`` of :meth:`register_grpc_service`, if any
        self.grpc_server = None

    def post(self, path: str, fn: Callable) -> None:
        self.routes[("POST", path)] = fn

    def get(self, path: str, fn: Callable) -> None:
        self.routes[("GET", path)] = fn

    @property
    def port(self) -> int:
        return self.server_address[1]

    def health(self) -> dict:
        """The health route's body (see the class docstring)."""
        out = (self.engine.health_check() if self.engine is not None
               else {"status": "UP"})
        statuses = [out["status"]]
        if self.devices is not None:
            out["devices"] = self.devices.device_health()
            statuses.append(out["devices"]["status"])
        if self.health_checks:
            out["checks"] = {name: check.health_check()
                             for name, check in self.health_checks.items()}
            statuses.extend(c.get("status", "UP")
                            for c in out["checks"].values())
        out["status"] = worst_status(*statuses)
        return out

    def metrics_snapshot(self) -> dict:
        """``Manager.snapshot()`` with the device gauges fresh: what a
        fleet agent attaches to its heartbeats."""
        if self.devices is not None:
            self.devices.publish_metrics()
        return self.metrics.snapshot()

    def register_grpc_service(self, service: Any) -> None:
        """Serve ``service`` (a ``gofr_tpu_torch.grpc.GRPCService``) over
        gRPC beside this server (counterpart of the JAX app's
        ``register_grpc_service``): the first call makes a ``GRPCServer``
        on ``GRPC_PORT`` (default 9000; 0 = a free port, then
        ``grpc_server.bound_port``) and this server's host (``grpc.aio``
        on a loop thread of its own: an RPC waiting for tokens holds no
        thread). A protogen module's
        ``FILE_DESCRIPTOR_SET``, found on the service's class or a base's
        module, feeds reflection. The gRPC server starts with
        ``serve_forever`` (or :meth:`start_grpc`) and stops in
        ``server_close``."""
        import sys

        from ..grpc.server import DEFAULT_GRPC_PORT, GRPCServer
        if self.grpc_server is None:
            self.grpc_server = GRPCServer(
                self, port=int(self.env.get("GRPC_PORT", DEFAULT_GRPC_PORT)),
                host=self.server_address[0], logger=self.logger)
        self.grpc_server.register(service)
        # the constant lives in the generated module, usually a base
        # class's (users subclass <Service>Base in their own module)
        for klass in type(service).__mro__:
            fds = getattr(sys.modules.get(klass.__module__),
                          "FILE_DESCRIPTOR_SET", None)
            if fds:
                self.grpc_server.register_descriptors(fds)
                break

    def start_grpc(self) -> None:
        """Start the gRPC server, if a service is registered and it is
        not running yet."""
        if self.grpc_server is not None and not self.grpc_server.started:
            self.grpc_server.start()

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self.start_grpc()
        super().serve_forever(poll_interval)

    def server_close(self) -> None:
        if self.grpc_server is not None:
            self.grpc_server.shutdown()
        for hook in list(self.on_close):
            try:
                hook()
            except Exception:  # noqa: BLE001 — a hook must not block close
                traceback.print_exc()
        self.on_close.clear()
        super().server_close()


def serve_config(model_config: LlamaConfig, **overrides) -> EngineConfig:
    """The engine that ``chip_smoke.py`` measures: 8 slots of up to 2048
    rows (fewer when the model's context is shorter) in 64-row pages,
    prefill buckets up to 1024, the prefix cache on (a quarter of the
    pool); ``overrides`` set other ``EngineConfig`` fields (the smoke's
    speculative cell: ``speculative=True, spec_ngram=2``; its int8 cell:
    ``kv_dtype="int8"``, the same bytes of pool as about twice the
    pages)."""
    return EngineConfig(**{"max_batch": 8,
                           "max_seq": min(2048, model_config.max_seq),
                           "page_size": 64, "seed": 0, **overrides})


def build_engine(model_config: LlamaConfig, *,
                 device: str | torch.device | None = None, seed: int = 0,
                 engine_config: EngineConfig | None = None,
                 quantize: str | None = None, mesh: Any = None) -> Engine:
    """An engine for ``model_config`` with random weights drawn from
    ``seed`` on ``device`` (default: CUDA, or raise; with ``mesh`` the
    mesh's device, every rank drawing the same weights before it keeps
    its shards), quantized with ``quantize`` (None, "int8", "int4");
    ``engine_config`` defaults to ``serve_config(model_config)``."""
    dev = resolve_device(device) if mesh is None else mesh.device
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    params = llama_init(model_config, generator, dev)
    engine_config = engine_config or serve_config(model_config)
    return llama_engine(params, model_config, engine_config,
                        device=None if mesh is not None else dev,
                        quantize=quantize, mesh=mesh)


def app_engine(env: Mapping[str, str], *,
               device: str | torch.device | None = None, mesh: Any = None
               ) -> tuple[Engine, Any, str]:
    """(engine, tokenizer, model name) from the environment surface of
    ``examples/model-serving/main.py``, on ``device`` (default: CUDA, or
    raise). ``MODEL_PATH``: a local HF Llama checkpoint directory, its
    weights quantized on load with ``MODEL_QUANT`` (``int8`` / ``int4``),
    its context capped at ``MODEL_MAX_SEQ`` (default 8192), its dtype
    ``MODEL_DTYPE``, served by ``serve_config`` with that context; a
    ``tokenizer.json`` beside the weights gives the BPE tokenizer, and
    the engine stops at its end-of-text id (without one the byte
    tokenizer serves and nothing stops early: its eos id would alias an
    ordinary vocabulary id). Else ``MODEL_PRESET`` (default
    ``llama3_1b``), random weights from seed 0, the byte tokenizer,
    ``MODEL_QUANT`` honoured the same way. ``mesh``: every rank of a
    tensor-parallel mesh calls this alike and gets its rank's engine
    (``llama_engine(mesh=)``); the leader's is the one to serve."""
    quantize = env.get("MODEL_QUANT", "") or None
    model_path = env.get("MODEL_PATH", "")
    if model_path:
        dev = resolve_device(device) if mesh is None else mesh.device
        dtype_name = env.get("MODEL_DTYPE", "")
        params, model_config = load_llama_checkpoint(
            model_path, quantize=quantize,
            max_seq=int(env.get("MODEL_MAX_SEQ", "8192")),
            dtype=resolve_serving_dtype(dtype_name) if dtype_name else None,
            device=dev)
        tokenizer: Any = ByteTokenizer()
        eos_id = -1
        tok_json = Path(model_path) / "tokenizer.json"
        if tok_json.is_file():
            tokenizer = BPETokenizer.from_hf_json(tok_json)
            eos_id = tokenizer.eos_id
        config = serve_config(model_config, max_seq=model_config.max_seq,
                              eos_id=eos_id)
        return (llama_engine(params, model_config, config,
                             device=None if mesh is not None else dev,
                             mesh=mesh),
                tokenizer, Path(model_path).name)
    preset = env.get("MODEL_PRESET", "llama3_1b")
    engine = build_engine(getattr(LlamaConfig, preset)(), device=device,
                          quantize=quantize, mesh=mesh)
    return engine, ByteTokenizer(), preset


def _env_bool(env: Mapping[str, str], key: str) -> bool:
    return env.get(key, "").strip().lower() in ("1", "true", "yes", "on")


def wire_engine(engine: Engine, name: str, *, metrics: Manager,
                logger: Logger, tracer: Tracer, devices: DeviceRegistry,
                slo: SLOConfig | None = None,
                scheduler: Any = None) -> None:
    """Wire ``engine``, served as model ``name``, into a server's planes:
    the one function behind :func:`build_server` and ``App.serve_model``.

    ``attach_metrics(metrics)`` (the engine's series, the usage
    ledger's, the scheduler's, the event ledger's); ``logger`` where the
    engine and its scheduler have none; ``tracer`` where the engine has
    none (its ``engine.*`` spans join each request's trace); an SLO
    tracker (``slo`` or the default objectives) where the engine has
    none, on the engine's event ledger, whose fast burn arms the
    autoprofiler and opens a ``fast_burn`` incident bundle; the
    scheduler policy ``scheduler`` (a ``SchedulerConfig``) when given;
    and ``devices.register_engine(name, engine)``, its gauges published
    once."""
    engine.attach_metrics(metrics)
    if engine.logger is None:
        engine.logger = logger
    if scheduler is not None:
        engine.waiting.reconfigure(scheduler)
    if engine.waiting.logger is None:
        engine.waiting.logger = logger
    if engine.tracer is None:
        engine.tracer = tracer
    if engine.slo is None:
        engine.slo = SLOTracker(slo or SLOConfig(), metrics=metrics,
                                logger=logger)
        engine.slo.events = engine.events
    if engine.slo.on_fast_burn is None:
        def on_fast_burn() -> None:
            # armed before the bundle opens, so it names the capture
            capture = engine.autoprof.arm("fast_burn",
                                          "SLO error-budget fast burn")
            engine.incidents.trigger(
                "fast_burn", cause="SLO error-budget fast burn",
                attrs={"autoprof_dir": (capture or {}).get("dir")})
        engine.slo.on_fast_burn = on_fast_burn
    devices.register_engine(name, engine)
    devices.publish_metrics()


def build_server(engine: Engine, tokenizer: Any = None,
                 host: str = "127.0.0.1", port: int = 0, *,
                 tenant_of: Callable[[Any], str | None] | None = None,
                 metrics: Manager | None = None,
                 logger: Logger | None = None,
                 slo: SLOConfig | None = None,
                 tracer: Tracer | None = None,
                 env: Mapping[str, str] | None = None,
                 name: str = "model") -> ChatServer:
    """Bind (port 0 = any free port) with ``POST /chat`` and the debug
    routes of model ``name`` installed; call ``serve_forever()`` on it.
    ``install_openai_routes(server, ...)`` adds the OpenAI routes.
    ``env`` (default ``os.environ``): ``PROFILER_ENABLED`` adds the
    profile routes, capturing into ``PROFILER_DIR``.

    The engine is wired by :func:`wire_engine`, as ``App.serve_model``
    wires it: on ``metrics`` (a new manager when None;
    ``server.metrics``, for :func:`build_metrics_server`), the logger (a
    JSON-lines one when None), the server's tracer and a
    ``DeviceRegistry`` of the engine's device (``server.devices``),
    whose section joins the health route. A tensor-parallel engine is
    served by its mesh's leader rank (a follower's is refused: it serves
    no HTTP), and the registry lists that rank's device."""
    mesh = getattr(engine, "mesh", None)
    if mesh is not None and mesh.rank != mesh.leader:
        raise ValueError(f"rank {mesh.rank} follows the mesh's leader "
                         f"(rank {mesh.leader}): it serves no HTTP")
    tokenizer = tokenizer or ByteTokenizer()
    metrics = metrics if metrics is not None else Manager()
    logger = logger if logger is not None else Logger()
    env = os.environ if env is None else env
    server = ChatServer((host, port), engine, tenant_of=tenant_of,
                        tracer=tracer or engine.tracer)
    server.logger = logger
    server.env = env
    server.metrics = metrics
    server.devices = DeviceRegistry(
        logger=logger, metrics=metrics, device=engine.device,
        rank=mesh.rank if mesh is not None else None)
    wire_engine(engine, name, metrics=metrics, logger=logger,
                tracer=server.tracer, devices=server.devices, slo=slo)
    server.post("/chat", make_chat_handler(engine, tokenizer))
    install_debug_routes(server, engine, name,
                         profiler=_env_bool(env, "PROFILER_ENABLED"),
                         profile_dir=env.get("PROFILER_DIR") or None)
    return server


def _tree_to(tree: dict, dev: torch.device) -> dict:
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def embed_app(params: dict, config: Any, tokenizer: Any = None,
              host: str = "127.0.0.1", port: int = 0, *,
              device: str | torch.device | None = None) -> ChatServer:
    """A server without an engine that answers ``POST /embed``
    (``handlers.make_embed_handler``) with the BERT tree ``params`` of
    ``config``, moved to ``device`` (default: CUDA, or raise);
    ``tokenizer`` defaults to bytes. Call ``serve_forever()`` on it."""
    dev = resolve_device(device)
    params = _tree_to(params, dev)
    server = ChatServer((host, port), None)
    server.post("/embed", make_embed_handler(
        params, config, tokenizer or ByteTokenizer()))
    return server



def asr_app(env: Mapping[str, str] | None = None,
            host: str = "127.0.0.1", port: int = 0, *,
            device: str | torch.device | None = None) -> ChatServer:
    """The ASR worker app (counterpart of ``examples/asr-worker/main.py:
    build_app``) on ``device`` (default: CUDA, or raise): ``MODEL_PATH``,
    a local HF Whisper directory, with ``MODEL_DTYPE`` overriding its
    dtype; else ``MODEL_PRESET`` (default ``tiny_test``), random weights
    from seed 0. One :class:`Transcriber` (``max_batch`` 4, ``max_tokens``
    16, 1 s and 5 s sample buckets, as the example sets them) serves
    ``POST /transcribe`` and an :class:`ASRWorker` that consumes
    ``asr.requests`` from an :class:`InMemoryBroker` and publishes to
    ``asr.results``; the worker runs on its own event loop
    (``server.asr_loop``, a :class:`LoopThread`) from now until
    ``server_close``. The health route lists the transcriber as
    ``whisper`` and the broker as ``pubsub``; ``server.asr_worker`` is
    the worker (its ``transcriber`` and ``pubsub``). Call
    ``serve_forever()`` on it."""
    env = os.environ if env is None else env
    dev = resolve_device(device)
    model_path = env.get("MODEL_PATH", "")
    if model_path:
        dtype_name = env.get("MODEL_DTYPE", "")
        params, model_config = load_whisper_checkpoint(
            model_path,
            dtype=resolve_serving_dtype(dtype_name) if dtype_name else None,
            device=dev)
    else:
        model_config = getattr(WhisperConfig,
                               env.get("MODEL_PRESET", "tiny_test"))()
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        params = whisper_init(model_config, generator, dev)
    transcriber = Transcriber(
        params, model_config,
        ASRConfig(max_batch=4, max_tokens=16, sample_buckets=(16000, 80000)),
        device=dev)
    broker = InMemoryBroker()
    worker = ASRWorker(transcriber, broker)
    server = ChatServer((host, port), None)
    server.post("/transcribe", make_asr_handler(transcriber))
    server.health_checks["whisper"] = transcriber
    server.health_checks["pubsub"] = broker
    server.asr_worker = worker
    server.asr_loop = LoopThread()
    server.asr_loop.start(worker.run())
    server.on_close.append(server.asr_loop.stop)
    return server


def serve_fleet_leader(host: str = "127.0.0.1", port: int = 0, *,
                       coordinator: str = "", host_id: str = "leader",
                       router: Any = None, tokenizer: Any = None,
                       metrics: Manager | None = None,
                       logger: Logger | None = None,
                       tracer: Tracer | None = None,
                       **leader_kw: Any) -> ChatServer:
    """A fleet LEADER's server (counterpart of
    ``App.serve_fleet_leader``): a route table without an engine, with
    the control plane installed (join / heartbeat / leave / leader /
    topology, the federated ``/control/fleet/metrics``, ``/debug/fleet``
    and its events and incidents; its health is the leader's), the
    sweeper running until ``server_close``. ``leader_kw`` go to
    ``ControlPlaneLeader`` (``heartbeat_interval_s``,
    ``eviction_misses``, ``fleet``, ``rank``, ``faults``, ``events``).

    ``router=RouterConfig(...)`` (or True) also makes the leader the
    fleet's front door: ``POST /chat`` and the OpenAI routes proxy to the
    member whose prefix cache best covers the request
    (``FleetRouter``, ``server.leader.router``); ``tokenizer`` is the
    routing tokenizer (default: bytes, right whenever the workers serve
    byte-tokenized models). Call ``serve_forever()`` on it; the leader
    is ``server.leader``."""
    from .control_plane import ControlPlaneLeader
    from .router import FleetRouter, RouterConfig
    metrics = metrics if metrics is not None else Manager()
    logger = logger if logger is not None else Logger()
    server = ChatServer((host, port), None, tracer=tracer)
    server.metrics = metrics
    leader = ControlPlaneLeader(coordinator=coordinator, host_id=host_id,
                                metrics=metrics, logger=logger, **leader_kw)
    leader.install(server)
    leader.router = None
    if router is not None and router is not False:
        config = RouterConfig() if router is True else router
        leader.router = FleetRouter(leader, config, tokenizer=tokenizer,
                                    logger=logger, tracer=server.tracer)
        leader.router.install(server)
    server.leader = leader
    return server


def join_fleet(server: ChatServer, leader_url: str, *, host_id: str,
               address: str = "", **agent_kw: Any):
    """Join ``server`` (a ``build_server`` worker) to the fleet led at
    ``leader_url`` (counterpart of ``App.join_fleet``): a started
    ``WorkerAgent`` heartbeating the engine's gossip health, its flight
    recorder's fleet summary (the prefix digest, goodput, costs, probe
    digests), the server's ``Manager.snapshot`` (device gauges fresh) and
    the engine's event digest, on the server's tracer and logger. An
    empty ``address`` advertises ``ADVERTISE_HOST`` (default 127.0.0.1)
    and the bound port. ``agent_kw`` go to ``WorkerAgent``
    (``heartbeat_interval_s``, ``fleet``, ``faults``, ...). The agent
    stops when the server closes; returns it."""
    from .control_plane import WorkerAgent, engine_fleet_sources
    engine = server.engine
    if not address:
        advertise = os.environ.get("ADVERTISE_HOST") or "127.0.0.1"
        address = f"{advertise}:{server.port}"
    health, summary, _ = engine_fleet_sources(engine)
    agent_kw.setdefault("health_source", health)
    agent_kw.setdefault("summary_source", summary)
    agent_kw.setdefault("metrics_source", server.metrics_snapshot)
    agent_kw.setdefault("metrics", server.metrics)
    agent_kw.setdefault("events", engine.events)
    agent_kw.setdefault("logger", engine.logger)
    agent = WorkerAgent(leader_url, host_id=host_id, address=address,
                        tracer=server.tracer, **agent_kw)
    agent.start()
    server.on_close.append(agent.stop)
    return agent


class _MetricsHandler(BaseHTTPRequestHandler):
    server: "MetricsServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: Any) -> None:
        pass

    def do_GET(self) -> None:  # noqa: N802 — http.server's naming
        path = urlsplit(self.path).path
        metrics = self.server.metrics
        if path == "/metrics":
            metrics.set_gauge("app_uptime_seconds",
                              round(time.time() - self.server.started_at, 1))
            if self.server.devices is not None:
                self.server.devices.publish_metrics()
            # a scraper that asks for OpenMetrics gets the exemplars
            if "application/openmetrics-text" in (
                    self.headers.get("Accept") or ""):
                body = metrics.render_openmetrics().encode()
                ctype = ("application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8")
            else:
                body = metrics.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            status = 200
        elif path == "/.well-known/alive":
            status, body, ctype = 200, b'{"status": "UP"}', "application/json"
        else:
            status, body, ctype = 404, b"not found", "text/plain"
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except _GONE:
            self.close_connection = True


class MetricsServer(ThreadingHTTPServer):
    """The metrics port: ``GET /metrics`` (Prometheus text, or
    OpenMetrics when the scraper's ``Accept`` asks for it) and ``GET
    /.well-known/alive``."""

    daemon_threads = True

    def __init__(self, address: tuple, metrics: Manager,
                 devices: DeviceRegistry | None = None) -> None:
        super().__init__(address, _MetricsHandler)
        self.metrics = metrics
        #: a registry whose gauges are refreshed at every scrape
        self.devices = devices
        self.started_at = time.time()
        if metrics.get("app_uptime_seconds") is None:
            metrics.new_gauge("app_uptime_seconds", "seconds since boot")


def build_metrics_server(metrics: Manager, host: str = "127.0.0.1",
                         port: int = 0,
                         devices: DeviceRegistry | None = None
                         ) -> MetricsServer:
    """Bind the metrics port (0 = any free port); call
    ``serve_forever()`` on it. ``devices``' gauges are refreshed at every
    scrape."""
    return MetricsServer((host, port), metrics, devices)


def main() -> None:
    env = os.environ
    engine, tokenizer, name = app_engine(env)
    host = env.get("HTTP_HOST", "0.0.0.0")
    server = build_server(engine, tokenizer, host=host,
                          port=int(env.get("HTTP_PORT", "8000")), name=name)
    install_openai_routes(server, engine, tokenizer, model=name)
    metrics_server = build_metrics_server(
        server.metrics, host=host, port=int(env.get("METRICS_PORT", "2121")),
        devices=server.devices)
    metrics_thread = threading.Thread(target=metrics_server.serve_forever,
                                      daemon=True)
    metrics_thread.start()
    engine.start()
    print(f"serving {name} on http://{server.server_address[0]}:"
          f"{server.server_address[1]} (POST /chat, /v1/chat/completions, "
          f"/v1/completions; GET /v1/models, /debug/*), metrics on "
          f"http://{metrics_server.server_address[0]}:"
          f"{metrics_server.server_address[1]}/metrics", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        metrics_server.shutdown()
        metrics_server.server_close()
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
