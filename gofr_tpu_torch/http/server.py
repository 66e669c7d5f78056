"""Asyncio HTTP/1.1 server: parsing, keep-alive, chunked streaming, upgrade
(the port's copy of ``gofr_tpu/http/server.py``).

The transport under the framework's HTTP layer — the role net/http plays
for the reference (pkg/gofr/http_server.go:36-58). Built directly on
asyncio streams so the serving hot path (continuous-batching /chat
handlers) gets an event loop we control: no thread-per-request, SSE
token streaming via chunked transfer, and a websocket upgrade hook.

The request pipeline is an onion of async middleware around a core
``handle(request) -> ResponseData`` — same order as the reference:
tracer -> logging -> CORS -> metrics -> auth -> websocket upgrade
(reference http_server.go:36-41).

The port's addition: every request carries ``client_gone()``, true once
its client has left (EOF or an error on the connection, a failed write)
or the app gave up on it (``mark_gone()``: the request timeout). A
serving handler that runs on a worker thread polls it, and cancels its
engine request when it turns true; the thread that pumps a plain
``Stream`` iterator (``handler.ThreadPump``) checks it before each
chunk.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Awaitable, Callable

from .request import HTTPRequest
from .responder import ResponseData

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024

Handler = Callable[[HTTPRequest], Awaitable[ResponseData]]
Middleware = Callable[[Handler], Handler]

_STATUS_REASONS = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    206: "Partial Content", 301: "Moved Permanently", 302: "Found",
    303: "See Other", 304: "Not Modified", 400: "Bad Request",
    401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout", 409: "Conflict",
    413: "Payload Too Large", 426: "Upgrade Required",
    429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    499: "Client Closed Request", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}


class HTTPProtocolError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


class StreamInterrupted(Exception):
    """A response stream iterator failed mid-flight; the connection must
    be torn down without the chunked terminator."""


async def read_request(reader: asyncio.StreamReader,
                       client_addr: str = "") -> HTTPRequest | None:
    """Parse one HTTP/1.1 request off the stream. None on clean EOF."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as exc:
        if not exc.partial:
            return None
        raise HTTPProtocolError(400, "truncated request head") from exc
    except asyncio.LimitOverrunError as exc:
        raise HTTPProtocolError(431, "headers too large") from exc
    if len(head) > MAX_HEADER_BYTES:
        raise HTTPProtocolError(431, "headers too large")

    lines = head.decode("latin-1").split("\r\n")
    request_line = lines[0]
    parts = request_line.split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1"):
        raise HTTPProtocolError(400, f"malformed request line: {request_line!r}")
    method, target, _version = parts

    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        if ":" not in line:
            raise HTTPProtocolError(400, f"malformed header: {line!r}")
        key, _, value = line.partition(":")
        headers[key.strip().lower()] = value.strip()

    body = b""
    if "content-length" in headers:
        try:
            length = int(headers["content-length"])
        except ValueError as exc:
            raise HTTPProtocolError(400, "bad content-length") from exc
        if length > MAX_BODY_BYTES:
            raise HTTPProtocolError(413, "body too large")
        if length:
            body = await reader.readexactly(length)
    elif headers.get("transfer-encoding", "").lower() == "chunked":
        chunks = []
        total = 0
        while True:
            try:
                size_line = (await reader.readline()).strip()
            except ValueError as exc:  # LimitOverrunError wrapped: huge line
                raise HTTPProtocolError(400, "bad chunk framing") from exc
            try:
                size = int(size_line.split(b";")[0], 16)
            except ValueError as exc:
                raise HTTPProtocolError(400, "bad chunk size") from exc
            if size == 0:
                await reader.readline()  # trailing CRLF
                break
            total += size
            if total > MAX_BODY_BYTES:
                raise HTTPProtocolError(413, "body too large")
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)  # chunk CRLF
        body = b"".join(chunks)

    return HTTPRequest(method=method, target=target, headers=headers,
                       body=body, client_addr=client_addr)


def _render_head(status: int, headers: dict[str, str]) -> bytes:
    reason = _STATUS_REASONS.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines.extend(f"{k}: {v}" for k, v in headers.items())
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def write_response(writer: asyncio.StreamWriter, response: ResponseData,
                         *, head_only: bool = False,
                         keep_alive: bool = True) -> None:
    headers = {"Server": "gofr-tpu",
               "Connection": "keep-alive" if keep_alive else "close"}
    headers.update(response.headers)

    if response.stream is not None and not head_only:
        headers.setdefault("Content-Type", response.content_type)
        headers.setdefault("Cache-Control", "no-cache")
        headers["Transfer-Encoding"] = "chunked"
        completed = False
        try:
            # the head write sits INSIDE the try: a client that is
            # already gone fails right here, and the finally must
            # still close the producer
            writer.write(_render_head(response.status, headers))
            await writer.drain()
            async for chunk in response.stream:
                if isinstance(chunk, str):
                    chunk = chunk.encode()
                elif not isinstance(chunk, (bytes, bytearray)):
                    import json
                    chunk = (json.dumps(chunk) + "\n").encode()
                if not chunk:
                    continue
                writer.write(f"{len(chunk):x}\r\n".encode() + bytes(chunk) + b"\r\n")
                await writer.drain()
            completed = True
        except Exception as exc:
            # Do NOT send the terminal chunk: the client must see the
            # truncation instead of mistaking a partial stream for a
            # complete response.
            raise StreamInterrupted(str(exc)) from exc
        finally:
            if not completed:
                # close the iterator NOW — on errors AND cancellation
                # (server shutdown) — so stream producers (the serving
                # engine) cancel their work instead of waiting for
                # garbage collection
                closer = getattr(response.stream, "aclose", None)
                if closer is not None:
                    try:
                        await closer()
                    except BaseException:  # never mask the original
                        pass
        writer.write(b"0\r\n\r\n")
        await writer.drain()
        return

    body = b"" if (head_only or response.status == 204) else response.body
    if response.status != 204:
        headers.setdefault("Content-Type", response.content_type)
        headers["Content-Length"] = str(len(response.body))
    writer.write(_render_head(response.status, headers) + body)
    await writer.drain()


def watch_client(request: HTTPRequest, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
    """Give ``request`` its ``client_gone()`` and ``mark_gone()``: gone
    once marked, or once the connection reads EOF, holds an error or is
    closing. Thread-safe reads only: a worker thread polls it."""
    gone = threading.Event()

    def client_gone() -> bool:
        return (gone.is_set() or reader.at_eof()
                or reader.exception() is not None or writer.is_closing())

    request.client_gone = client_gone
    request.mark_gone = gone.set


def make_ssl_context(cert_file: str, key_file: str):
    """Server-side TLS context from a PEM cert/key pair — the
    ListenAndServeTLS analog (reference pkg/gofr/http_server.go:82)."""
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile=cert_file, keyfile=key_file)
    return ctx


class HTTPServer:
    """Owns the listen socket and the per-connection loop. Pass
    ``ssl_context`` (see :func:`make_ssl_context`) to serve HTTPS."""

    def __init__(self, handler: Handler, *, host: str = "0.0.0.0", port: int = 8000,
                 logger=None, ssl_context=None) -> None:
        self.handler = handler
        self.host = host
        self.port = port
        self.logger = logger
        self.ssl_context = ssl_context
        self._server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self._conn_tasks: set[asyncio.Task] = set()
        self._busy_tasks: set[asyncio.Task] = set()  # mid-request

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port,
            limit=MAX_HEADER_BYTES, ssl=self.ssl_context)
        if self.logger:
            scheme = "https" if self.ssl_context else "http"
            self.logger.info(
                f"HTTP server listening on {scheme}://{self.host}:{self.port}")

    @property
    def bound_port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.port

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, grace_s: float = 2.0) -> None:
        """Stop accepting; idle keep-alive connections cancel
        immediately, connections mid-request get ``grace_s`` to drain,
        and stragglers are cancelled — ``wait_closed`` on 3.12+ waits
        for EVERY connection handler, so a wedged stream would
        otherwise hang shutdown indefinitely. Cancellation lands at
        the handler's awaits, whose finally-blocks close stream
        producers (the serving engine cancels abandoned requests)."""
        if self._server is not None:
            self._server.close()
            # idle connections are parked in read_request with no work
            # in flight: nothing to drain, cancel now
            for task in list(self._conn_tasks - self._busy_tasks):
                task.cancel()
            busy = set(self._busy_tasks)
            if busy:
                await asyncio.wait(busy, timeout=grace_s)
            for task in list(self._conn_tasks):
                task.cancel()
            for writer in list(self._writers):
                try:
                    writer.close()
                except Exception:
                    pass
            try:
                # hijacked websocket transports are closed by the WS
                # manager, not tracked here — never let a straggler
                # hold wait_closed forever
                await asyncio.wait_for(self._server.wait_closed(),
                                       timeout=max(grace_s, 2.0))
            except asyncio.TimeoutError:
                if self.logger:
                    self.logger.warn(
                        "listener closed with connections still "
                        "terminating")
            self._server = None

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        client_addr = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) else ""
        took_over = False
        self._writers.add(writer)
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        try:
            while True:
                try:
                    request = await read_request(reader, client_addr)
                except HTTPProtocolError as exc:
                    import json
                    await write_response(writer, ResponseData(
                        status=exc.status,
                        body=json.dumps(
                            {"error": {"message": str(exc)}}).encode()),
                        keep_alive=False)
                    break
                if request is None:
                    break
                watch_client(request, reader, writer)
                if task is not None:  # a request is now in flight
                    self._busy_tasks.add(task)

                if "upgrade" in request.headers.get("connection", "").lower():
                    # hand the raw socket to the chain: the innermost
                    # websocket middleware performs the handshake AFTER
                    # every other middleware (auth included) has passed
                    request.ws_reader = reader
                    request.ws_writer = writer
                try:
                    response = await self.handler(request)
                except Exception as exc:  # middleware failed catastrophically
                    if self.logger:
                        self.logger.error(f"unhandled server error: {exc!r}")
                    response = ResponseData(
                        status=500,
                        body=b'{"error": {"message": "internal server error"}}')
                if getattr(response, "hijacked", False):
                    # a websocket message loop now owns reader/writer;
                    # do not write a response or close the socket
                    took_over = True
                    return
                keep_alive = request.headers.get("connection", "").lower() != "close"
                try:
                    await write_response(writer, response,
                                         head_only=request.method == "HEAD",
                                         keep_alive=keep_alive)
                except StreamInterrupted as exc:
                    request.mark_gone()
                    if self.logger:
                        self.logger.error(f"stream aborted mid-response: {exc}")
                    break
                except (ConnectionResetError, BrokenPipeError):
                    request.mark_gone()
                    raise
                finally:
                    if task is not None:  # back to idle keep-alive
                        self._busy_tasks.discard(task)
                if not keep_alive:
                    break
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            # hijacked (websocket) connections are owned by their
            # message loop now — ws_manager closes them at shutdown
            self._writers.discard(writer)
            if task is not None:
                self._conn_tasks.discard(task)
                self._busy_tasks.discard(task)
            if not took_over:
                try:
                    writer.close()
                    await writer.wait_closed()
                except (ConnectionResetError, BrokenPipeError):
                    pass


def chain(middlewares: list[Middleware], core: Handler) -> Handler:
    """Compose the middleware onion; first in list is outermost."""
    handler = core
    for mw in reversed(middlewares):
        handler = mw(handler)
    return handler
