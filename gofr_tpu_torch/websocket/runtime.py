"""Server-side websocket runtime: upgrade middleware + message loop (the
port's copy of ``gofr_tpu/websocket/runtime.py``).

The glue between the HTTP server and user handlers — reference
pkg/gofr/websocket.go:30-49 (App.WebSocket registers a route whose
handler loop calls the user Handler per message, with ``ctx.bind``
reading a frame) and middleware/web_socket.go:14-37 (upgrade + Manager
registration keyed by Sec-WebSocket-Key).

The upgrade is the INNERMOST middleware — exactly the reference's
ordering (http_server.go:36-41: trace → log → CORS → metrics → auth →
WS upgrade) — so every installed middleware, including user middleware
and auth, runs before the handshake. A successful handshake returns a
101 response marked ``hijacked``: the server then leaves the socket to
the message loop.

What the port changes: a plain (non-``async``) handler runs on the app's
pool (``App.executor``, ``handler.handler_pool``), as plain HTTP
handlers do, never on the loop's thread, so a handler that waits on a
generation stalls no other socket; a coroutine handler runs on the loop
(``ctx.write_message_to_socket`` is a coroutine, so streaming handlers
are ``async def``). Each message's request answers ``client_gone()``:
true once the socket is closed (or its write side failed) or the
handler's run was cancelled, so a handler streaming a generation
(``handler.ThreadPump`` with ``ctx.client_gone`` / ``ctx.mark_gone``)
cancels its engine request when the client leaves, and ``close_all``
at shutdown does the same.
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import json
import threading
from typing import Any, Mapping

from ..http.request import HTTPRequest, bind_dataclass
from ..http.responder import ResponseData
from .connection import WSConnection, WSMessage
from .frames import accept_key

# strong refs: the event loop only weakly references tasks, so
# per-connection loops must be anchored or GC can kill live sockets
_LOOP_TASKS: set[asyncio.Task] = set()


class WSRequest:
    """Request implementation wrapping one inbound frame: ``bind``
    parses the frame payload, params come from the upgrade request."""

    def __init__(self, upgrade: HTTPRequest, message: WSMessage,
                 path_params: Mapping[str, str],
                 conn: WSConnection | None = None) -> None:
        self._upgrade = upgrade
        self.message = message
        self._path_params = dict(path_params)
        self._conn = conn
        self._gone = threading.Event()

    @property
    def headers(self) -> dict[str, str]:
        """The upgrade request's headers, names lower-cased."""
        return getattr(self._upgrade, "headers", None) or {}

    def client_gone(self) -> bool:
        """The socket is closed, its transport is closing, or this
        message's run was given up (:meth:`mark_gone`)."""
        if self._gone.is_set():
            return True
        conn = self._conn
        if conn is not None and (conn.closed or conn.writer.is_closing()):
            return True
        gone = getattr(self._upgrade, "client_gone", None)
        return bool(gone()) if gone is not None else False

    def mark_gone(self) -> None:
        self._gone.set()

    def param(self, key: str) -> str:
        return self._upgrade.param(key)

    def params(self, key: str) -> list[str]:
        return self._upgrade.params(key)

    def path_param(self, key: str) -> str:
        return self._path_params.get(key, "")

    def host_name(self) -> str:
        return self._upgrade.host_name()

    def header(self, key: str) -> str:
        return self._upgrade.header(key)

    def bind(self, target: Any = None) -> Any:
        """Frame payload -> str, parsed JSON, or bound dataclass."""
        if not self.message.is_text:
            return bytes(self.message.data)
        text = self.message.text()
        if target is str or (target is None and not _looks_like_json(text)):
            return text
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            if target is None:
                return text
            raise
        if target is None or not isinstance(target, type):
            return data
        import dataclasses
        if dataclasses.is_dataclass(target) and isinstance(data, Mapping):
            return bind_dataclass(data, target)
        return data


def _looks_like_json(text: str) -> bool:
    stripped = text.lstrip()
    return stripped[:1] in ("{", "[", '"') or stripped in ("true", "false",
                                                           "null") \
        or stripped[:1].isdigit() or stripped[:1] == "-"


def make_ws_middleware(ws_router, container, logger, executor=None):
    """The innermost middleware: performs the RFC 6455 handshake for
    matching requests that made it through the rest of the chain.
    ``executor``: where plain handlers run (the app's pool)."""

    def mw(next_handler):
        async def wrapped(request: HTTPRequest) -> ResponseData:
            if request.headers.get("upgrade", "").lower() != "websocket":
                return await next_handler(request)
            matched = ws_router.match("WS", request.path)
            if matched is None:
                return await next_handler(request)
            writer = getattr(request, "ws_writer", None)
            reader = getattr(request, "ws_reader", None)
            if writer is None or reader is None:
                # transport that can't hand over the socket (tests
                # calling the chain directly): plain route answers
                return await next_handler(request)

            key = request.headers.get("sec-websocket-key", "")
            if not key:
                return await next_handler(request)  # route answers 426
            if request.headers.get("sec-websocket-version", "") != "13":
                # RFC 6455 4.2.2: advertise the version we speak
                return ResponseData(
                    status=426, body=b"",
                    headers={"Sec-WebSocket-Version": "13"})

            route, path_params = matched
            headers = ["HTTP/1.1 101 Switching Protocols",
                       "Upgrade: websocket", "Connection: Upgrade",
                       f"Sec-WebSocket-Accept: {accept_key(key)}"]
            writer.write(("\r\n".join(headers) + "\r\n\r\n").encode())
            await writer.drain()

            conn = WSConnection(reader, writer, conn_id=key)
            if container.ws_manager is not None:
                container.ws_manager.add(key, conn)
            task = asyncio.ensure_future(_message_loop(
                route.handler, request, conn, path_params, container,
                logger, executor))
            _LOOP_TASKS.add(task)
            task.add_done_callback(_LOOP_TASKS.discard)

            response = ResponseData(status=101, body=b"")
            response.hijacked = True  # server: don't write, don't close
            return response
        return wrapped
    return mw


async def _run(handler, ctx, executor) -> Any:
    """A coroutine handler on the loop, a plain one on ``executor`` (with
    this task's context: the span, the trace ids)."""
    if inspect.iscoroutinefunction(handler):
        return await handler(ctx)
    result = await asyncio.get_running_loop().run_in_executor(
        executor, contextvars.copy_context().run, handler, ctx)
    if inspect.isawaitable(result):
        result = await result
    return result


async def _message_loop(handler, upgrade_request: HTTPRequest,
                        conn: WSConnection, path_params, container,
                        logger, executor=None) -> None:
    """Per-message handler dispatch (reference websocket.go:100-117)."""
    from ..context import Context
    try:
        while True:
            message = await conn.recv()
            if message is None:
                break
            ctx = Context(request=WSRequest(upgrade_request, message,
                                            path_params, conn),
                          container=container)
            ctx._ws_conn = conn
            auth_info = getattr(upgrade_request, "auth_info", None)
            if auth_info:
                ctx.set_auth_info(auth_info)
            try:
                result = await _run(handler, ctx, executor)
                if result is not None:
                    await conn.send(result)
            except (ConnectionError, asyncio.CancelledError):
                # the socket failed or the loop is being torn down: a
                # handler still streaming (its pump on a pool thread)
                # sees client_gone() and cancels its engine request
                ctx.mark_gone()
                raise
            except Exception as exc:  # panic recovery: keep the conn
                logger.error(f"ws handler error on {upgrade_request.path}: "
                             f"{exc!r}")
                # mirror the HTTP panic policy (handler.go:141): only
                # errors that declare a status/message are client-visible
                if hasattr(exc, "status_code"):
                    visible = str(exc) or exc.__class__.__name__
                else:
                    visible = "internal server error"
                try:
                    await conn.send({"error": visible})
                except (ConnectionError, RuntimeError):
                    break
    except (ConnectionError, asyncio.CancelledError):
        pass
    finally:
        if container.ws_manager is not None:
            container.ws_manager.remove(conn.conn_id)
        if not conn.closed:
            await conn.close()
