"""Handler execution: the HTTP hot path (the port's copy of
``gofr_tpu/handler.py``).

Mirrors reference pkg/gofr/handler.go:55-113: build a Context, run the
user handler under a request timeout with panic recovery, distinguish
timeout (408) from handler error, then render through the Responder.
Async handlers run on the loop; plain ones, which the port's serving
handlers are, run on the app's executor so they cannot stall the
event loop.

What the port adds, because its engine talks to handlers through a
plain queue and its handlers are plain functions:

- the executor is the app's own (``App.executor``, :func:`handler_pool`)
  and has no cap: each call in flight holds a thread of its own, as
  under ``ChatServer``'s thread per connection, so a request reaches the
  engine's admission however many generations hold threads;
- a ``Stream`` whose iterator is plain is pumped by :class:`ThreadPump`
  on one of those threads, its chunks handed to the loop with
  ``call_soon_threadsafe``; the loop thread never iterates it. The pump
  stops, and closes the iterator (which cancels the engine request it
  streams), once the request's ``client_gone()`` turns true;
- a request timeout (``REQUEST_TIMEOUT``) answers 408 as in JAX, and
  also marks the request gone: the thread cannot be cancelled, but the
  handler's next look at ``ctx.client_gone()`` cancels its engine request
  and frees the slot.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import inspect
import json
import sys
import traceback
from typing import Any, Callable

from .container.container import Container
from .context import Context
from .http.errors import (
    ClientGone,
    ErrorInvalidRoute,
    ErrorMethodNotAllowed,
    ErrorPanicRecovery,
    ErrorRequestTimeout,
    status_and_level_for,
)
from .http.request import BindError, HTTPRequest
from .http.responder import Responder, ResponseData
from .http.response import Stream
from .http.router import Router

HandlerFunc = Callable[[Context], Any]

_FAVICON = bytes.fromhex(
    "89504e470d0a1a0a0000000d494844520000001000000010080600000028cf"
    "6282000000264944415478da63fcffff3f0335803851f9ff47cd1c3573d4cc"
    "51334733473523cd0400ba573b7e1c9b8e1a0000000049454e44ae426082")

#: the end of a pumped iterator
_END = object()


def handler_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The pool plain handlers, plain streams and plain hooks run on. It
    has no cap: a call starts a thread when no idle one is left, so a
    generation that holds its thread to the end never makes another
    request wait for one. What waits and what is refused is the engine
    scheduler's to decide (its lanes, rate limits and ``max_waiting``),
    not this pool's queue."""
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=sys.maxsize, thread_name_prefix="app-handler")


class ThreadPump:
    """An async iterator over a plain iterator that runs on ``executor``:
    each chunk is handed to the loop's queue with
    ``call_soon_threadsafe``. Before each chunk the pump checks
    ``gone()``; once true it stops, closes the iterator on its own thread
    (a generator's cleanup runs there) and ends the async side with
    :class:`ClientGone`, so the server sends no terminating chunk.
    ``aclose()`` (the server's, when a write fails or the connection is
    torn down) calls ``mark_gone``."""

    def __init__(self, iterator: Any, gone: Callable[[], bool],
                 mark_gone: Callable[[], None], executor: Any,
                 loop: asyncio.AbstractEventLoop) -> None:
        self._iterator = iterator
        self._gone = gone
        self._mark_gone = mark_gone
        self._loop = loop
        self._queue: asyncio.Queue = asyncio.Queue()
        ctx = contextvars.copy_context()
        self._future = loop.run_in_executor(executor, ctx.run, self._run)

    def _put(self, item: tuple) -> bool:
        try:
            self._loop.call_soon_threadsafe(self._queue.put_nowait, item)
            return True
        except RuntimeError:  # the loop is closed: nobody reads on
            return False

    def _run(self) -> None:
        chunks = iter(self._iterator)
        end: tuple = (_END, None)
        try:
            for chunk in chunks:
                if self._gone():
                    end = (_END, ClientGone())
                    break
                if not self._put((chunk, None)):
                    break
        except BaseException as exc:  # noqa: BLE001 — handed to the loop
            end = (_END, exc)
        finally:
            close = getattr(chunks, "close", None)
            if close is not None:
                close()
            self._put(end)

    def __aiter__(self) -> "ThreadPump":
        return self

    async def __anext__(self) -> Any:
        chunk, exc = await self._queue.get()
        if chunk is _END:
            if exc is not None:
                raise exc
            raise StopAsyncIteration
        return chunk

    async def aclose(self) -> None:
        self._mark_gone()


async def run_handler(handler: HandlerFunc, ctx: Context,
                      timeout: float | None = None,
                      executor: Any = None) -> Any:
    """Run a user handler (async on the loop, plain on ``executor``) with
    an optional timeout. A timeout or a cancellation also marks the
    request gone, for a plain handler still running on its thread."""
    if inspect.iscoroutinefunction(handler):
        coro = handler(ctx)
    else:
        loop = asyncio.get_running_loop()
        # copy_context so contextvars (the span, trace ids for logging)
        # survive the hop into the worker thread
        cvs = contextvars.copy_context()
        coro = loop.run_in_executor(executor, cvs.run, handler, ctx)
    try:
        if timeout is not None and timeout > 0:
            return await asyncio.wait_for(coro, timeout)
        return await coro
    except (asyncio.TimeoutError, asyncio.CancelledError):
        ctx.mark_gone()
        raise


def build_core_handler(router: Router, container: Container,
                       request_timeout: float | None = None,
                       executor: Any = None) -> Callable:
    """The innermost server handler: route -> context -> execute -> respond."""
    responder = Responder()

    async def core(request: HTTPRequest) -> ResponseData:
        matched = router.match(request.method, request.path)

        # static mounts serve paths no dynamic route claims
        # (reference gofr.go:314-339); dynamic routes win on overlap so a
        # '/' mount cannot shadow the API. A mount's own favicon.ico wins
        # over the built-in placeholder; a mount 404 for /favicon.ico
        # falls through to the placeholder.
        if matched is None:
            static = router.match_static(request.path)
            is_favicon = (request.path == "/favicon.ico"
                          and request.method in ("GET", "HEAD"))
            if static is not None and not (is_favicon and static[0] != "200"):
                status, content, ctype = static
                return ResponseData(status=int(status), body=content,
                                    content_type=ctype)
            if is_favicon:
                return ResponseData(status=200, body=_FAVICON,
                                    content_type="image/png")

        if matched is None:
            methods = router.registered_methods_for(request.path)
            if methods:  # path exists with other verbs -> 405
                err = ErrorMethodNotAllowed()
                response = responder.respond(None, err, request.method)
                response.headers["Allow"] = ", ".join(methods)
                return response
            # catch-all 404 listing registered routes (reference handler.go:137)
            err = ErrorInvalidRoute()
            response = responder.respond(None, err, request.method)
            body = json.loads(response.body)
            body["error"]["registered_routes"] = router.registered_paths()
            response.body = json.dumps(body).encode()
            return response

        route, path_params = matched
        request.set_path_params(path_params)
        # metrics middleware labels by route pattern, not raw path,
        # to keep label cardinality bounded
        request.matched_pattern = route.pattern
        ctx = Context(request=request, container=container)
        auth_info = getattr(request, "auth_info", None)
        if auth_info:  # set by auth middleware (reference context.go:121)
            ctx.set_auth_info(auth_info)

        try:
            result = await run_handler(route.handler, ctx, request_timeout,
                                       executor)
            error = None
        except asyncio.TimeoutError:
            result, error = None, ErrorRequestTimeout()
        except asyncio.CancelledError:
            raise
        except BindError as exc:
            result, error = None, exc
        except Exception as exc:  # panic recovery (reference handler.go:141)
            result, error = None, exc
            if not hasattr(exc, "status_code"):
                container.logger.error(
                    f"panic in handler {request.method} {request.path}: {exc!r}",
                    stack=traceback.format_exc())
                error = ErrorPanicRecovery()

        if error is not None:
            _, level = status_and_level_for(error)
            ctx.logger.log_at(level, f"{request.method} {request.path}: {error}")
        elif isinstance(result, Stream) and not hasattr(result.iterator,
                                                        "__aiter__"):
            result = Stream(ThreadPump(result.iterator, ctx.client_gone,
                                       ctx.mark_gone, executor,
                                       asyncio.get_running_loop()),
                            result.content_type, result.headers)
        return responder.respond(result, error, request.method)

    return core
