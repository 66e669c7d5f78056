"""Shared lifecycle for HTTP-protocol mini servers.

The Influx and S3 mini servers both serve an HTTP wire surface from
sync test code: this base runs the framework's asyncio
:class:`~gofr_tpu_torch.http.server.HTTPServer` on a daemon thread so
blocking clients (urllib) can call it, with an idempotent close that
shuts the server down and stops the loop. Subclasses implement
:meth:`handle` returning ``(status, body bytes, content_type)``.

The port's copy of ``gofr_tpu/datasource/miniserver.py``.
"""

from __future__ import annotations

import threading
from typing import Any


class ThreadedHTTPMiniServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self._loop: Any = None
        self._server: Any = None
        self._loop_thread: threading.Thread | None = None

    def handle(self, request) -> tuple[int, bytes, str]:  # pragma: no cover
        raise NotImplementedError

    def start(self) -> None:
        import asyncio

        from ..http.responder import ResponseData
        from ..http.server import HTTPServer

        async def handler(request) -> ResponseData:
            status, body, ctype = self.handle(request)
            return ResponseData(status=status, body=body,
                                content_type=ctype)

        ready = threading.Event()

        def run() -> None:
            loop = asyncio.new_event_loop()
            self._loop = loop
            server = HTTPServer(handler, host=self.host, port=self.port)
            loop.run_until_complete(server.start())
            self._server = server
            self.port = server.bound_port
            ready.set()
            loop.run_forever()

        self._loop_thread = threading.Thread(
            target=run, daemon=True, name=type(self).__name__)
        self._loop_thread.start()
        if not ready.wait(10):
            raise RuntimeError(f"{type(self).__name__} failed to start")

    def close(self) -> None:
        import asyncio
        if self._loop is None:
            return

        async def stop() -> None:
            if self._server is not None:
                await self._server.shutdown()

        try:
            asyncio.run_coroutine_threadsafe(stop(), self._loop) \
                .result(timeout=5)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
        self._loop = None  # double-close is a no-op
