"""Outbound websocket connections: client handshake + reconnecting
service (reference pkg/gofr/websocket.go:52-98 AddWSService; the port's
copy of ``gofr_tpu/websocket/service.py``)."""

from __future__ import annotations

import asyncio
import base64
import os
from typing import Any, Awaitable, Callable
from urllib.parse import urlsplit

from .connection import WSConnection, WSMessage
from .frames import accept_key


class WSHandshakeError(Exception):
    pass


async def connect(url: str, *, headers: dict[str, str] | None = None,
                  timeout: float = 10.0) -> WSConnection:
    """Open a client websocket connection (RFC 6455 opening handshake)."""
    split = urlsplit(url)
    if split.scheme not in ("ws", "wss"):
        raise WSHandshakeError(f"unsupported scheme {split.scheme!r}")
    host = split.hostname or "localhost"
    port = split.port or (443 if split.scheme == "wss" else 80)
    path = split.path or "/"
    if split.query:
        path += "?" + split.query

    ssl_ctx = None
    if split.scheme == "wss":
        import ssl
        ssl_ctx = ssl.create_default_context()
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port, ssl=ssl_ctx), timeout)

    key = base64.b64encode(os.urandom(16)).decode()
    try:
        lines = [f"GET {path} HTTP/1.1", f"Host: {host}:{port}",
                 "Upgrade: websocket", "Connection: Upgrade",
                 f"Sec-WebSocket-Key: {key}", "Sec-WebSocket-Version: 13"]
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
        await writer.drain()

        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout)
        response_lines = head.decode("latin-1").split("\r\n")
        status_parts = response_lines[0].split(" ", 2)
        if len(status_parts) < 2 or status_parts[1] != "101":
            raise WSHandshakeError(
                f"handshake rejected: {response_lines[0]}")
        response_headers = {}
        for line in response_lines[1:]:
            if ":" in line:
                k, _, v = line.partition(":")
                response_headers[k.strip().lower()] = v.strip()
        if response_headers.get("sec-websocket-accept") != accept_key(key):
            raise WSHandshakeError("bad Sec-WebSocket-Accept")
    except BaseException:  # incl. TimeoutError: never leak the socket
        writer.close()
        raise
    return WSConnection(reader, writer, is_client=True, conn_id=key)


class WSService:
    """A named outbound connection that reconnects with backoff.

    ``send`` raises ConnectionError while disconnected; an optional
    ``on_message`` callback receives inbound messages.
    """

    def __init__(self, name: str, url: str, *,
                 headers: dict[str, str] | None = None,
                 retry_interval: float = 5.0, logger: Any = None,
                 on_message: Callable[[WSMessage], Awaitable[None] | None] | None = None) -> None:
        self.name = name
        self.url = url
        self.headers = headers
        self.retry_interval = retry_interval
        self.logger = logger
        self.on_message = on_message
        self.conn: WSConnection | None = None
        self._task: asyncio.Task | None = None
        self._stopped = False
        self._connected = asyncio.Event()

    @property
    def connected(self) -> bool:
        return self.conn is not None and not self.conn.closed

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._maintain())

    async def wait_connected(self, timeout: float = 10.0) -> bool:
        try:
            await asyncio.wait_for(self._connected.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def _maintain(self) -> None:
        """Connect; on drop, retry every ``retry_interval``
        (reference websocket.go:77-98)."""
        while not self._stopped:
            try:
                self.conn = await connect(self.url, headers=self.headers)
                self._connected.set()
                if self.logger:
                    self.logger.info(f"ws service {self.name}: connected")
                while not self._stopped:
                    message = await self.conn.recv()
                    if message is None:
                        break
                    if self.on_message is not None:
                        result = self.on_message(message)
                        if result is not None and hasattr(result, "__await__"):
                            await result
            except asyncio.CancelledError:
                return
            except Exception as exc:
                if self.logger:
                    self.logger.warn(f"ws service {self.name}: {exc!r}")
            self._connected.clear()
            if self.conn is not None:  # release the old transport
                try:
                    await self.conn.close(1001, "reconnecting")
                except (ConnectionError, RuntimeError):
                    pass
                self.conn = None
            if self._stopped:
                return
            await asyncio.sleep(self.retry_interval)

    async def send(self, data: Any) -> None:
        if not self.connected:
            raise ConnectionError(f"ws service {self.name} not connected")
        assert self.conn is not None
        await self.conn.send(data)

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
        if self.conn is not None:
            await self.conn.close(1001, "client shutting down")
            self.conn = None
