"""Connection manager: live server-side connections keyed by
``Sec-WebSocket-Key`` (reference pkg/gofr/websocket/websocket.go
Manager + middleware/web_socket.go:14-37 registration; the port's copy
of ``gofr_tpu/websocket/manager.py``)."""

from __future__ import annotations

import asyncio
from typing import Any, Iterable

from .connection import WSConnection


class WSManager:
    SEND_TIMEOUT = 5.0

    def __init__(self) -> None:
        self._connections: dict[str, WSConnection] = {}
        self._serial = 0

    def add(self, key: str, conn: WSConnection) -> str:
        """Register; returns the key actually used. The client-supplied
        Sec-WebSocket-Key is attacker-controlled, so duplicates get a
        server-side suffix instead of evicting the existing entry."""
        if key in self._connections:
            self._serial += 1
            key = f"{key}#{self._serial}"
            conn.conn_id = key
        self._connections[key] = conn
        return key

    def remove(self, key: str) -> None:
        self._connections.pop(key, None)

    def connection(self, key: str) -> WSConnection | None:
        return self._connections.get(key)

    def keys(self) -> list[str]:
        return list(self._connections)

    def __len__(self) -> int:
        return len(self._connections)

    async def send_to(self, key: str, data: Any) -> bool:
        conn = self._connections.get(key)
        if conn is None or conn.closed:
            return False
        await conn.send(data)
        return True

    async def broadcast(self, data: Any,
                        exclude: Iterable[str] = ()) -> int:
        """Concurrent best-effort fan-out with a per-connection timeout
        (one stalled client must not block the rest); returns the number
        of sends that worked."""
        skip = set(exclude)
        targets = [conn for key, conn in list(self._connections.items())
                   if key not in skip and not conn.closed]

        async def one(conn: WSConnection) -> bool:
            # CancelledError deliberately NOT caught: cancelling the
            # broadcasting task must unwind it, not be counted as a miss
            try:
                await asyncio.wait_for(conn.send(data), self.SEND_TIMEOUT)
                return True
            except (ConnectionError, RuntimeError, asyncio.TimeoutError):
                return False

        results = await asyncio.gather(*(one(c) for c in targets))
        return sum(results)

    async def close_all(self) -> None:
        async def one(conn: WSConnection) -> None:
            try:
                await asyncio.wait_for(
                    conn.close(1001, "server shutting down"),
                    self.SEND_TIMEOUT)
            except (ConnectionError, RuntimeError, asyncio.TimeoutError):
                pass
        await asyncio.gather(*(one(c)
                               for c in list(self._connections.values())))
        self._connections.clear()
