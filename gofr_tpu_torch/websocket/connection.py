"""WSConnection: message-level API over the frame codec (the port's copy
of ``gofr_tpu/websocket/connection.py``).

The per-connection object the framework hands to handlers (via
``ctx.write_message_to_socket``) and registers in the Manager —
reference pkg/gofr/websocket/websocket.go Connection. Handles
fragmentation reassembly, ping/pong, and the close handshake; one
writer lock serializes concurrent sends.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Any

from .frames import (
    CLOSE_NORMAL,
    CLOSE_PROTOCOL_ERROR,
    OP_BINARY,
    OP_CLOSE,
    OP_CONT,
    OP_PING,
    OP_PONG,
    OP_TEXT,
    MAX_FRAME_BYTES,
    WSProtocolError,
    close_payload,
    encode_frame,
    parse_close,
    read_frame,
)


@dataclass
class WSMessage:
    data: bytes
    is_text: bool

    def text(self) -> str:
        return self.data.decode("utf-8", "replace")


class WSConnection:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *, is_client: bool = False,
                 conn_id: str = "") -> None:
        self.reader = reader
        self.writer = writer
        self.is_client = is_client  # clients mask, servers don't
        self.conn_id = conn_id
        self.closed = False
        self.close_code: int | None = None
        self._send_lock = asyncio.Lock()

    # ---------------------------------------------------------------- send
    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        async with self._send_lock:
            self.writer.write(encode_frame(opcode, payload,
                                           mask=self.is_client))
            await self.writer.drain()

    async def send(self, data: Any) -> None:
        """str -> text frame; bytes -> binary; anything else -> JSON text."""
        if isinstance(data, (bytes, bytearray)):
            await self._send_frame(OP_BINARY, bytes(data))
        elif isinstance(data, str):
            await self._send_frame(OP_TEXT, data.encode())
        else:
            await self._send_frame(OP_TEXT, json.dumps(data).encode())

    async def ping(self, payload: bytes = b"") -> None:
        await self._send_frame(OP_PING, payload)

    async def close(self, code: int = CLOSE_NORMAL, reason: str = "") -> None:
        if self.closed:
            return
        self.closed = True
        self.close_code = code
        try:
            await self._send_frame(OP_CLOSE, close_payload(code, reason))
        except (ConnectionError, RuntimeError):
            pass
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, RuntimeError):
            pass

    # ---------------------------------------------------------------- recv
    async def recv(self) -> WSMessage | None:
        """Next data message; None once the connection is closed.

        Control frames are handled inline: pings answered, close echoed.
        Fragmented messages are reassembled.
        """
        buffer = bytearray()
        first_opcode: int | None = None
        while True:
            if self.closed:
                return None
            try:
                frame = await read_frame(self.reader,
                                         require_mask=not self.is_client)
            except WSProtocolError as exc:
                await self.close(exc.code, str(exc))
                return None
            if frame is None:  # EOF
                self.closed = True
                return None

            if frame.opcode == OP_CLOSE:
                code, _reason = parse_close(frame.payload)
                self.close_code = code
                if not self.closed:
                    self.closed = True
                    try:
                        await self._send_frame(OP_CLOSE,
                                               close_payload(code))
                    except (ConnectionError, RuntimeError):
                        pass
                    try:
                        self.writer.close()
                    except RuntimeError:
                        pass
                return None
            if frame.opcode == OP_PING:
                try:
                    await self._send_frame(OP_PONG, frame.payload)
                except (ConnectionError, RuntimeError):
                    pass
                continue
            if frame.opcode == OP_PONG:
                continue

            if frame.opcode in (OP_TEXT, OP_BINARY):
                if first_opcode is not None:
                    await self.close(CLOSE_PROTOCOL_ERROR,
                                     "interleaved data frames")
                    return None
                first_opcode = frame.opcode
            elif frame.opcode == OP_CONT:
                if first_opcode is None:
                    await self.close(CLOSE_PROTOCOL_ERROR,
                                     "orphan continuation")
                    return None
            else:
                await self.close(CLOSE_PROTOCOL_ERROR,
                                 f"unknown opcode {frame.opcode}")
                return None

            buffer += frame.payload
            if len(buffer) > MAX_FRAME_BYTES:
                await self.close(1009, "message too large")
                return None
            if frame.fin:
                return WSMessage(data=bytes(buffer),
                                 is_text=first_opcode == OP_TEXT)
