"""NATS backend: a core-protocol wire client plus an in-process mini
server for hermetic tests.

The reference ships a NATS JetStream module (datasource/pubsub/nats,
3,446 LoC) behind the common pub/sub interface
(datasource/pubsub/interface.go:11-31). This client speaks the NATS
core text protocol (INFO/CONNECT/PUB/SUB/MSG/PING/PONG) over asyncio
TCP — no driver dependency — and maps the framework's consumer groups
onto NATS queue groups. Core NATS is at-most-once: ``Message.commit``
is a no-op acknowledgment (JetStream-style redelivery is the in-memory
broker's job in tests).

:class:`MiniNATSServer` is the broker analog of miniredis (SURVEY §4):
a protocol-faithful in-process server (subjects, ``*``/``>`` wildcards,
queue-group balancing) so client tests and examples run with zero
external infrastructure.

The port's copy of ``gofr_tpu/pubsub/nats.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time
from typing import Any

from .message import Message


class NATSError(Exception):
    pass


#: sentinel pushed into delivery queues when the connection dies so
#: blocked consumers wake and raise instead of hanging forever
_CLOSED = object()


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS subject matching: tokens split on '.', '*' matches one
    token, '>' matches the rest."""
    p_tokens = pattern.split(".")
    s_tokens = subject.split(".")
    for i, p in enumerate(p_tokens):
        if p == ">":
            return True
        if i >= len(s_tokens):
            return False
        if p != "*" and p != s_tokens[i]:
            return False
    return len(p_tokens) == len(s_tokens)


class NATSClient:
    """Core-protocol client; the framework's pub/sub surface
    (publish / subscribe / create_topic / health)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4222,
                 name: str = "gofr-tpu") -> None:
        self.host = host
        self.port = port
        self.name = name
        self.logger: Any = None
        self.metrics: Any = None
        self.tracer: Any = None
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._read_task: asyncio.Task | None = None
        self._sids = itertools.count(1)
        # sid -> delivery queue; (topic, group) -> sid
        self._queues: dict[int, asyncio.Queue] = {}
        self._subs: dict[tuple[str, str], int] = {}
        self._server_info: dict = {}
        self._connected = False

    def use_logger(self, logger: Any) -> None:
        self.logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self.metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self.tracer = tracer

    # ------------------------------------------------------- connection
    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        line = await self._reader.readline()
        if not line.startswith(b"INFO "):
            raise NATSError(f"expected INFO, got {line[:40]!r}")
        self._server_info = json.loads(line[5:])
        options = {"verbose": False, "pedantic": False, "name": self.name,
                   "lang": "python", "version": "1", "protocol": 1,
                   "headers": True}  # NATS 2.2+: permits HPUB/HMSG
        self._writer.write(f"CONNECT {json.dumps(options)}\r\nPING\r\n"
                           .encode())
        await self._writer.drain()
        self._connected = True
        self._read_task = asyncio.ensure_future(self._read_loop())
        # PONG arrives via the read loop; connection is usable now
        if self.logger is not None:
            self.logger.info(f"NATS connected {self.host}:{self.port}")

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                if line.startswith(b"MSG "):
                    parts = line[4:].strip().split(b" ")
                    # MSG <subject> <sid> [reply-to] <#bytes>
                    subject = parts[0].decode()
                    sid = int(parts[1])
                    reply = parts[2].decode() if len(parts) == 4 else ""
                    nbytes = int(parts[-1])
                    payload = await self._reader.readexactly(nbytes)
                    await self._reader.readexactly(2)  # trailing \r\n
                    queue = self._queues.get(sid)
                    if queue is not None:
                        await queue.put((subject, reply, payload))
                elif line.startswith(b"HMSG "):
                    # HMSG <subject> <sid> [reply-to] <#hdr> <#total> —
                    # headered delivery (we advertise headers:true, so a
                    # real 2.2+ server may send these, e.g. 503 "no
                    # responders" status replies or KV tombstones)
                    parts = line[5:].strip().split(b" ")
                    subject = parts[0].decode()
                    sid = int(parts[1])
                    reply = parts[2].decode() if len(parts) == 5 else ""
                    hdr_len, total = int(parts[-2]), int(parts[-1])
                    blob = await self._reader.readexactly(total)
                    await self._reader.readexactly(2)
                    queue = self._queues.get(sid)
                    if queue is not None:
                        # headers are transport detail at this layer;
                        # deliver the payload (empty for status frames)
                        await queue.put((subject, reply, blob[hdr_len:]))
                elif line.startswith(b"PING"):
                    if self._writer is not None:
                        self._writer.write(b"PONG\r\n")
                        await self._writer.drain()
                elif line.startswith(b"-ERR"):
                    if self.logger is not None:
                        self.logger.error(f"NATS {line.strip().decode()}")
                # PONG / +OK / INFO updates: nothing to do
        except (asyncio.CancelledError, ConnectionError,
                asyncio.IncompleteReadError):
            pass
        finally:
            self._connected = False
            for queue in self._queues.values():
                queue.put_nowait(_CLOSED)  # wake blocked consumers

    def _require_writer(self) -> asyncio.StreamWriter:
        if self._writer is None or not self._connected:
            raise NATSError("not connected")
        return self._writer

    async def _reconnect(self) -> None:
        """Drop dead state and redial; subscriptions re-issue on demand
        (subscribe() finds _subs empty and SUBs again)."""
        if self._read_task is not None:
            self._read_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
        self._subs.clear()
        self._queues.clear()
        await self.connect()

    async def _ensure_connected(self) -> None:
        if not self._connected:
            await self._reconnect()

    # ---------------------------------------------------------- publish
    async def publish(self, topic: str, value: bytes | str | dict,
                      key: str = "", metadata: dict | None = None) -> None:
        if isinstance(value, dict):
            value = json.dumps(value).encode()
        elif isinstance(value, str):
            value = value.encode()
        await self._ensure_connected()
        writer = self._require_writer()
        start = time.perf_counter()
        writer.write(f"PUB {topic} {len(value)}\r\n".encode()
                     + value + b"\r\n")
        await writer.drain()
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count",
                                           topic=topic)
            self.metrics.increment_counter("app_pubsub_publish_success_count",
                                           topic=topic)
            self.metrics.record_histogram("app_pubsub_publish_latency",
                                          time.perf_counter() - start)

    # -------------------------------------------------------- subscribe
    async def _ensure_sub(self, topic: str, group: str) -> int:
        sid = self._subs.get((topic, group))
        if sid is None:
            sid = next(self._sids)
            self._subs[(topic, group)] = sid
            self._queues[sid] = asyncio.Queue()
            writer = self._require_writer()
            queue_part = f" {group}" if group else ""
            writer.write(f"SUB {topic}{queue_part} {sid}\r\n".encode())
            await writer.drain()
        return sid

    async def subscribe(self, topic: str, group: str = "default") -> Message:
        await self._ensure_connected()
        sid = await self._ensure_sub(topic, group)
        item = await self._queues[sid].get()
        if item is _CLOSED:
            # connection died while blocked; the subscriber runtime's
            # backoff loop retries subscribe(), which reconnects
            raise NATSError("connection lost")
        subject, _reply, payload = item
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_subscribe_total_count",
                                           topic=topic)
        return Message(topic=subject, value=payload,
                       committer=lambda: None)  # core NATS: at-most-once

    async def unsubscribe(self, topic: str, group: str = "default") -> None:
        sid = self._subs.pop((topic, group), None)
        if sid is not None:
            self._queues.pop(sid, None)
            writer = self._require_writer()
            writer.write(f"UNSUB {sid}\r\n".encode())
            await writer.drain()

    # ------------------------------------------------------------ admin
    def create_topic(self, name: str) -> None:
        pass  # NATS subjects are implicit

    def delete_topic(self, name: str) -> None:
        pass

    def health_check(self) -> dict:
        return {"status": "UP" if self._connected else "DOWN",
                "backend": "nats",
                "details": {"addr": f"{self.host}:{self.port}",
                            "server": self._server_info.get("server_id", "")}}

    async def close(self) -> None:
        if self._read_task is not None:
            self._read_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        self._connected = False


class MiniNATSServer:
    """In-process NATS core server for tests/examples: subjects with
    wildcards, queue groups (round-robin), PING/PONG."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        # conn id -> writer; subscriptions: (conn_id, sid, pattern, group)
        self._conns: dict[int, asyncio.StreamWriter] = {}
        self._subs: list[tuple[int, int, str, str]] = []
        self._conn_ids = itertools.count(1)
        self._rr = itertools.count()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn_id = next(self._conn_ids)
        self._conns[conn_id] = writer
        info = {"server_id": "mini", "version": "0.0-mini", "proto": 1,
                "max_payload": 1 << 20}
        writer.write(f"INFO {json.dumps(info)}\r\n".encode())
        await writer.drain()
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                verb = line.split(b" ", 1)[0].strip().upper()
                if verb == b"CONNECT":
                    pass
                elif verb == b"PING":
                    writer.write(b"PONG\r\n")
                    await writer.drain()
                elif verb == b"SUB":
                    parts = line.decode().strip().split()
                    # SUB <subject> [queue] <sid>
                    if len(parts) == 3:
                        _, subject, sid = parts
                        group = ""
                    else:
                        _, subject, group, sid = parts
                    self._subs.append((conn_id, int(sid), subject, group))
                elif verb == b"UNSUB":
                    sid = int(line.decode().strip().split()[1])
                    self._subs = [s for s in self._subs
                                  if not (s[0] == conn_id and s[1] == sid)]
                elif verb == b"PUB":
                    parts = line.decode().strip().split()
                    # PUB <subject> [reply-to] <#bytes>
                    subject, nbytes = parts[1], int(parts[-1])
                    reply = parts[2] if len(parts) == 4 else ""
                    payload = await reader.readexactly(nbytes)
                    await reader.readexactly(2)
                    await self._publish(subject, reply, payload)
                elif verb == b"HPUB":
                    # HPUB <subject> [reply-to] <#hdr-bytes> <#total-bytes>
                    parts = line.decode().strip().split()
                    subject = parts[1]
                    reply = parts[2] if len(parts) == 5 else ""
                    hdr_len, total = int(parts[-2]), int(parts[-1])
                    blob = await reader.readexactly(total)
                    await reader.readexactly(2)
                    await self._publish(subject, reply, blob[hdr_len:],
                                        hdrs=blob[:hdr_len])
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.pop(conn_id, None)
            self._subs = [s for s in self._subs if s[0] != conn_id]

    async def _publish(self, subject: str, reply: str, payload: bytes,
                       hdrs: bytes = b"") -> None:
        """One inbound PUB/HPUB; the JetStream subclass intercepts API
        subjects and stream captures here."""
        await self._route(subject, payload, reply=reply)

    async def _route(self, subject: str, payload: bytes,
                     reply: str = "") -> None:
        matched = [s for s in self._subs if subject_matches(s[2], subject)]
        # queue groups get one member each; plain subs all get a copy
        by_group: dict[str, list] = {}
        targets = []
        for sub in matched:
            if sub[3]:
                by_group.setdefault(sub[3], []).append(sub)
            else:
                targets.append(sub)
        for members in by_group.values():
            targets.append(members[next(self._rr) % len(members)])
        for conn_id, sid, _, _ in targets:
            writer = self._conns.get(conn_id)
            if writer is None:
                continue
            reply_part = f" {reply}" if reply else ""
            writer.write(
                f"MSG {subject} {sid}{reply_part} {len(payload)}\r\n"
                .encode() + payload + b"\r\n")
            try:
                await writer.drain()
            except ConnectionError:
                pass

    async def close(self) -> None:
        for writer in list(self._conns.values()):
            try:
                writer.close()
            except Exception:
                pass
        if self._server is not None:
            self._server.close()
            # py3.12 wait_closed() blocks forever on servers that never
            # ran serve_forever (gh-109564); bound it
            try:
                await asyncio.wait_for(self._server.wait_closed(), 0.5)
            except asyncio.TimeoutError:
                pass
