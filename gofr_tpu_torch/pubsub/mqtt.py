"""MQTT 3.1.1 backend: a wire-protocol client plus an in-process mini
broker for hermetic tests.

The reference ships an eclipse/paho-backed MQTT module
(datasource/pubsub/mqtt, 1,273 LoC) with QoS and retained-message
support behind the common pub/sub interface. This client implements
the MQTT 3.1.1 packet layer directly over asyncio TCP: CONNECT/CONNACK,
PUBLISH with QoS 0/1 (PUBACK), SUBSCRIBE/SUBACK, PINGREQ/PINGRESP,
DISCONNECT. At-least-once maps exactly onto the framework's
commit-on-success contract (reference subscriber.go:75-78): for
inbound QoS-1 messages ``Message.commit`` sends the PUBACK, so an
uncommitted (failed) handler leaves the message unacknowledged for
broker redelivery.

:class:`MiniMQTTBroker` is the in-process broker analog of miniredis:
topic routing with ``+``/``#`` wildcards, retained messages, QoS 0/1.

The port's copy of ``gofr_tpu/pubsub/mqtt.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time
from typing import Any

from .message import Message

# packet types (MQTT 3.1.1 §2.2.1)
CONNECT, CONNACK = 1, 2
PUBLISH, PUBACK = 3, 4
SUBSCRIBE, SUBACK = 8, 9
UNSUBSCRIBE, UNSUBACK = 10, 11
PINGREQ, PINGRESP = 12, 13
DISCONNECT = 14


class MQTTError(Exception):
    pass


#: sentinel pushed into delivery queues when the connection dies so
#: blocked consumers wake and raise instead of hanging forever
_CLOSED = object()


def encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


async def read_varint(reader: asyncio.StreamReader) -> int:
    value, shift = 0, 0
    for _ in range(4):
        byte = (await reader.readexactly(1))[0]
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value
        shift += 7
    raise MQTTError("malformed remaining-length varint")


def _utf8(s: str) -> bytes:
    data = s.encode()
    return len(data).to_bytes(2, "big") + data


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + encode_varint(len(body)) + body


async def read_packet(reader: asyncio.StreamReader) -> tuple[int, int, bytes]:
    head = (await reader.readexactly(1))[0]
    length = await read_varint(reader)
    body = await reader.readexactly(length) if length else b""
    return head >> 4, head & 0x0F, body


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT filter matching: '/' levels, '+' one level, '#' the rest."""
    p_levels = pattern.split("/")
    t_levels = topic.split("/")
    for i, p in enumerate(p_levels):
        if p == "#":
            return True
        if i >= len(t_levels):
            return False
        if p != "+" and p != t_levels[i]:
            return False
    return len(p_levels) == len(t_levels)


class MQTTClient:
    """3.1.1 client exposing the framework pub/sub surface."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1883,
                 client_id: str = "gofr-tpu", qos: int = 1,
                 retain: bool = False) -> None:
        self.host = host
        self.port = port
        self.client_id = client_id
        self.qos = qos
        self.retain = retain
        self.logger: Any = None
        self.metrics: Any = None
        self.tracer: Any = None
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._read_task: asyncio.Task | None = None
        self._packet_ids = itertools.count(1)
        self._pending_acks: dict[int, asyncio.Future] = {}
        self._suback: dict[int, asyncio.Future] = {}
        # topic filter -> queue of (topic, payload, packet_id|None)
        self._queues: dict[str, asyncio.Queue] = {}
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
        body = (_utf8("MQTT") + bytes([4])      # protocol level 4 = 3.1.1
                + bytes([0x02])                  # clean session
                + (60).to_bytes(2, "big")        # keepalive
                + _utf8(self.client_id))
        self._writer.write(_packet(CONNECT, 0, body))
        await self._writer.drain()
        ptype, _, ack = await read_packet(self._reader)
        if ptype != CONNACK or ack[1] != 0:
            raise MQTTError(f"connect refused: type={ptype} code={ack[1:]}")
        self._connected = True
        self._read_task = asyncio.ensure_future(self._read_loop())
        if self.logger is not None:
            self.logger.info(f"MQTT connected {self.host}:{self.port}")

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                ptype, flags, body = await read_packet(self._reader)
                if ptype == PUBLISH:
                    qos = (flags >> 1) & 0x03
                    tlen = int.from_bytes(body[:2], "big")
                    topic = body[2:2 + tlen].decode()
                    rest = body[2 + tlen:]
                    packet_id = None
                    if qos > 0:
                        packet_id = int.from_bytes(rest[:2], "big")
                        rest = rest[2:]
                    for pattern, queue in self._queues.items():
                        if topic_matches(pattern, topic):
                            await queue.put((topic, rest, packet_id))
                            # one delivery per inbound packet even with
                            # overlapping filters — a QoS1 id must be
                            # PUBACKed exactly once
                            break
                elif ptype == PUBACK:
                    packet_id = int.from_bytes(body[:2], "big")
                    fut = self._pending_acks.pop(packet_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result(True)
                elif ptype in (SUBACK, UNSUBACK):
                    packet_id = int.from_bytes(body[:2], "big")
                    fut = self._suback.pop(packet_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result(True)
                elif ptype == PINGREQ and self._writer is not None:
                    self._writer.write(_packet(PINGRESP, 0, b""))
                    await self._writer.drain()
        except (asyncio.CancelledError, ConnectionError,
                asyncio.IncompleteReadError):
            pass
        finally:
            self._connected = False
            for queue in self._queues.values():
                queue.put_nowait(_CLOSED)  # wake blocked consumers
            dead = MQTTError("connection lost")
            for fut in list(self._pending_acks.values()) \
                    + list(self._suback.values()):
                if not fut.done():
                    fut.set_exception(dead)
            self._pending_acks.clear()
            self._suback.clear()

    def _require_writer(self) -> asyncio.StreamWriter:
        if self._writer is None or not self._connected:
            raise MQTTError("not connected")
        return self._writer

    async def _reconnect(self) -> None:
        """Drop dead state and redial; _queues is cleared so the next
        subscribe() re-sends SUBSCRIBE for its filter."""
        if self._read_task is not None:
            self._read_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
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
        flags = (self.qos << 1) | (1 if self.retain else 0)
        body = _utf8(topic)
        ack: asyncio.Future | None = None
        if self.qos > 0:
            packet_id = next(self._packet_ids) % 65535 + 1
            body += packet_id.to_bytes(2, "big")
            ack = asyncio.get_running_loop().create_future()
            self._pending_acks[packet_id] = ack
        writer.write(_packet(PUBLISH, flags, body + value))
        await writer.drain()
        if ack is not None:
            try:
                await asyncio.wait_for(ack, timeout=10)
            finally:
                self._pending_acks.pop(packet_id, None)  # no leak on timeout
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count",
                                           topic=topic)
            self.metrics.increment_counter("app_pubsub_publish_success_count",
                                           topic=topic)
            self.metrics.record_histogram("app_pubsub_publish_latency",
                                          time.perf_counter() - start)

    # -------------------------------------------------------- subscribe
    async def _ensure_sub(self, topic: str) -> asyncio.Queue:
        queue = self._queues.get(topic)
        if queue is None:
            writer = self._require_writer()
            packet_id = next(self._packet_ids) % 65535 + 1
            fut = asyncio.get_running_loop().create_future()
            self._suback[packet_id] = fut
            body = packet_id.to_bytes(2, "big") + _utf8(topic) \
                + bytes([self.qos])
            # register before SUBACK so retained messages replayed right
            # after it aren't dropped by the read loop
            queue = self._queues[topic] = asyncio.Queue()
            writer.write(_packet(SUBSCRIBE, 0x02, body))
            await writer.drain()
            try:
                await asyncio.wait_for(fut, timeout=10)
            except asyncio.TimeoutError:
                # no SUBACK: deregister so a retry re-sends SUBSCRIBE
                # instead of waiting forever on a dead queue
                self._queues.pop(topic, None)
                self._suback.pop(packet_id, None)
                raise
        return queue

    async def subscribe(self, topic: str, group: str = "default") -> Message:
        """MQTT has no queue groups; ``group`` is accepted for interface
        compatibility (shared subscriptions are MQTT 5)."""
        await self._ensure_connected()
        queue = await self._ensure_sub(topic)
        item = await queue.get()
        if item is _CLOSED:
            # connection died while blocked; the subscriber runtime's
            # backoff loop retries subscribe(), which reconnects
            raise MQTTError("connection lost")
        actual_topic, payload, packet_id = item
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_subscribe_total_count",
                                           topic=topic)

        def committer() -> None:
            # QoS1 inbound: PUBACK on commit = at-least-once on success
            if packet_id is not None and self._writer is not None:
                self._writer.write(
                    _packet(PUBACK, 0, packet_id.to_bytes(2, "big")))
        return Message(topic=actual_topic, value=payload,
                       committer=committer)

    # ------------------------------------------------------------ admin
    def create_topic(self, name: str) -> None:
        pass  # MQTT topics are implicit

    def delete_topic(self, name: str) -> None:
        pass

    def health_check(self) -> dict:
        return {"status": "UP" if self._connected else "DOWN",
                "backend": "mqtt",
                "details": {"addr": f"{self.host}:{self.port}",
                            "client_id": self.client_id, "qos": self.qos}}

    async def close(self) -> None:
        if self._writer is not None and self._connected:
            try:
                self._writer.write(_packet(DISCONNECT, 0, b""))
                await self._writer.drain()
            except (ConnectionError, OSError):
                pass
        if self._read_task is not None:
            self._read_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        self._connected = False


class _Session:
    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self.writer = writer
        self.subs: list[tuple[str, int]] = []  # (filter, max qos)


class MiniMQTTBroker:
    """In-process 3.1.1 broker: wildcard routing, retained messages,
    QoS 0/1 (inbound QoS1 is PUBACKed; outbound redelivery on missing
    PUBACK is left to tests that need it)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self._sessions: dict[int, _Session] = {}
        self._ids = itertools.count(1)
        self._retained: dict[str, bytes] = {}
        self._out_ids = itertools.count(1)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        session_id = next(self._ids)
        session = _Session(writer)
        try:
            ptype, _, _ = await read_packet(reader)
            if ptype != CONNECT:
                return
            writer.write(_packet(CONNACK, 0, bytes([0, 0])))
            await writer.drain()
            self._sessions[session_id] = session
            while True:
                ptype, flags, body = await read_packet(reader)
                if ptype == PUBLISH:
                    await self._on_publish(writer, flags, body)
                elif ptype == SUBSCRIBE:
                    await self._on_subscribe(session, body)
                elif ptype == UNSUBSCRIBE:
                    packet_id = body[:2]
                    # body: id + utf8 filters
                    offset, filters = 2, []
                    while offset < len(body):
                        ln = int.from_bytes(body[offset:offset + 2], "big")
                        filters.append(body[offset + 2:offset + 2 + ln]
                                       .decode())
                        offset += 2 + ln
                    session.subs = [s for s in session.subs
                                    if s[0] not in filters]
                    writer.write(_packet(UNSUBACK, 0, packet_id))
                    await writer.drain()
                elif ptype == PINGREQ:
                    writer.write(_packet(PINGRESP, 0, b""))
                    await writer.drain()
                elif ptype == DISCONNECT:
                    break
                # PUBACK from subscribers: accepted, no redelivery queue
        except (ConnectionError, asyncio.IncompleteReadError, MQTTError):
            pass
        finally:
            self._sessions.pop(session_id, None)
            try:
                writer.close()
            except Exception:
                pass

    async def _on_publish(self, writer: asyncio.StreamWriter, flags: int,
                          body: bytes) -> None:
        qos = (flags >> 1) & 0x03
        retain = flags & 0x01
        tlen = int.from_bytes(body[:2], "big")
        topic = body[2:2 + tlen].decode()
        rest = body[2 + tlen:]
        if qos > 0:
            packet_id, rest = rest[:2], rest[2:]
            writer.write(_packet(PUBACK, 0, packet_id))
            await writer.drain()
        if retain:
            if rest:
                self._retained[topic] = rest
            else:
                self._retained.pop(topic, None)  # empty retained = clear
        await self._deliver(topic, rest)

    async def _deliver(self, topic: str, payload: bytes,
                       only: _Session | None = None,
                       only_filter: str | None = None) -> None:
        for session in ([only] if only else list(self._sessions.values())):
            for pattern, max_qos in session.subs:
                if only_filter is not None and pattern != only_filter:
                    continue
                if not topic_matches(pattern, topic):
                    continue
                flags = (min(max_qos, 1) << 1)
                body = _utf8(topic)
                if min(max_qos, 1) > 0:
                    body += (next(self._out_ids) % 65535 + 1).to_bytes(2, "big")
                session.writer.write(_packet(PUBLISH, flags, body + payload))
                try:
                    await session.writer.drain()
                except ConnectionError:
                    pass
                break  # one delivery per session even with overlapping subs

    async def _on_subscribe(self, session: _Session, body: bytes) -> None:
        packet_id = body[:2]
        offset, codes = 2, bytearray()
        new_filters = []
        while offset < len(body):
            ln = int.from_bytes(body[offset:offset + 2], "big")
            pattern = body[offset + 2:offset + 2 + ln].decode()
            qos = body[offset + 2 + ln]
            session.subs.append((pattern, qos))
            new_filters.append(pattern)
            codes.append(min(qos, 1))
            offset += 2 + ln + 1
        session.writer.write(_packet(SUBACK, 0, packet_id + bytes(codes)))
        await session.writer.drain()
        # retained messages replay to the new subscriber only
        for pattern in new_filters:
            for topic, payload in list(self._retained.items()):
                if topic_matches(pattern, topic):
                    await self._deliver(topic, payload, only=session,
                                        only_filter=pattern)

    async def close(self) -> None:
        for session in list(self._sessions.values()):
            try:
                session.writer.close()
            except Exception:
                pass
        self._sessions.clear()
        if self._server is not None:
            self._server.close()
            # py3.12 wait_closed() blocks forever on servers that never
            # ran serve_forever (gh-109564); bound it
            try:
                await asyncio.wait_for(self._server.wait_closed(), 0.5)
            except asyncio.TimeoutError:
                pass
