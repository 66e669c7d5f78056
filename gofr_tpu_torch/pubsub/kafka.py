"""Kafka backend: a binary wire-protocol client plus an in-process
mini broker for hermetic tests.

The reference's primary broker module
(reference pkg/gofr/datasource/pubsub/kafka/kafka.go:35-63:
brokers, consumer group, offset management, batch writer) behind the
common pub/sub interface (interface.go:11-31). This implementation
speaks the Kafka binary protocol directly over asyncio TCP — no driver
dependency — using the v0 wire versions of each API, which every Kafka
broker still accepts:

==== ===================== =======================================
key  API                   use here
==== ===================== =======================================
0    Produce               publish (acks=1, CRC32 message set v0)
1    Fetch                 long-poll consume per partition
2    ListOffsets           earliest/latest start position
3    Metadata              topic/partition discovery
8/9  OffsetCommit/Fetch    consumer-group offsets (commit-on-success)
10   FindCoordinator       group coordinator discovery
11   JoinGroup             membership + client-side assignment
12   Heartbeat             rebalance detection
14   SyncGroup             assignment distribution
19/20 Create/DeleteTopics  admin surface
==== ===================== =======================================

Consumer groups follow the real Kafka model: partitions are the unit
of parallelism, the JoinGroup leader computes the assignment
client-side and distributes it via SyncGroup (the assignment payload
is opaque to the broker, as in Kafka; this client uses JSON). Commit
is per-message offset+1, giving the reference's at-least-once
commit-on-success semantics.

:class:`MiniKafkaBroker` is the broker analog of miniredis (SURVEY
§4): partitioned logs, generation-checked group membership with
rebalance-in-progress errors, long-poll fetch — so client tests and
examples run with zero external infrastructure.

The port's copy of ``gofr_tpu/pubsub/kafka.py``.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import json
import struct
import time
import zlib
from typing import Any

from .message import Message


class KafkaError(Exception):
    def __init__(self, code: int, what: str = "") -> None:
        super().__init__(f"kafka error {code}{': ' + what if what else ''}")
        self.code = code


# error codes (subset)
E_NONE = 0
E_UNKNOWN_TOPIC = 3
E_ILLEGAL_GENERATION = 22
E_UNKNOWN_MEMBER = 25
E_REBALANCE_IN_PROGRESS = 27

# api keys
PRODUCE, FETCH, LIST_OFFSETS, METADATA = 0, 1, 2, 3
OFFSET_COMMIT, OFFSET_FETCH, FIND_COORDINATOR = 8, 9, 10
JOIN_GROUP, HEARTBEAT, SYNC_GROUP = 11, 12, 14
CREATE_TOPICS, DELETE_TOPICS = 19, 20


# ------------------------------------------------------------ wire enc/dec

def _i8(v): return struct.pack(">b", v)
def _i16(v): return struct.pack(">h", v)
def _i32(v): return struct.pack(">i", v)
def _i64(v): return struct.pack(">q", v)


def _str(s: str | None) -> bytes:
    if s is None:
        return _i16(-1)
    b = s.encode()
    return _i16(len(b)) + b


def _bytes(b: bytes | None) -> bytes:
    if b is None:
        return _i32(-1)
    return _i32(len(b)) + b


def _array(items: list[bytes]) -> bytes:
    return _i32(len(items)) + b"".join(items)


class _Reader:
    """Cursor over a response/request body."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise KafkaError(-1, "short buffer")
        self.pos += n
        return out

    def i8(self): return struct.unpack(">b", self._take(1))[0]
    def i16(self): return struct.unpack(">h", self._take(2))[0]
    def i32(self): return struct.unpack(">i", self._take(4))[0]
    def i64(self): return struct.unpack(">q", self._take(8))[0]

    def string(self) -> str | None:
        n = self.i16()
        return None if n < 0 else self._take(n).decode()

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self._take(n)

    def remaining(self) -> int:
        return len(self.data) - self.pos


def _encode_message_set(entries: list[tuple[bytes | None, bytes]],
                        base_offset: int = 0) -> bytes:
    """Message set v0: [offset int64, size int32, crc, magic, attrs,
    key, value] per message; CRC covers magic..value."""
    out = []
    for i, (key, value) in enumerate(entries):
        body = _i8(0) + _i8(0) + _bytes(key) + _bytes(value)
        msg = struct.pack(">I", zlib.crc32(body)) + body
        out.append(_i64(base_offset + i) + _i32(len(msg)) + msg)
    return b"".join(out)


def _decode_message_set(data: bytes) -> list[tuple[int, bytes | None, bytes]]:
    """-> [(offset, key, value)]; trailing partial messages (legal in
    Kafka fetch responses) are ignored."""
    out = []
    r = _Reader(data)
    while r.remaining() >= 12:
        offset = r.i64()
        size = r.i32()
        if r.remaining() < size:
            break
        raw = r._take(size)
        body = _Reader(raw)
        crc = struct.unpack(">I", body._take(4))[0]
        if crc != zlib.crc32(raw[4:]):
            raise KafkaError(2, "corrupt message (crc mismatch)")
        body.i8()   # magic
        body.i8()   # attributes
        key = body.bytes_()
        value = body.bytes_()
        out.append((offset, key, value if value is not None else b""))
    return out


# ---------------------------------------------------------------- client

class _Link:
    """One broker connection: request/response round-trips, serially
    under a lock (a broker answers one connection's requests in order)."""

    def __init__(self) -> None:
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self.io_lock = asyncio.Lock()
        self.connect_lock = asyncio.Lock()
        self.connected = False
        self.broker = ""

    async def close(self) -> None:
        if self.writer is not None:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        self.connected = False


class _GroupConsumer:
    """Per (topic, group) membership + fetch state, on a connection of
    its own: a follower's SyncGroup waits at the coordinator for the
    leader's assignment, which on a shared connection would hold every
    other member's requests behind it (JAX's client shares one, and its
    members of one group on several topics never settle)."""

    def __init__(self) -> None:
        self.member_id = ""
        self.generation = -1
        self.partitions: list[int] = []
        self.offsets: dict[int, int] = {}
        self.buffer: collections.deque = collections.deque()
        self.joined = False
        self.link = _Link()


class KafkaClient:
    """Wire-protocol Kafka client exposing the framework pub/sub
    surface (publish / subscribe / create_topic / health), with
    consumer-group offset commit per message (at-least-once)."""

    def __init__(self, brokers: str | list[str] = "127.0.0.1:9092",
                 group_id: str = "gofr", client_id: str = "gofr-tpu",
                 auto_offset: str = "earliest",
                 fetch_max_wait_ms: int = 250,
                 session_timeout_ms: int = 30000) -> None:
        if isinstance(brokers, str):
            brokers = [b.strip() for b in brokers.split(",") if b.strip()]
        self.brokers = brokers or ["127.0.0.1:9092"]
        self.group_id = group_id
        self.client_id = client_id
        self.auto_offset = auto_offset
        self.fetch_max_wait_ms = fetch_max_wait_ms
        self.session_timeout_ms = session_timeout_ms
        self.logger: Any = None
        self.metrics: Any = None
        self.tracer: Any = None
        self._link = _Link()                 # publish, metadata, admin
        self._corr = itertools.count(1)
        self._consumers: dict[tuple[str, str], _GroupConsumer] = {}
        self._topic_parts: dict[str, int] = {}   # publish routing cache
        self._rr = itertools.count()

    def use_logger(self, logger: Any) -> None:
        self.logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self.metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self.tracer = tracer

    # ------------------------------------------------------- connection
    @property
    def _connected(self) -> bool:
        return self._link.connected

    async def connect(self) -> None:
        await self._open(self._link)
        if self.logger is not None:
            self.logger.info(f"Kafka connected {self._link.broker}")

    async def _open(self, link: _Link) -> None:
        last: Exception | None = None
        for broker in self.brokers:
            host, _, port = broker.partition(":")
            try:
                link.reader, link.writer = await asyncio.open_connection(
                    host, int(port or 9092))
                link.connected = True
                link.broker = broker
                return
            except OSError as exc:
                last = exc
        raise KafkaError(-1, f"no broker reachable: {last}")

    async def _ensure_connected(self, link: _Link | None = None,
                                state: _GroupConsumer | None = None) -> None:
        link = link or self._link
        if link.connected:
            return
        async with link.connect_lock:
            if link.connected:       # another task already redialed
                return
            if link.writer is not None:
                try:
                    link.writer.close()
                except Exception:
                    pass
            if state is not None:
                # the membership died with its socket: reset IN PLACE
                # so the subscribe() loop holding this state rejoins
                # instead of orphaning a ghost member nobody heartbeats
                state.joined = False
                state.member_id = ""
                state.generation = -1
                state.partitions = []
            await self._open(link)

    async def _call(self, api_key: int, body: bytes,
                    api_version: int = 0,
                    link: _Link | None = None) -> _Reader:
        """One request/response round-trip (header v0) on ``link`` (the
        client's own connection by default), serially under its lock."""
        link = link or self._link
        await self._ensure_connected(link)
        corr = next(self._corr)
        header = (_i16(api_key) + _i16(api_version) + _i32(corr)
                  + _str(self.client_id))
        frame = header + body
        async with link.io_lock:
            assert link.writer is not None and link.reader is not None
            try:
                link.writer.write(_i32(len(frame)) + frame)
                await link.writer.drain()
                size = struct.unpack(">i", await
                                     link.reader.readexactly(4))[0]
                payload = await link.reader.readexactly(size)
            except (ConnectionError, asyncio.IncompleteReadError,
                    OSError) as exc:
                link.connected = False
                raise KafkaError(-1, f"connection lost: {exc}") from exc
        r = _Reader(payload)
        got = r.i32()
        if got != corr:
            link.connected = False
            raise KafkaError(-1, f"correlation mismatch {got} != {corr}")
        return r

    # ---------------------------------------------------------- publish
    async def publish(self, topic: str, value: bytes | str | dict,
                      key: str = "", metadata: dict | None = None) -> None:
        if isinstance(value, dict):
            value = json.dumps(value).encode()
        elif isinstance(value, str):
            value = value.encode()
        if not topic:
            raise KafkaError(-1, "topic name cannot be empty")
        start = time.perf_counter()
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count",
                                           topic=topic)
        # route like the reference writer's balancer (kafka.go): keyed
        # messages hash to a stable partition, unkeyed round-robin
        n_parts = self._topic_parts.get(topic)
        if n_parts is None:
            parts = await self._partitions_for(topic)
            n_parts = self._topic_parts[topic] = max(1, len(parts))
        if key:
            pid = zlib.crc32(key.encode()) % n_parts
        else:
            pid = next(self._rr) % n_parts
        mset = _encode_message_set([(key.encode() if key else None, value)])
        part = _i32(pid) + _i32(len(mset)) + mset
        body = (_i16(1) + _i32(10000)            # acks=1, timeout
                + _array([_str(topic) + _array([part])]))
        r = await self._call(PRODUCE, body)
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                r.i64()
                if err:
                    raise KafkaError(err, f"produce {topic}")
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_success_count",
                                           topic=topic)
            self.metrics.record_histogram("app_pubsub_publish_latency",
                                          time.perf_counter() - start)

    # ------------------------------------------------------ group plumbing
    async def _partitions_for(self, topic: str) -> list[int]:
        r = await self._call(METADATA, _array([_str(topic)]))
        for _ in range(r.i32()):        # brokers
            r.i32(), r.string(), r.i32()
        parts: list[int] = []
        for _ in range(r.i32()):        # topics
            err = r.i16()
            name = r.string()
            n_parts = r.i32()
            for _ in range(n_parts):
                r.i16()
                pid = r.i32()
                r.i32()                 # leader
                for _ in range(r.i32()):
                    r.i32()             # replicas
                for _ in range(r.i32()):
                    r.i32()             # isr
                if name == topic and not err:
                    parts.append(pid)
        return sorted(parts)

    async def _join(self, topic: str, group: str,
                    state: _GroupConsumer) -> None:
        """JoinGroup -> (leader assigns) -> SyncGroup -> OffsetFetch."""
        meta = json.dumps({"topics": [topic]}).encode()
        body = (_str(group) + _i32(self.session_timeout_ms)
                + _str(state.member_id) + _str("consumer")
                + _array([_str("range") + _bytes(meta)]))
        r = await self._call(JOIN_GROUP, body, link=state.link)
        err = r.i16()
        if err == E_UNKNOWN_MEMBER:
            state.member_id = ""
            raise KafkaError(err, "rejoin")
        if err:
            raise KafkaError(err, "join")
        state.generation = r.i32()
        r.string()                              # protocol
        leader = r.string()
        state.member_id = r.string() or ""
        members = [(r.string() or "", r.bytes_() or b"")
                   for _ in range(r.i32())]

        assignments: list[bytes] = []
        if state.member_id == leader:
            # client-side assignment, as real Kafka's: the leader splits
            # each topic's partitions round-robin over the members that
            # subscribe to it (their join metadata), so one group can
            # consume several topics (JAX's leader splits its own topic
            # over every member, and the other topics go unread)
            subscribers: dict[str, list[str]] = {}
            per: dict[str, dict[str, list[int]]] = {}
            for m, meta in members:
                try:
                    topics = json.loads(meta or b"{}").get("topics", [])
                except (ValueError, AttributeError):
                    topics = []
                per[m] = {t: [] for t in topics}
                for t in topics:
                    subscribers.setdefault(t, []).append(m)
            for t, ids in subscribers.items():
                for i, p in enumerate(await self._partitions_for(t)):
                    per[ids[i % len(ids)]][t].append(p)
            assignments = [_str(m) + _bytes(json.dumps(per[m]).encode())
                           for m, _ in members]
        body = (_str(group) + _i32(state.generation) + _str(state.member_id)
                + _array(assignments))
        r = await self._call(SYNC_GROUP, body, link=state.link)
        err = r.i16()
        if err:
            raise KafkaError(err, "sync")
        assigned = json.loads((r.bytes_() or b"{}").decode() or "{}")
        state.partitions = assigned.get(topic, [])
        await self._fetch_offsets(topic, group, state)
        state.joined = True

    async def _fetch_offsets(self, topic: str, group: str,
                             state: _GroupConsumer) -> None:
        body = _str(group) + _array(
            [_str(topic) + _array([_i32(p) for p in state.partitions])])
        r = await self._call(OFFSET_FETCH, body, link=state.link)
        state.offsets = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                pid = r.i32()
                off = r.i64()
                r.string()
                r.i16()
                if off < 0:  # no committed offset: start per policy
                    off = await self._list_offset(
                        topic, pid,
                        -2 if self.auto_offset == "earliest" else -1,
                        state.link)
                state.offsets[pid] = off

    async def _list_offset(self, topic: str, partition: int,
                           when: int, link: _Link | None = None) -> int:
        """ListOffsets v0: when=-2 earliest, -1 latest."""
        part = _i32(partition) + _i64(when) + _i32(1)
        body = _i32(-1) + _array([_str(topic) + _array([part])])
        r = await self._call(LIST_OFFSETS, body, link=link)
        offset = 0
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                offs = [r.i64() for _ in range(r.i32())]
                if not err and offs:
                    offset = offs[0]
        return offset

    async def _heartbeat(self, group: str, state: _GroupConsumer) -> None:
        body = (_str(group) + _i32(state.generation)
                + _str(state.member_id))
        r = await self._call(HEARTBEAT, body, link=state.link)
        err = r.i16()
        if err in (E_REBALANCE_IN_PROGRESS, E_ILLEGAL_GENERATION,
                   E_UNKNOWN_MEMBER):
            state.joined = False          # rejoin on next subscribe
            if err == E_UNKNOWN_MEMBER:
                state.member_id = ""

    async def _fetch_into(self, topic: str, state: _GroupConsumer) -> None:
        if not state.partitions:
            await asyncio.sleep(self.fetch_max_wait_ms / 1000)
            return
        parts = [_i32(p) + _i64(state.offsets.get(p, 0)) + _i32(1 << 20)
                 for p in state.partitions]
        body = (_i32(-1) + _i32(self.fetch_max_wait_ms) + _i32(1)
                + _array([_str(topic) + _array(parts)]))
        r = await self._call(FETCH, body, link=state.link)
        for _ in range(r.i32()):
            name = r.string()
            for _ in range(r.i32()):
                pid = r.i32()
                err = r.i16()
                r.i64()                     # high watermark
                mset = r.bytes_() or b""
                if err:
                    continue
                for offset, key, value in _decode_message_set(mset):
                    if offset < state.offsets.get(pid, 0):
                        continue            # broker resent below our cursor
                    state.offsets[pid] = offset + 1
                    state.buffer.append((name, pid, offset, key, value))

    # -------------------------------------------------------- subscribe
    async def subscribe(self, topic: str, group: str = "") -> Message:
        group = group or self.group_id
        state = self._consumers.setdefault((topic, group), _GroupConsumer())
        while True:
            await self._ensure_connected(state.link, state)
            if not state.joined:
                try:
                    await self._join(topic, group, state)
                except KafkaError as exc:
                    if exc.code in (E_REBALANCE_IN_PROGRESS,
                                    E_UNKNOWN_MEMBER,
                                    E_ILLEGAL_GENERATION):
                        await asyncio.sleep(0.02)
                        continue
                    raise
            if state.buffer:
                name, pid, offset, key, value = state.buffer.popleft()
                if self.metrics is not None:
                    self.metrics.increment_counter(
                        "app_pubsub_subscribe_total_count", topic=topic)

                def committer(t=name, p=pid, o=offset, g=group,
                              s=state) -> None:
                    task = asyncio.ensure_future(self._commit(t, p, o, g, s))
                    # commit is fire-and-forget at the call site (the
                    # subscriber runtime commits after handler success);
                    # surface failures through the logger
                    task.add_done_callback(self._log_commit_errors)
                return Message(topic=name, value=value,
                               key=(key or b"").decode("utf-8", "replace"),
                               committer=committer)
            await self._heartbeat(group, state)
            if not state.joined:
                continue
            await self._fetch_into(topic, state)

    def _log_commit_errors(self, task: "asyncio.Task") -> None:
        exc = task.exception() if not task.cancelled() else None
        if exc is not None and self.logger is not None:
            self.logger.error(f"kafka offset commit failed: {exc!r}")

    async def _commit(self, topic: str, partition: int, offset: int,
                      group: str, state: _GroupConsumer) -> None:
        body = (_str(group) + _array(
            [_str(topic) + _array(
                [_i32(partition) + _i64(offset + 1) + _str("")])]))
        r = await self._call(OFFSET_COMMIT, body, link=state.link)
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                if err:
                    raise KafkaError(err, "offset commit")

    # ------------------------------------------------------------ admin
    async def create_topic_async(self, name: str,
                                 partitions: int = 1) -> None:
        spec = (_str(name) + _i32(partitions) + _i16(1)
                + _array([]) + _array([]))
        body = _array([spec]) + _i32(10000)
        r = await self._call(CREATE_TOPICS, body)
        for _ in range(r.i32()):
            r.string()
            r.i16()  # already-exists is fine

    def create_topic(self, name: str) -> None:
        asyncio.ensure_future(self.create_topic_async(name))

    def delete_topic(self, name: str) -> None:
        async def _delete() -> None:
            body = _array([_str(name)]) + _i32(10000)
            await self._call(DELETE_TOPICS, body)
        asyncio.ensure_future(_delete())

    def health_check(self) -> dict:
        return {"status": "UP" if self._connected else "DOWN",
                "backend": "kafka",
                "details": {"brokers": self.brokers,
                            "group": self.group_id}}

    async def close(self) -> None:
        await self._link.close()
        for state in self._consumers.values():
            await state.link.close()


# ------------------------------------------------------------ mini broker

class _Group:
    def __init__(self) -> None:
        self.generation = 0
        self.members: dict[str, bytes] = {}
        self.leader = ""
        self.assignments: dict[str, bytes] = {}
        self.offsets: dict[tuple[str, int], int] = {}
        #: set when the generation's leader has posted assignments;
        #: follower SyncGroups block on it, as on a real coordinator
        self.sync_event = asyncio.Event()

    def rebalance(self) -> None:
        self.generation += 1
        self.assignments.clear()
        self.sync_event = asyncio.Event()


class MiniKafkaBroker:
    """In-process single-node Kafka broker for tests/examples:
    partitioned append-only logs, v0 wire protocol for the API table in
    the module docstring, generation-checked consumer groups with
    client-side assignment, long-poll fetch."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 default_partitions: int = 1) -> None:
        self.host = host
        self.port = port
        self.default_partitions = default_partitions
        self._server: asyncio.AbstractServer | None = None
        #: topic -> list of partition logs, each [(key, value)]
        self.logs: dict[str, list[list[tuple[bytes | None, bytes]]]] = {}
        self.groups: dict[str, _Group] = {}
        self._member_ids = itertools.count(1)
        self._conn_ids = itertools.count(1)
        #: conn id -> {(group_id, member_id)}: members leave when their
        #: connection dies (the fast-test analog of session-timeout
        #: expiry on a real coordinator)
        self._conn_members: dict[int, set[tuple[str, str]]] = {}
        self._data_event = asyncio.Event()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    def _topic(self, name: str) -> list[list[tuple[bytes | None, bytes]]]:
        if name not in self.logs:
            self.logs[name] = [[] for _ in range(self.default_partitions)]
        return self.logs[name]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn_id = next(self._conn_ids)
        self._conn_members[conn_id] = set()
        try:
            while True:
                raw = await reader.readexactly(4)
                size = struct.unpack(">i", raw)[0]
                frame = _Reader(await reader.readexactly(size))
                api = frame.i16()
                frame.i16()                  # api_version (v0 assumed)
                corr = frame.i32()
                frame.string()               # client id
                body = await self._dispatch(api, frame, conn_id)
                resp = _i32(corr) + body
                writer.write(_i32(len(resp)) + resp)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass
        finally:
            self._expire_conn(conn_id)
            try:
                writer.close()
            except Exception:
                pass

    def _expire_conn(self, conn_id: int) -> None:
        """Remove the connection's group members and rebalance the
        groups they leave behind."""
        for group_id, member_id in self._conn_members.pop(conn_id, ()):
            group = self.groups.get(group_id)
            if group is None or member_id not in group.members:
                continue
            del group.members[member_id]
            if group.leader == member_id:
                group.leader = next(iter(group.members), "")
            group.rebalance()

    async def _dispatch(self, api: int, r: _Reader, conn_id: int) -> bytes:
        handler = {
            PRODUCE: self._produce, FETCH: self._fetch,
            LIST_OFFSETS: self._list_offsets, METADATA: self._metadata,
            OFFSET_COMMIT: self._offset_commit,
            OFFSET_FETCH: self._offset_fetch,
            FIND_COORDINATOR: self._find_coordinator,
            JOIN_GROUP: self._join_group, HEARTBEAT: self._heartbeat,
            SYNC_GROUP: self._sync_group,
            CREATE_TOPICS: self._create_topics,
            DELETE_TOPICS: self._delete_topics,
        }.get(api)
        if handler is None:
            raise KafkaError(-1, f"unsupported api {api}")
        out = (handler(r, conn_id) if api in (JOIN_GROUP, SYNC_GROUP)
               else handler(r))
        if asyncio.iscoroutine(out):
            out = await out
        return out

    # ------------------------------------------------- produce / fetch
    def _produce(self, r: _Reader) -> bytes:
        r.i16()                              # acks
        r.i32()                              # timeout
        topics_out = []
        for _ in range(r.i32()):
            name = r.string() or ""
            parts_out = []
            for _ in range(r.i32()):
                pid = r.i32()
                mset = r.bytes_() or b""
                log = self._topic(name)
                if pid >= len(log):
                    parts_out.append(_i32(pid) + _i16(E_UNKNOWN_TOPIC)
                                     + _i64(-1))
                    continue
                base = len(log[pid])
                try:
                    entries = _decode_message_set(mset)
                except KafkaError:  # CRC mismatch: CORRUPT_MESSAGE
                    parts_out.append(_i32(pid) + _i16(2) + _i64(-1))
                    continue
                for _, key, value in entries:
                    log[pid].append((key, value))
                parts_out.append(_i32(pid) + _i16(0) + _i64(base))
            topics_out.append(_str(name) + _array(parts_out))
        self._data_event.set()
        self._data_event = asyncio.Event()   # wake current long-polls
        return _array(topics_out)

    async def _fetch(self, r: _Reader) -> bytes:
        r.i32()                              # replica id
        max_wait = r.i32()
        r.i32()                              # min bytes
        wants = []
        for _ in range(r.i32()):
            name = r.string() or ""
            for _ in range(r.i32()):
                wants.append((name, r.i32(), r.i64(), r.i32()))

        def build() -> tuple[bytes, bool]:
            by_topic: dict[str, list[bytes]] = {}
            any_data = False
            for name, pid, offset, _max in wants:
                log = self._topic(name)
                if pid >= len(log):
                    entry = _i32(pid) + _i16(E_UNKNOWN_TOPIC) + _i64(-1) \
                        + _bytes(b"")
                else:
                    entries = log[pid][offset:offset + 512]
                    if entries:
                        any_data = True
                    mset = _encode_message_set(entries, base_offset=offset)
                    entry = (_i32(pid) + _i16(0) + _i64(len(log[pid]))
                             + _bytes(mset))
                by_topic.setdefault(name, []).append(entry)
            body = _array([_str(n) + _array(p) for n, p in by_topic.items()])
            return body, any_data

        deadline = time.monotonic() + max_wait / 1000.0
        body, any_data = build()
        while not any_data and time.monotonic() < deadline:
            event = self._data_event
            try:
                await asyncio.wait_for(
                    event.wait(), max(0.0, deadline - time.monotonic()))
            except asyncio.TimeoutError:
                break
            body, any_data = build()
        return body

    def _list_offsets(self, r: _Reader) -> bytes:
        r.i32()                              # replica id
        topics_out = []
        for _ in range(r.i32()):
            name = r.string() or ""
            parts_out = []
            for _ in range(r.i32()):
                pid = r.i32()
                when = r.i64()
                r.i32()                      # max offsets
                log = self._topic(name)
                size = len(log[pid]) if pid < len(log) else 0
                offset = 0 if when == -2 else size
                parts_out.append(_i32(pid) + _i16(0)
                                 + _array([_i64(offset)]))
            topics_out.append(_str(name) + _array(parts_out))
        return _array(topics_out)

    def _metadata(self, r: _Reader) -> bytes:
        names = [r.string() or "" for _ in range(r.i32())]
        if not names:
            names = list(self.logs)
        brokers = _array([_i32(0) + _str(self.host) + _i32(self.port)])
        topics_out = []
        for name in names:
            log = self._topic(name)
            parts = [
                _i16(0) + _i32(pid) + _i32(0)
                + _array([_i32(0)]) + _array([_i32(0)])
                for pid in range(len(log))]
            topics_out.append(_i16(0) + _str(name) + _array(parts))
        return brokers + _array(topics_out)

    # ------------------------------------------------------ group APIs
    def _find_coordinator(self, r: _Reader) -> bytes:
        r.string()
        return _i16(0) + _i32(0) + _str(self.host) + _i32(self.port)

    def _join_group(self, r: _Reader, conn_id: int) -> bytes:
        group_id = r.string() or ""
        r.i32()                              # session timeout
        member_id = r.string() or ""
        r.string()                           # protocol type
        protocols = [(r.string() or "", r.bytes_() or b"")
                     for _ in range(r.i32())]
        group = self.groups.setdefault(group_id, _Group())
        if not member_id:
            member_id = f"member-{next(self._member_ids)}"
        if member_id not in group.members:
            group.rebalance()                # membership change
        group.members[member_id] = protocols[0][1] if protocols else b""
        self._conn_members.setdefault(conn_id, set()).add(
            (group_id, member_id))
        if not group.leader or group.leader not in group.members:
            group.leader = member_id
        members = _array([
            _str(m) + _bytes(meta) for m, meta in group.members.items()])
        return (_i16(0) + _i32(group.generation)
                + _str(protocols[0][0] if protocols else "range")
                + _str(group.leader) + _str(member_id) + members)

    async def _sync_group(self, r: _Reader, conn_id: int) -> bytes:
        group_id = r.string() or ""
        generation = r.i32()
        member_id = r.string() or ""
        group = self.groups.setdefault(group_id, _Group())
        if member_id not in group.members:
            return _i16(E_UNKNOWN_MEMBER) + _bytes(b"")
        if generation != group.generation:
            return _i16(E_ILLEGAL_GENERATION) + _bytes(b"")
        n_assignments = r.i32()
        for _ in range(n_assignments):
            m = r.string() or ""
            group.assignments[m] = r.bytes_() or b""
        if member_id == group.leader and n_assignments:
            group.sync_event.set()
        elif not group.sync_event.is_set():
            # follower synced before the leader: block until the
            # leader's assignments arrive (real-coordinator behavior)
            event, gen = group.sync_event, group.generation
            try:
                await asyncio.wait_for(event.wait(), timeout=5.0)
            except asyncio.TimeoutError:
                return _i16(E_REBALANCE_IN_PROGRESS) + _bytes(b"")
            if group.generation != gen:
                return _i16(E_REBALANCE_IN_PROGRESS) + _bytes(b"")
        return _i16(0) + _bytes(group.assignments.get(member_id, b""))

    def _heartbeat(self, r: _Reader) -> bytes:
        group_id = r.string() or ""
        generation = r.i32()
        member_id = r.string() or ""
        group = self.groups.setdefault(group_id, _Group())
        if member_id not in group.members:
            return _i16(E_UNKNOWN_MEMBER)
        if generation != group.generation:
            return _i16(E_REBALANCE_IN_PROGRESS)
        return _i16(0)

    def _offset_commit(self, r: _Reader) -> bytes:
        group_id = r.string() or ""
        group = self.groups.setdefault(group_id, _Group())
        topics_out = []
        for _ in range(r.i32()):
            name = r.string() or ""
            parts_out = []
            for _ in range(r.i32()):
                pid = r.i32()
                offset = r.i64()
                r.string()
                group.offsets[(name, pid)] = offset
                parts_out.append(_i32(pid) + _i16(0))
            topics_out.append(_str(name) + _array(parts_out))
        return _array(topics_out)

    def _offset_fetch(self, r: _Reader) -> bytes:
        group_id = r.string() or ""
        group = self.groups.setdefault(group_id, _Group())
        topics_out = []
        for _ in range(r.i32()):
            name = r.string() or ""
            parts_out = []
            for _ in range(r.i32()):
                pid = r.i32()
                offset = group.offsets.get((name, pid), -1)
                parts_out.append(_i32(pid) + _i64(offset) + _str("")
                                 + _i16(0))
            topics_out.append(_str(name) + _array(parts_out))
        return _array(topics_out)

    # ------------------------------------------------------------ admin
    def _create_topics(self, r: _Reader) -> bytes:
        out = []
        for _ in range(r.i32()):
            name = r.string() or ""
            n_parts = r.i32()
            r.i16()                          # replication factor
            for _ in range(r.i32()):         # manual assignments
                r.i32()
                for _ in range(r.i32()):
                    r.i32()
            for _ in range(r.i32()):         # configs
                r.string(), r.string()
            if name not in self.logs:
                self.logs[name] = [[] for _ in range(max(1, n_parts))]
            out.append(_str(name) + _i16(0))
        r.i32()                              # timeout
        return _array(out)

    def _delete_topics(self, r: _Reader) -> bytes:
        out = []
        for _ in range(r.i32()):
            name = r.string() or ""
            self.logs.pop(name, None)
            out.append(_str(name) + _i16(0))
        r.i32()
        return _array(out)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 0.5)
            except asyncio.TimeoutError:
                pass
