"""NATS JetStream: persistence, durable pull consumers, redelivery.

The reference's NATS module is JetStream-grade
(reference pkg/gofr/datasource/pubsub/nats, 3,446 LoC:
streams, durable consumers, explicit acks, redelivery). This layer
adds the same semantics on top of the core-protocol client
(:mod:`.nats`), speaking JetStream's real request-reply API over
``$JS.API.*`` subjects:

- ``$JS.API.STREAM.CREATE.<stream>`` — persistent subject capture
- ``$JS.API.CONSUMER.DURABLE.CREATE.<stream>.<durable>`` — durable
  pull consumer with an ack-wait window
- ``$JS.API.CONSUMER.MSG.NEXT.<stream>.<durable>`` — pull the next
  message; it arrives with a ``$JS.ACK...`` reply subject
- publishing to a captured subject with a reply inbox returns a
  ``PubAck {stream, seq}``; ``+ACK`` to the message's reply subject
  acknowledges, and unacked messages redeliver after ``ack_wait``
  (at-least-once, the contract ``Message.commit`` expects).

:class:`MiniJetStreamServer` extends the mini NATS server with the
stream/consumer engine so the same bytes work hermetically.

The port's copy of ``gofr_tpu/pubsub/jetstream.py``.
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import json
import time
from typing import Any

from .message import Message
from .nats import MiniNATSServer, NATSClient, NATSError, subject_matches

JS_API = "$JS.API"


class JetStreamError(NATSError):
    pass


class JetStreamClient(NATSClient):
    """Core client + JetStream publish/pull-consume.

    The framework surface is unchanged: ``publish`` persists into the
    subject's stream (auto-created ``{topic}`` stream on first use),
    ``subscribe(topic, group)`` is a durable pull consumer named
    ``group``, ``Message.commit`` ACKs, and uncommitted messages
    redeliver after ``ack_wait_s``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 4222,
                 name: str = "gofr-tpu", ack_wait_s: float = 30.0,
                 request_timeout_s: float = 5.0) -> None:
        super().__init__(host, port, name)
        self.ack_wait_s = ack_wait_s
        self.request_timeout_s = request_timeout_s
        self._inbox_prefix = f"_INBOX.{id(self):x}"
        self._inbox_seq = itertools.count(1)
        self._streams: set[str] = set()
        self._consumers: set[tuple[str, str]] = set()
        #: persistent pull inbox per (topic, group): one SUB reused
        #: across every MSG.NEXT, the standard JetStream pull pattern
        self._pull_inboxes: dict[tuple[str, str], tuple[str, int]] = {}

    @staticmethod
    def _js_name(topic: str) -> str:
        """Stream/durable names cannot contain '.' (JetStream rejects
        them; they are subject separators) — map dotted topics to a
        legal name while the stream still captures the dotted subject."""
        return topic.replace(".", "_").replace(">", "FULL").replace(
            "*", "ANY") or "empty"

    async def _reconnect(self) -> None:
        # server-side state (memory-stored streams/consumers on the
        # mini server; interest state everywhere) died with the
        # connection: re-ensure on demand
        self._streams.clear()
        self._consumers.clear()
        self._pull_inboxes.clear()
        await super()._reconnect()

    # ------------------------------------------------------ request/reply
    async def _request(self, subject: str, payload: bytes,
                       headers: dict | None = None) -> bytes:
        """Core NATS request-reply over a one-shot inbox.  With
        ``headers`` the request goes out as HPUB (NATS 2.2 header
        frame: ``NATS/1.0\\r\\n<K: V>...\\r\\n\\r\\n`` prefix)."""
        await self._ensure_connected()
        inbox = f"{self._inbox_prefix}.{next(self._inbox_seq)}"
        sid = await self._ensure_sub(inbox, "")
        try:
            writer = self._require_writer()
            if headers:
                hdr = ("NATS/1.0\r\n"
                       + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
                       + "\r\n").encode()
                writer.write(
                    f"HPUB {subject} {inbox} {len(hdr)} "
                    f"{len(hdr) + len(payload)}\r\n".encode()
                    + hdr + payload + b"\r\n")
            else:
                writer.write(f"PUB {subject} {inbox} {len(payload)}\r\n"
                             .encode() + payload + b"\r\n")
            await writer.drain()
            item = await asyncio.wait_for(self._queues[sid].get(),
                                          self.request_timeout_s)
            if not isinstance(item, tuple):
                raise JetStreamError("connection lost")
            _subject, reply, body = item
            return body
        except asyncio.TimeoutError as exc:
            raise JetStreamError(f"request timeout on {subject}") from exc
        finally:
            await self.unsubscribe(inbox, "")

    async def _api(self, subject: str, payload: dict) -> dict:
        body = json.loads(await self._request(
            subject, json.dumps(payload).encode()) or b"{}")
        err = body.get("error")
        if err and err.get("code") not in (None, 0):
            # "already exists"-class errors are fine for ensure-paths
            if "exists" not in str(err.get("description", "")):
                raise JetStreamError(f"{subject}: {err}")
        return body

    # ----------------------------------------------------------- streams
    async def ensure_stream(self, topic: str) -> None:
        name = self._js_name(topic)
        if name in self._streams:
            return
        await self._api(f"{JS_API}.STREAM.CREATE.{name}",
                        {"name": name, "subjects": [topic],
                         "retention": "limits", "storage": "memory"})
        self._streams.add(name)

    async def ensure_consumer(self, topic: str, group: str) -> None:
        stream, durable = self._js_name(topic), self._js_name(group)
        if (stream, durable) in self._consumers:
            return
        await self.ensure_stream(topic)
        await self._api(
            f"{JS_API}.CONSUMER.DURABLE.CREATE.{stream}.{durable}",
            {"stream_name": stream,
             "config": {"durable_name": durable,
                        "ack_policy": "explicit",
                        "ack_wait": int(self.ack_wait_s * 1e9)}})
        self._consumers.add((stream, durable))

    # ----------------------------------------------------------- publish
    async def publish(self, topic: str, value: bytes | str | dict,
                      key: str = "", metadata: dict | None = None) -> None:
        if isinstance(value, dict):
            value = json.dumps(value).encode()
        elif isinstance(value, str):
            value = value.encode()
        await self.ensure_stream(topic)
        start = time.perf_counter()
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count",
                                           topic=topic)
        ack = json.loads(await self._request(topic, value) or b"{}")
        if "stream" not in ack:
            raise JetStreamError(f"no PubAck for {topic}: {ack}")
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_success_count",
                                           topic=topic)
            self.metrics.record_histogram("app_pubsub_publish_latency",
                                          time.perf_counter() - start)

    # --------------------------------------------------------- subscribe
    async def _pull_inbox(self, topic: str, group: str) -> tuple[str, int]:
        """One persistent inbox subscription per consumer, reused for
        every pull (re-created after a reconnect)."""
        key = (topic, group)
        entry = self._pull_inboxes.get(key)
        if entry is None:
            inbox = f"{self._inbox_prefix}.{next(self._inbox_seq)}"
            sid = await self._ensure_sub(inbox, "")
            entry = self._pull_inboxes[key] = (inbox, sid)
        return entry

    async def subscribe(self, topic: str, group: str = "default") -> Message:
        stream, durable = self._js_name(topic), self._js_name(group)
        while True:
            await self._ensure_connected()
            await self.ensure_consumer(topic, group)
            inbox, sid = await self._pull_inbox(topic, group)
            writer = self._require_writer()
            req = json.dumps({"batch": 1, "expires": int(450e6)})
            subject = f"{JS_API}.CONSUMER.MSG.NEXT.{stream}.{durable}"
            writer.write(
                f"PUB {subject} {inbox} {len(req)}\r\n".encode()
                + req.encode() + b"\r\n")
            await writer.drain()
            try:
                item = await asyncio.wait_for(self._queues[sid].get(), 0.5)
            except asyncio.TimeoutError:
                continue              # empty pull window: poll again
            if not isinstance(item, tuple):
                continue              # connection died: redial above
            _subject, ack_subject, payload = item
            if not ack_subject:       # 404-style status, nothing pending
                continue
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_pubsub_subscribe_total_count", topic=topic)

            def committer(subject=ack_subject) -> None:
                asyncio.ensure_future(self._ack(subject))
            return Message(topic=topic, value=payload, committer=committer)

    async def _ack(self, subject: str) -> None:
        try:
            writer = self._require_writer()
            writer.write(f"PUB {subject} 4\r\n+ACK\r\n".encode())
            await writer.drain()
        except (NATSError, ConnectionError) as exc:
            if self.logger is not None:
                self.logger.error(f"jetstream ack failed: {exc!r}")

    def health_check(self) -> dict:
        out = super().health_check()
        out["backend"] = "nats-jetstream"
        return out


# --------------------------------------------------------------- server

class _Stream:
    def __init__(self, name: str, subjects: list[str]) -> None:
        self.name = name
        self.subjects = subjects
        #: seq i+1 -> (subject, payload, raw header block or b"")
        self.messages: list[tuple[str, bytes, bytes]] = []


class _Consumer:
    def __init__(self, stream: str, durable: str, ack_wait_s: float) -> None:
        self.stream = stream
        self.durable = durable
        self.ack_wait_s = ack_wait_s
        self.cursor = 0                        # next NEW sequence - 1
        #: seq -> redeliver_at deadline
        self.outstanding: dict[int, float] = {}


class MiniJetStreamServer(MiniNATSServer):
    """Mini NATS server + the JetStream engine: streams capture
    publishes, durable pull consumers track outstanding acks and
    redeliver after the ack-wait window."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host, port)
        self.streams: dict[str, _Stream] = {}
        self.consumers: dict[tuple[str, str], _Consumer] = {}

    async def _publish(self, subject: str, reply: str, payload: bytes,
                       hdrs: bytes = b"") -> None:
        if subject.startswith(JS_API + "."):
            await self._handle_api(subject[len(JS_API) + 1:], reply,
                                   payload)
            return
        if subject.startswith("$JS.ACK."):
            self._handle_ack(subject)
            return
        stored = None
        for stream in self.streams.values():
            if any(subject_matches(p, subject) for p in stream.subjects):
                stream.messages.append((subject, payload, hdrs))
                stored = (stream.name, len(stream.messages))
        if stored and reply:
            await self._route(reply, json.dumps(
                {"stream": stored[0], "seq": stored[1]}).encode())
        # core subscribers still get the message
        await self._route(subject, payload)

    async def _handle_api(self, op: str, reply: str,
                          payload: bytes) -> None:
        body = json.loads(payload or b"{}")
        out: dict

        if op.startswith("STREAM.CREATE."):
            name = op.rsplit(".", 1)[-1]
            if name in self.streams:
                out = {"error": {"code": 400,
                                 "description": "stream name already exists"}}
            else:
                self.streams[name] = _Stream(
                    name, body.get("subjects") or [name])
                out = {"config": {"name": name}, "created": True}
        elif op.startswith("CONSUMER.DURABLE.CREATE."):
            _, _, _, stream, durable = op.split(".", 4)
            if stream not in self.streams:
                out = {"error": {"code": 404,
                                 "description": "stream not found"}}
            elif (stream, durable) in self.consumers:
                out = {"error": {"code": 400,
                                 "description": "consumer already exists"}}
            else:
                ack_wait = body.get("config", {}).get("ack_wait", 30e9)
                self.consumers[(stream, durable)] = _Consumer(
                    stream, durable, ack_wait / 1e9)
                out = {"name": durable, "created": True}
        elif op.startswith("CONSUMER.MSG.NEXT."):
            _, _, _, stream, durable = op.split(".", 4)
            consumer = self.consumers.get((stream, durable))
            if consumer is None or reply == "":
                return
            seq = self._next_seq(consumer)
            if seq is None:
                return                        # empty pull: let it expire
            ack_subject = (f"$JS.ACK.{stream}.{durable}.1.{seq}.{seq}."
                           f"{int(time.time())}.0")
            await self._route(reply,
                              self.streams[stream].messages[seq - 1][1],
                              reply=ack_subject)
            return
        elif op.startswith("STREAM.MSG.GET."):
            # direct get: {"seq": n} | {"last_by_subj": subject} — the
            # JetStream API the KV facade's reads ride on
            name = op.rsplit(".", 1)[-1]
            stream_obj = self.streams.get(name)
            if stream_obj is None:
                out = {"error": {"code": 404,
                                 "description": "stream not found"}}
            else:
                found = None
                if "last_by_subj" in body:
                    want = body["last_by_subj"]
                    for i in range(len(stream_obj.messages) - 1, -1, -1):
                        if stream_obj.messages[i][0] == want:
                            found = (i + 1, stream_obj.messages[i])
                            break
                elif "seq" in body:
                    seq = int(body["seq"])
                    if 1 <= seq <= len(stream_obj.messages):
                        found = (seq, stream_obj.messages[seq - 1])
                if found is None:
                    out = {"error": {"code": 404,
                                     "description": "no message found"}}
                else:
                    seq, (subj, payload, hdrs) = found
                    msg = {"subject": subj, "seq": seq,
                           "data": base64.b64encode(payload).decode()}
                    if hdrs:
                        msg["hdrs"] = base64.b64encode(hdrs).decode()
                    out = {"message": msg}
        else:
            out = {"error": {"code": 400, "description": f"bad op {op}"}}
        if reply:
            await self._route(reply, json.dumps(out).encode())

    def _next_seq(self, consumer: _Consumer) -> int | None:
        now = time.monotonic()
        for seq, deadline in sorted(consumer.outstanding.items()):
            if deadline <= now:               # redeliver expired first
                consumer.outstanding[seq] = now + consumer.ack_wait_s
                return seq
        stream = self.streams[consumer.stream]
        if consumer.cursor < len(stream.messages):
            consumer.cursor += 1
            consumer.outstanding[consumer.cursor] = \
                now + consumer.ack_wait_s
            return consumer.cursor
        return None

    def _handle_ack(self, subject: str) -> None:
        # $JS.ACK.<stream>.<durable>.<delivered>.<sseq>...
        parts = subject.split(".")
        if len(parts) < 6:
            return
        stream, durable, seq = parts[2], parts[3], int(parts[5])
        consumer = self.consumers.get((stream, durable))
        if consumer is not None:
            consumer.outstanding.pop(seq, None)
