"""NATS-KV: the container's KV interface over JetStream buckets (the port's
copy of ``gofr_tpu/datasource/nats_kv.py``, on the port's
``pubsub/jetstream.py``).

The analog of reference ``datasource/kv-store/nats`` (nats.go:43 — the
KV interface over ``nats.KeyValue``): a bucket is the JetStream stream
``KV_<bucket>`` capturing subjects ``$KV.<bucket>.>``;

- ``set`` publishes the value to ``$KV.<bucket>.<key>``,
- ``get`` is a direct ``$JS.API.STREAM.MSG.GET`` with ``last_by_subj``,
- ``delete`` publishes an empty message carrying the ``KV-Operation:
  DEL`` header — the tombstone real NATS clients write, so reads see
  deletion without the server compacting history first.

This speaks the same bytes as a real nats-server (the JetStream wire
client underneath), and works hermetically against
:class:`~gofr_tpu_torch.pubsub.jetstream.MiniJetStreamServer`.  The sync
surface matches the repo's other KV backends (get/set/delete/health);
the asyncio wire client runs on a private background loop.
"""

from __future__ import annotations

import asyncio
import base64
import json
import threading
import time
from typing import Any

from ..pubsub.jetstream import JS_API, JetStreamClient, JetStreamError
from . import ProviderMixin
from .kv import KeyNotFound, KVError


class NATSKV(ProviderMixin):
    """KV store over a JetStream bucket (reference nats.go Client)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4222, *,
                 bucket: str = "default", history: int = 1,
                 timeout_s: float = 5.0) -> None:
        if not bucket or any(c in ".*> " or ord(c) < 0x21
                             for c in bucket):
            raise KVError(f"invalid bucket name {bucket!r}")
        self.bucket = bucket
        self.history = history
        self.timeout_s = timeout_s
        self._client = JetStreamClient(host, port,
                                       request_timeout_s=timeout_s)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ plumbing
    def _run(self, coro):
        if self._loop is None:
            raise KVError("NATS-KV not connected")
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(self.timeout_s * 2)

    def _publish_checked(self, subject: str, payload: bytes,
                         headers: dict | None = None) -> None:
        """Publish into the bucket stream and insist on a PubAck — an
        error ack or status frame must not read as success."""
        async def go():
            ack = json.loads(await self._client._request(
                subject, payload, headers=headers) or b"{}")
            if "stream" not in ack:
                raise KVError(f"publish rejected for {subject}: {ack}")
        self._run(go())

    def _observed(self, op: str, key: str, fn):
        start = time.perf_counter()
        try:
            return fn()
        finally:
            elapsed = time.perf_counter() - start
            if self.logger is not None:
                self.logger.debug(
                    f"NATSKV {int(elapsed * 1e6):6d}µs {op} "
                    f"{self.bucket}/{key}")
            if self.metrics is not None:
                # reference histogram name (nats.go Connect); seconds,
                # like every other app_*_stats datasource histogram —
                # this write was both unregistered (silently dropped)
                # and in milliseconds until gofrlint's metric-hygiene
                # rule caught it
                self.metrics.record_histogram("app_nats_kv_stats",
                                              elapsed,
                                              type=op.lower())

    def _subject(self, key: str) -> str:
        # control chars (CR/LF!) would terminate the PUB control line
        # early — protocol injection, not just a bad key
        if not key or key.startswith(".") or key.endswith(".") \
                or any(c in "*>" or ord(c) < 0x21 for c in key):
            raise KVError(f"invalid key {key!r}")
        return f"$KV.{self.bucket}.{key}"

    # ------------------------------------------------------------- session
    def connect(self) -> None:
        if self._loop is not None:
            return
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever,
                                  name="nats-kv", daemon=True)
        thread.start()
        self._loop, self._thread = loop, thread

        async def dial():
            await self._client.connect()
            # CreateKeyValue: per-subject history is the bucket's
            # version depth; 'exists' errors are fine on reconnect
            await self._client._api(
                f"{JS_API}.STREAM.CREATE.KV_{self.bucket}",
                {"name": f"KV_{self.bucket}",
                 "subjects": [f"$KV.{self.bucket}.>"],
                 "max_msgs_per_subject": self.history,
                 "allow_rollup_hdrs": True, "deny_delete": True,
                 "storage": "memory"})
        try:
            self._run(dial())
        except Exception:
            self.close()
            raise

    def close(self) -> None:
        loop, self._loop = self._loop, None
        if loop is not None:
            try:
                asyncio.run_coroutine_threadsafe(
                    self._client.close(), loop).result(self.timeout_s)
            except Exception:
                pass
            loop.call_soon_threadsafe(loop.stop)
            if self._thread is not None:
                self._thread.join(self.timeout_s)
            self._thread = None
            loop.close()  # release the selector/self-pipe fds

    # ----------------------------------------------------------------- ops
    def get(self, key: str) -> str:
        subject = self._subject(key)

        def op():
            async def go():
                return await self._client._api(
                    f"{JS_API}.STREAM.MSG.GET.KV_{self.bucket}",
                    {"last_by_subj": subject})
            try:
                body = self._run(go())
            except JetStreamError as exc:
                if "404" in str(exc) or "no message" in str(exc):
                    raise KeyNotFound(key) from exc
                raise
            msg = body.get("message")
            if not isinstance(msg, dict):
                # e.g. an empty 503 no-responders status frame parsed
                # as {} — that is an outage, not an empty value
                raise KVError(f"malformed MSG.GET reply for {subject}: "
                              f"{body}")
            hdrs = base64.b64decode(msg.get("hdrs", "")).decode(
                "latin-1") if msg.get("hdrs") else ""
            for line in hdrs.splitlines():
                if line.lower().startswith("kv-operation:") \
                        and line.split(":", 1)[1].strip() in ("DEL", "PURGE"):
                    raise KeyNotFound(key)
            return base64.b64decode(msg.get("data", "")).decode()
        return self._observed("GET", key, op)

    def set(self, key: str, value: str) -> None:
        subject = self._subject(key)
        payload = value.encode() if isinstance(value, str) else bytes(value)
        return self._observed(
            "SET", key, lambda: self._publish_checked(subject, payload))

    def delete(self, key: str) -> None:
        subject = self._subject(key)
        return self._observed(
            "DELETE", key, lambda: self._publish_checked(
                subject, b"", headers={"KV-Operation": "DEL"}))

    # -------------------------------------------------------------- health
    def health_check(self) -> dict[str, Any]:
        out = self._client.health_check()
        if self._loop is None:
            out["status"] = "DOWN"
        out["backend"] = "nats-kv"
        out.setdefault("details", {})["bucket"] = self.bucket
        return out
