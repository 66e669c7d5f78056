"""In-process broker (copy of ``gofr_tpu/pubsub/inmemory.py``): topics,
delivery that lasts until commit, consumer groups.

Per-topic FIFO queues, one per consumer group (each group sees every
message once); a message delivered and not committed is delivered again
after ``redeliver_uncommitted`` (crash recovery); a group created late
starts from the earliest retained message (a backlog of at most
``BACKLOG_CAP`` per topic); ``create_topic`` / ``delete_topic``;
``health_check``; publish and subscribe counters on ``metrics`` when
given. ``partition_for`` hashes a key onto one of ``n`` partitions.

asyncio objects: use a broker from the event loop that runs its
subscribers (another thread hands coroutines to that loop).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
from collections import defaultdict
from typing import Any

from .message import Message


class _GroupQueue:
    def __init__(self) -> None:
        self.queue: asyncio.Queue = asyncio.Queue()
        self.pending: dict[int, tuple] = {}
        self.next_id = 0


class InMemoryBroker:
    BACKLOG_CAP = 10_000

    def __init__(self, logger: Any = None, metrics: Any = None) -> None:
        self.logger = logger
        self.metrics = metrics
        self._topics: dict[str, dict[str, _GroupQueue]] = defaultdict(dict)
        self._backlog: dict[str, list[tuple]] = defaultdict(list)
        self._connected = True

    # ----------------------------------------------------------- admin
    def create_topic(self, name: str) -> None:
        self._topics.setdefault(name, {})

    def delete_topic(self, name: str) -> None:
        self._topics.pop(name, None)
        # the retained backlog too: a recreated topic must not replay it
        self._backlog.pop(name, None)

    @property
    def topics(self) -> list[str]:
        return sorted(self._topics.keys())

    def health_check(self) -> dict:
        return {"status": "UP" if self._connected else "DOWN",
                "backend": "inmemory",
                "topics": len(self._topics)}

    def close(self) -> None:
        self._connected = False

    # --------------------------------------------------------- publish
    async def publish(self, topic: str, value: bytes | str | dict,
                      key: str = "", metadata: dict | None = None) -> None:
        if isinstance(value, dict):
            value = json.dumps(value).encode()
        elif isinstance(value, str):
            value = value.encode()
        groups = self._topics.setdefault(topic, {})
        item = (value, key, dict(metadata or {}))
        backlog = self._backlog[topic]
        backlog.append(item)
        if len(backlog) > self.BACKLOG_CAP:
            del backlog[:len(backlog) - self.BACKLOG_CAP]
        for gq in groups.values():
            await gq.queue.put(item)
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_pubsub_publish_total_count", topic=topic)
            self.metrics.increment_counter(
                "app_pubsub_publish_success_count", topic=topic)

    # -------------------------------------------------------- subscribe
    async def subscribe(self, topic: str, group: str = "default") -> Message:
        groups = self._topics.setdefault(topic, {})
        gq = groups.get(group)
        if gq is None:
            gq = groups[group] = _GroupQueue()
            for item in self._backlog[topic]:
                gq.queue.put_nowait(item)
        value, key, metadata = await gq.queue.get()
        msg_id = gq.next_id
        gq.next_id += 1
        gq.pending[msg_id] = (value, key, metadata)

        def committer() -> None:
            gq.pending.pop(msg_id, None)

        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_pubsub_subscribe_total_count", topic=topic)
        return Message(topic=topic, value=value, key=key, metadata=metadata,
                       committer=committer)

    def redeliver_uncommitted(self, topic: str, group: str = "default") -> int:
        """Requeue everything delivered but not committed; returns the
        count."""
        gq = self._topics.get(topic, {}).get(group)
        if gq is None:
            return 0
        n = 0
        for value, key, metadata in gq.pending.values():
            gq.queue.put_nowait((value, key, metadata))
            n += 1
        gq.pending.clear()
        return n


def partition_for(key: str, num_partitions: int) -> int:
    """Stable key -> partition hash (sha256 of the key, first 8 bytes,
    big-endian, modulo the count)."""
    if num_partitions <= 1:
        return 0
    digest = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(digest[:8], "big") % num_partitions
