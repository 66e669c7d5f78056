"""Subscriber runtime: broker messages -> handler Contexts (the port's
copy of ``gofr_tpu/pubsub/subscriber.py``; ``App.subscribe`` runs it over
the container's broker, the in-memory one until other brokers are
ported).

Mirrors reference pkg/gofr/subscriber.go: an event loop per topic that
polls the container's pub/sub client, wraps each message in a Context,
runs the handler with panic recovery, commits on success, and backs
off 2 seconds on broker errors (subscriber.go:27-107).
"""

from __future__ import annotations

import asyncio
from typing import Callable

from ..context import Context
from ..handler import run_handler

ERROR_BACKOFF_S = 2.0


class SubscriptionManager:
    """``executor``: where a plain handler runs (the app's handler
    pool; None: the loop's default pool), never on the loop's thread."""

    def __init__(self, container, executor=None) -> None:
        self.container = container
        self.executor = executor

    async def start_subscriber(self, topic: str, handler: Callable,
                               group: str | None = None) -> None:
        """Infinite consume loop for one topic (one asyncio task).

        ``group`` defaults to the configured consumer group
        (``CONSUMER_GROUP``/``KAFKA_CONSUMER_GROUP``), falling back to
        "default" — so apps with distinct configured groups never share
        offsets (reference kafka.go ConsumerGroupID semantics)."""
        if group is None:
            group = self._default_group()
        while True:
            try:
                await self.handle_one(topic, handler, group)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self.container.logger.error(
                    f"subscriber {topic!r}: {exc!r}; retrying in "
                    f"{ERROR_BACKOFF_S}s")
                await asyncio.sleep(ERROR_BACKOFF_S)

    def _default_group(self) -> str:
        config = getattr(self.container, "config", None)
        if config is None:
            return "default"
        return config.get_or_default(
            "CONSUMER_GROUP",
            config.get_or_default("KAFKA_CONSUMER_GROUP", "default"))

    async def handle_one(self, topic: str, handler: Callable,
                         group: str | None = None) -> None:
        """Consume and handle exactly one message (test-friendly)."""
        if group is None:
            group = self._default_group()
        pubsub = self.container.pubsub
        if pubsub is None:
            raise RuntimeError("no pub/sub client configured")
        msg = await pubsub.subscribe(topic, group)
        ctx = Context(request=msg, container=self.container)
        metrics = self.container.metrics
        try:
            await run_handler(handler, ctx, executor=self.executor)
        except Exception as exc:  # handler panic: log, do NOT commit
            self.container.logger.error(
                f"handler for {topic!r} failed: {exc!r}")
            return
        msg.commit()  # at-least-once: commit only on success
        if metrics is not None:
            metrics.increment_counter(
                "app_pubsub_subscribe_success_count", topic=topic)
