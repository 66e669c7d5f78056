"""Pub/sub for the port's batch workers (counterpart of
``gofr_tpu/pubsub/``'s message and in-memory broker): :class:`Message`
and :class:`InMemoryBroker`, asyncio as in the JAX package."""

from .inmemory import InMemoryBroker, partition_for
from .message import Message

__all__ = ["InMemoryBroker", "Message", "partition_for"]
