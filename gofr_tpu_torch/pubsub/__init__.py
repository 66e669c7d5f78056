"""Pub/sub for the port (counterpart of ``gofr_tpu/pubsub/``): the
message, the in-memory broker (asyncio, as in the JAX package) and the
subscriber runtime behind ``App.subscribe``."""

from .inmemory import InMemoryBroker, partition_for
from .message import Message
from .subscriber import SubscriptionManager

__all__ = ["InMemoryBroker", "Message", "SubscriptionManager",
           "partition_for"]
