"""Azure Event Hubs backend via the service's Kafka-compatible
endpoint.

The reference ships an Event Hub module
(reference pkg/gofr/datasource/pubsub/eventhub/) on Azure's AMQP
client library. Event Hubs also natively exposes a Kafka-compatible
endpoint (``{namespace}.servicebus.windows.net:9093`` — a supported,
documented protocol surface of the service), which maps cleanly onto
this framework's from-scratch Kafka wire client: an event hub is a
topic, partitions are partitions, consumer groups are consumer groups.
:class:`EventHubClient` is that adapter — Event-Hub-shaped
configuration over the Kafka protocol layer.

Production Event Hubs requires TLS + SASL/PLAIN on the Kafka endpoint;
pass ``connection_hook`` to wrap the socket (zero-egress CI exercises
the plaintext path against :class:`~gofr_tpu_torch.pubsub.kafka.
MiniKafkaBroker`).

The port's copy of ``gofr_tpu/pubsub/eventhub.py``.
"""

from __future__ import annotations

from typing import Any

from .kafka import KafkaClient


class EventHubClient(KafkaClient):
    """Event-Hub configuration surface over the Kafka wire client."""

    def __init__(self, namespace: str = "127.0.0.1:9092",
                 eventhub: str = "", consumer_group: str = "$Default",
                 connection_hook: Any = None) -> None:
        # bare namespace names get Azure's Kafka endpoint port
        brokers = namespace if ":" in namespace else f"{namespace}:9093"
        super().__init__(brokers=brokers, group_id=consumer_group,
                         client_id="gofr-eventhub")
        self.eventhub = eventhub
        self.connection_hook = connection_hook

    async def connect(self) -> None:
        await super().connect()
        if self.connection_hook is not None:
            await self.connection_hook(self)

    async def publish(self, topic: str = "", value=b"", key: str = "",
                      metadata: dict | None = None) -> None:
        await super().publish(topic or self.eventhub, value, key=key,
                              metadata=metadata)

    async def subscribe(self, topic: str = "", group: str = ""):
        return await super().subscribe(topic or self.eventhub,
                                       group or self.group_id)

    def health_check(self) -> dict:
        out = super().health_check()
        out["backend"] = "eventhub"
        out["details"]["eventhub"] = self.eventhub
        return out
