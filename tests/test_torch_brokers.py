"""The port's broker clients and Mini servers (``pubsub/kafka.py``,
``eventhub.py``, ``nats.py``, ``jetstream.py``, ``mqtt.py``, ``google.py``)
against the JAX package's: every case of the JAX tests of each module runs
three ways (the port's client on the port's server, the port's client on
JAX's server, JAX's client on the port's server: ``torch_wire.PAIRS``),
real protocol bytes over loopback sockets; the codecs and matchers equal
JAX's on the same inputs; one scripted session per protocol gives the same
messages, offsets and typed errors in both cross directions as JAX's
client on JAX's server; and one consumer group reads several Kafka topics
(JAX's client reads one of them: ROADMAP Queue C).
"""

import asyncio
import functools

import pytest

from gofr_tpu.pubsub import kafka as jax_kafka
from gofr_tpu.pubsub import mqtt as jax_mqtt
from gofr_tpu.pubsub import nats as jax_nats
from gofr_tpu_torch.config.env import DictConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.pubsub import kafka as port_kafka
from gofr_tpu_torch.pubsub import mqtt as port_mqtt
from gofr_tpu_torch.pubsub import nats as port_nats

from .torch_wire import PAIR_IDS, PAIRS, Pair, dead_port


def async_test(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return asyncio.run(fn(*args, **kwargs))
    return wrapper


# ------------------------------------------------- codecs and matchers
@pytest.mark.parametrize("entries,base", [
    ([(b"k1", b"v1"), (None, b"v2"), (b"", b"")], 5),
    ([(b"k", b"hello")], 0),
    ([(None, bytes(range(256)) * 4)], 1 << 33)])
def test_message_set_codec_equals_jax(entries, base):
    """The Kafka v0 message set: the same bytes, the same decode (a
    trailing partial message ignored)."""
    port = port_kafka._encode_message_set(entries, base_offset=base)
    assert port == jax_kafka._encode_message_set(entries, base_offset=base)
    for data in (port, port + port[:7]):
        assert port_kafka._decode_message_set(data) == \
            jax_kafka._decode_message_set(data)
    assert port_kafka._decode_message_set(port) == [
        (base + i, k, v) for i, (k, v) in enumerate(entries)]


@pytest.mark.parametrize("pattern,subject,ok", [
    ("orders.created", "orders.created", True),
    ("orders.*", "orders.created", True),
    ("orders.*", "orders.created.eu", False),
    ("orders.>", "orders.created.eu", True),
    (">", "anything.at.all", True),
    ("orders.created", "orders", False),
])
def test_nats_subject_matching(pattern, subject, ok):
    assert port_nats.subject_matches(pattern, subject) is ok
    assert jax_nats.subject_matches(pattern, subject) is ok


@pytest.mark.parametrize("pattern,topic,ok", [
    ("a/b", "a/b", True),
    ("a/+", "a/b", True),
    ("a/+", "a/b/c", False),
    ("a/#", "a/b/c", True),
    ("#", "x/y", True),
    ("a/b", "a", False),
])
def test_mqtt_topic_matching(pattern, topic, ok):
    assert port_mqtt.topic_matches(pattern, topic) is ok
    assert jax_mqtt.topic_matches(pattern, topic) is ok


def test_mqtt_varint():
    for n, want in ((0, b"\x00"), (127, b"\x7f"), (128, b"\x80\x01"),
                    (16383, b"\xff\x7f"), (2097151, b"\xff\xff\x7f")):
        assert port_mqtt.encode_varint(n) == jax_mqtt.encode_varint(n) == \
            want


class TestKafka:
    """``pubsub/kafka``: produce / fetch / group join / commit."""

    @pytest.fixture(params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("kafka", request.param)

    @async_test
    async def test_publish_subscribe_commit(self, m):
        broker = m.MiniKafkaBroker()
        await broker.start()
        client = m.KafkaClient(brokers=f"127.0.0.1:{broker.port}",
                               group_id="g1")
        try:
            await client.publish("orders", {"id": 1}, key="k1")
            await client.publish("orders", {"id": 2})
            m1 = await client.subscribe("orders", "g1")
            m2 = await client.subscribe("orders", "g1")
            assert m1.bind() == {"id": 1} and m1.key == "k1"
            assert m2.bind() == {"id": 2}
            m1.commit()
            m2.commit()
            await asyncio.sleep(0.05)  # fire-and-forget commits land
            assert broker.groups["g1"].offsets[("orders", 0)] == 2
        finally:
            await client.close()
            await broker.close()


    @async_test
    async def test_committed_offset_survives_reconnect(self, m):
        """At-least-once: a new consumer in the same group resumes after
        the committed offset, not from the beginning."""
        broker = m.MiniKafkaBroker()
        await broker.start()
        addr = f"127.0.0.1:{broker.port}"
        c1 = m.KafkaClient(brokers=addr, group_id="g")
        await c1.publish("t", "a")
        await c1.publish("t", "b")
        got = await c1.subscribe("t", "g")
        assert got.value == b"a"
        got.commit()
        await asyncio.sleep(0.05)
        await c1.close()

        c2 = m.KafkaClient(brokers=addr, group_id="g")
        try:
            got = await c2.subscribe("t", "g")
            assert got.value == b"b"
        finally:
            await c2.close()
            await broker.close()


    @async_test
    async def test_uncommitted_message_redelivered(self, m):
        broker = m.MiniKafkaBroker()
        await broker.start()
        addr = f"127.0.0.1:{broker.port}"
        c1 = m.KafkaClient(brokers=addr, group_id="g")
        await c1.publish("t", "poison")
        got = await c1.subscribe("t", "g")
        assert got.value == b"poison"
        await c1.close()            # died without committing

        c2 = m.KafkaClient(brokers=addr, group_id="g")
        try:
            got = await c2.subscribe("t", "g")
            assert got.value == b"poison"
        finally:
            await c2.close()
            await broker.close()


    @async_test
    async def test_consumer_group_partitions_balance(self, m):
        """Two members of one group split a 2-partition topic: each
        message is consumed by exactly one member (reference
        kafka.go consumer-group semantics)."""
        broker = m.MiniKafkaBroker(default_partitions=2)
        await broker.start()
        addr = f"127.0.0.1:{broker.port}"
        pub = m.KafkaClient(brokers=addr)
        c1 = m.KafkaClient(brokers=addr, group_id="g")
        c2 = m.KafkaClient(brokers=addr, group_id="g")
        try:
            # join both members first (join order decides assignment)
            t1 = asyncio.ensure_future(c1.subscribe("evt", "g"))
            t2 = asyncio.ensure_future(c2.subscribe("evt", "g"))
            await asyncio.sleep(0.3)

            # unkeyed publishes round-robin across the two partitions
            await pub.publish("evt", "p0")
            await pub.publish("evt", "p1")

            got = {(await asyncio.wait_for(t1, 10)).value,
                   (await asyncio.wait_for(t2, 10)).value}
            assert got == {b"p0", b"p1"}
        finally:
            await pub.close()
            await c1.close()
            await c2.close()
            await broker.close()


    @async_test
    async def test_rebalance_on_new_member(self, m):
        """A second member joining bumps the generation; the first member
        detects it via heartbeat and rejoins rather than erroring."""
        broker = m.MiniKafkaBroker(default_partitions=2)
        await broker.start()
        addr = f"127.0.0.1:{broker.port}"
        c1 = m.KafkaClient(brokers=addr, group_id="g")
        c2 = m.KafkaClient(brokers=addr, group_id="g")
        pub = m.KafkaClient(brokers=addr)
        try:
            t1 = asyncio.ensure_future(c1.subscribe("evt", "g"))
            await asyncio.sleep(0.2)          # c1 owns both partitions
            t2 = asyncio.ensure_future(c2.subscribe("evt", "g"))
            await asyncio.sleep(0.4)          # c1 must rejoin at generation+1

            await pub.publish("evt", "x")
            done, pending = await asyncio.wait({t1, t2}, timeout=10)
            assert done, "no member received the message after rebalance"
            assert {m.result().value for m in done} == {b"x"}
            for task in pending:
                task.cancel()
        finally:
            await pub.close()
            await c1.close()
            await c2.close()
            await broker.close()


    @async_test
    async def test_create_delete_topic_admin(self, m):
        broker = m.MiniKafkaBroker()
        await broker.start()
        client = m.KafkaClient(brokers=f"127.0.0.1:{broker.port}")
        try:
            await client.create_topic_async("adm", partitions=3)
            assert len(broker.logs["adm"]) == 3
            client.delete_topic("adm")
            await asyncio.sleep(0.05)
            assert "adm" not in broker.logs
            assert client.health_check()["status"] == "UP"
        finally:
            await client.close()
            await broker.close()


    @async_test
    async def test_container_wires_kafka_backend(self, m):
        broker = m.MiniKafkaBroker()
        await broker.start()
        config = m.side("config.env").DictConfig({
            "APP_NAME": "kafka-app",
            "PUBSUB_BACKEND": "KAFKA",
            "PUBSUB_BROKER": f"127.0.0.1:{broker.port}",
            "KAFKA_CONSUMER_GROUP": "workers",
        })
        c = m.side("container.container").Container.create(config)
        try:
            assert isinstance(c.pubsub, m.KafkaClient)
            assert c.pubsub.group_id == "workers"
            await c.pubsub.publish("t", {"ok": True})
            msg = await c.pubsub.subscribe("t", "workers")
            assert msg.bind() == {"ok": True}
        finally:
            await c.pubsub.close()
            await broker.close()


    @async_test
    async def test_keyed_publish_routes_stably(self, m):
        """Same key -> same partition (ordering per key), different keys
        spread (reference kafka.go writer balancer semantics)."""
        broker = m.MiniKafkaBroker(default_partitions=4)
        await broker.start()
        pub = m.KafkaClient(brokers=f"127.0.0.1:{broker.port}")
        try:
            await pub.create_topic_async("keyed", partitions=4)
            for _ in range(3):
                await pub.publish("keyed", "a", key="user-1")
            sizes = [len(p) for p in broker.logs["keyed"]]
            assert sorted(sizes) == [0, 0, 0, 3]   # all three on ONE partition
        finally:
            await pub.close()
            await broker.close()


    def test_subscriber_group_defaults_from_config(self, m):
        SubscriptionManager = m.side("pubsub.subscriber").SubscriptionManager

        class FakeContainer:
            config = m.side("config.env").DictConfig(
                {"KAFKA_CONSUMER_GROUP": "workers"})

        assert SubscriptionManager(FakeContainer())._default_group() == \
            "workers"

        class Generic:
            config = m.side("config.env").DictConfig(
                {"CONSUMER_GROUP": "generic"})

        assert SubscriptionManager(Generic())._default_group() == "generic"

        class Bare:
            config = m.side("config.env").DictConfig({})

        assert SubscriptionManager(Bare())._default_group() == "default"


class TestJetStream:
    """``pubsub/jetstream``: streams, durable pull consumers, acks."""

    @pytest.fixture(params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("jetstream", request.param)

    @async_test
    async def test_publish_gets_puback_and_persists(self, m):
        srv = m.MiniJetStreamServer()
        await srv.start()
        client = m.JetStreamClient(port=srv.port)
        try:
            await client.publish("orders", {"id": 1})
            await client.publish("orders", {"id": 2})
            assert len(srv.streams["orders"].messages) == 2  # persisted
        finally:
            await client.close()
            await srv.close()


    @async_test
    async def test_pull_consume_ack_ordering(self, m):
        srv = m.MiniJetStreamServer()
        await srv.start()
        client = m.JetStreamClient(port=srv.port)
        try:
            await client.publish("t", "a")
            await client.publish("t", "b")
            m1 = await asyncio.wait_for(client.subscribe("t", "workers"), 10)
            assert m1.value == b"a"
            m1.commit()
            m2 = await asyncio.wait_for(client.subscribe("t", "workers"), 10)
            assert m2.value == b"b"
            m2.commit()
            await asyncio.sleep(0.05)
            consumer = srv.consumers[("t", "workers")]
            assert not consumer.outstanding          # both acked
        finally:
            await client.close()
            await srv.close()


    @async_test
    async def test_unacked_redelivers_after_ack_wait(self, m):
        srv = m.MiniJetStreamServer()
        await srv.start()
        client = m.JetStreamClient(port=srv.port, ack_wait_s=0.3)
        try:
            await client.publish("t", "poison")
            got = await asyncio.wait_for(client.subscribe("t", "g"), 10)
            assert got.value == b"poison"              # delivered, NOT acked
            await asyncio.sleep(0.4)                 # ack-wait expires
            m2 = await asyncio.wait_for(client.subscribe("t", "g"), 10)
            assert m2.value == b"poison"             # redelivered
            m2.commit()
            await asyncio.sleep(0.05)
            assert not srv.consumers[("t", "g")].outstanding
        finally:
            await client.close()
            await srv.close()


    @async_test
    async def test_consumer_survives_client_restart(self, m):
        """Durability: a new client resumes the durable's cursor — acked
        messages never redeliver across restarts."""
        srv = m.MiniJetStreamServer()
        await srv.start()
        c1 = m.JetStreamClient(port=srv.port)
        await c1.publish("t", "one")
        await c1.publish("t", "two")
        got = await asyncio.wait_for(c1.subscribe("t", "d"), 10)
        assert got.value == b"one"
        got.commit()
        await asyncio.sleep(0.05)
        await c1.close()

        c2 = m.JetStreamClient(port=srv.port)
        try:
            got = await asyncio.wait_for(c2.subscribe("t", "d"), 10)
            assert got.value == b"two"
        finally:
            await c2.close()
            await srv.close()


    @async_test
    async def test_two_groups_each_get_every_message(self, m):
        srv = m.MiniJetStreamServer()
        await srv.start()
        client = m.JetStreamClient(port=srv.port)
        try:
            await client.publish("evt", "x")
            a = await asyncio.wait_for(client.subscribe("evt", "a"), 10)
            b = await asyncio.wait_for(client.subscribe("evt", "b"), 10)
            assert a.value == b"x" and b.value == b"x"
        finally:
            await client.close()
            await srv.close()


    @async_test
    async def test_container_wires_jetstream_backend(self, m):
        srv = m.MiniJetStreamServer()
        await srv.start()
        c = m.side("container.container").Container.create(
            m.side("config.env").DictConfig({
                "APP_NAME": "js", "PUBSUB_BACKEND": "JETSTREAM",
                "PUBSUB_BROKER": f"127.0.0.1:{srv.port}"}))
        try:
            assert isinstance(c.pubsub, m.JetStreamClient)
            await c.pubsub.publish("t", {"n": 1})
            msg = await asyncio.wait_for(c.pubsub.subscribe("t", "g"), 10)
            assert msg.bind() == {"n": 1}
            assert c.pubsub.health_check()["backend"] == "nats-jetstream"
        finally:
            await c.pubsub.close()
            await srv.close()


    @async_test
    async def test_dotted_subjects_work(self, m):
        """Idiomatic NATS subjects ('orders.created') must map to legal
        stream/durable names while the stream captures the dotted subject."""
        srv = m.MiniJetStreamServer()
        await srv.start()
        client = m.JetStreamClient(port=srv.port)
        try:
            await client.publish("orders.created", {"id": 9})
            got = await asyncio.wait_for(
                client.subscribe("orders.created", "eu.workers"), 10)
            assert got.bind() == {"id": 9}
            got.commit()
            assert "orders_created" in srv.streams
        finally:
            await client.close()
            await srv.close()


    @async_test
    async def test_subscribe_recovers_after_connection_drop(self, m):
        srv = m.MiniJetStreamServer()
        await srv.start()
        client = m.JetStreamClient(port=srv.port)
        try:
            await client.publish("t", "before")
            got = await asyncio.wait_for(client.subscribe("t", "g"), 10)
            assert got.value == b"before"
            got.commit()
            await asyncio.sleep(0.05)
            # server drops every connection; streams live server-side
            for w in list(srv._conns.values()):
                w.close()
            await asyncio.sleep(0.05)
            await client.publish("t", "after")
            m2 = await asyncio.wait_for(client.subscribe("t", "g"), 10)
            assert m2.value == b"after"
        finally:
            await client.close()
            await srv.close()


class TestGoogle:
    """``pubsub/google``: the REST client against the emulator."""

    @pytest.fixture(params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("google", request.param)

    @async_test
    async def test_publish_pull_ack_roundtrip(self, m):
        emu = m.MiniPubSubEmulator()
        await emu.start()
        client = m.GooglePubSubClient(f"127.0.0.1:{emu.port}", project="p")
        try:
            # real Pub/Sub delivers only to subscriptions that exist at
            # publish time; apps create them at boot (the subscriber
            # runtime pulls from startup), tests do it explicitly
            await client._ensure_subscription("orders", "g-orders")
            await client.publish("orders", {"id": 7}, key="k",
                                 metadata={"source": "web"})
            msg = await asyncio.wait_for(client.subscribe("orders", "g"), 10)
            assert msg.bind() == {"id": 7}
            assert msg.key == "k"
            assert msg.metadata["source"] == "web"
            msg.commit()
            await asyncio.sleep(0.05)
            assert not emu.subs["g-orders"]["outstanding"]
        finally:
            await client.close()
            await emu.close()


    @async_test
    async def test_groups_fan_out_but_compete_within(self, m):
        """Each group (subscription) sees every message once; consumers in
        one group compete."""
        emu = m.MiniPubSubEmulator()
        await emu.start()
        client = m.GooglePubSubClient(f"127.0.0.1:{emu.port}")
        try:
            # create both subscriptions BEFORE publishing (pub/sub fan-out
            # starts at subscription creation, as in the real service)
            await client._ensure_subscription("evt", "a-evt")
            await client._ensure_subscription("evt", "b-evt")
            await client.publish("evt", "x")
            m1 = await asyncio.wait_for(client.subscribe("evt", "a"), 10)
            m2 = await asyncio.wait_for(client.subscribe("evt", "b"), 10)
            assert m1.value == b"x" and m2.value == b"x"
        finally:
            await client.close()
            await emu.close()


    @async_test
    async def test_unacked_message_redelivers_after_deadline(self, m):
        emu = m.MiniPubSubEmulator()
        await emu.start()
        client = m.GooglePubSubClient(f"127.0.0.1:{emu.port}",
                                      ack_deadline_s=1)
        try:
            await client._ensure_subscription("t", "g-t")
            await client.publish("t", "poison")
            got = await asyncio.wait_for(client.subscribe("t", "g"), 10)
            assert got.value == b"poison"   # received but NOT acked
            await asyncio.sleep(1.1)      # deadline passes
            m2 = await asyncio.wait_for(client.subscribe("t", "g"), 10)
            assert m2.value == b"poison"
            m2.commit()
        finally:
            await client.close()
            await emu.close()


    @async_test
    async def test_container_wires_google_backend(self, m):
        emu = m.MiniPubSubEmulator()
        await emu.start()
        c = m.side("container.container").Container.create(
            m.side("config.env").DictConfig({
                "APP_NAME": "gp", "PUBSUB_BACKEND": "GOOGLE",
                "PUBSUB_BROKER": f"127.0.0.1:{emu.port}",
                "GOOGLE_PROJECT_ID": "proj-x"}))
        try:
            assert isinstance(c.pubsub, m.GooglePubSubClient)
            assert c.pubsub.project == "proj-x"
            await c.pubsub._ensure_subscription("t", "w-t")
            await c.pubsub.publish("t", {"ok": 1})
            msg = await asyncio.wait_for(c.pubsub.subscribe("t", "w"), 10)
            assert msg.bind() == {"ok": 1}
            assert c.pubsub.health_check()["status"] == "UP"
        finally:
            await c.pubsub.close()
            await emu.close()


class TestEventHub:
    """``pubsub/eventhub``: the Event Hubs surface over the Kafka client."""

    @pytest.fixture(params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("eventhub", request.param)

    @pytest.fixture()
    def kafka(self, m):
        return Pair("kafka", (m.client, m.server))

    @async_test
    async def test_eventhub_adapter_over_kafka_endpoint(self, m, kafka):
        broker = kafka.MiniKafkaBroker()
        await broker.start()
        client = m.EventHubClient(namespace=f"127.0.0.1:{broker.port}",
                                eventhub="telemetry",
                                consumer_group="$Default")
        try:
            await client.publish(value={"reading": 42})  # default hub
            msg = await asyncio.wait_for(client.subscribe(), 15)
            assert msg.topic == "telemetry"
            assert msg.bind() == {"reading": 42}
            health = client.health_check()
            assert health["backend"] == "eventhub"
            assert health["details"]["eventhub"] == "telemetry"
        finally:
            await client.close()
            await broker.close()


    @async_test
    async def test_container_wires_eventhub_backend(self, m, kafka):
        broker = kafka.MiniKafkaBroker()
        await broker.start()
        c = m.side("container.container").Container.create(
            m.side("config.env").DictConfig({
                "APP_NAME": "eh", "PUBSUB_BACKEND": "EVENTHUB",
                "PUBSUB_BROKER": f"127.0.0.1:{broker.port}",
                "EVENTHUB_NAME": "ingest"}))
        try:
            assert isinstance(c.pubsub, m.EventHubClient)
            await c.pubsub.publish(value="ping")
            msg = await asyncio.wait_for(c.pubsub.subscribe(), 15)
            assert msg.value == b"ping" and msg.topic == "ingest"
        finally:
            await c.pubsub.close()
            await broker.close()


class TestNATS:
    """``pubsub/nats``: core NATS, queue groups, wildcards, redial."""

    @pytest.fixture(params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("nats", request.param)

    @async_test
    async def test_pub_sub_roundtrip(self, m):
        server = m.MiniNATSServer()
        await server.start()
        client = m.NATSClient(port=server.port)
        await client.connect()
        try:
            task = asyncio.ensure_future(client.subscribe("greetings", ""))
            await asyncio.sleep(0.05)  # let SUB reach the server
            await client.publish("greetings", {"hello": "tpu"})
            msg = await asyncio.wait_for(task, timeout=2)
            assert msg.topic == "greetings"
            assert msg.bind() == {"hello": "tpu"}
            msg.commit()  # no-op, must not raise
            assert client.health_check()["status"] == "UP"
        finally:
            await client.close()
            await server.close()

    @async_test
    async def test_queue_group_balances_and_plain_subs_fan_out(self, m):
        server = m.MiniNATSServer()
        await server.start()
        worker_a = m.NATSClient(port=server.port, name="a")
        worker_b = m.NATSClient(port=server.port, name="b")
        audit = m.NATSClient(port=server.port, name="audit")
        for c in (worker_a, worker_b, audit):
            await c.connect()
        try:
            ta = asyncio.ensure_future(worker_a.subscribe("jobs", "workers"))
            tb = asyncio.ensure_future(worker_b.subscribe("jobs", "workers"))
            taudit = asyncio.ensure_future(audit.subscribe("jobs", ""))
            await asyncio.sleep(0.05)
            await worker_a.publish("jobs", b"j1")
            await worker_a.publish("jobs", b"j2")
            # audit (plain sub) sees both; the queue group sees each once
            m1 = await asyncio.wait_for(taudit, 2)
            m2 = await asyncio.wait_for(audit.subscribe("jobs", ""), 2)
            assert {m1.value, m2.value} == {b"j1", b"j2"}
            group_msgs = await asyncio.wait_for(
                asyncio.gather(ta, tb), timeout=2)
            assert {m.value for m in group_msgs} == {b"j1", b"j2"}
        finally:
            for c in (worker_a, worker_b, audit):
                await c.close()
            await server.close()

    @async_test
    async def test_wildcard_subscription(self, m):
        server = m.MiniNATSServer()
        await server.start()
        client = m.NATSClient(port=server.port)
        await client.connect()
        try:
            task = asyncio.ensure_future(client.subscribe("orders.>", ""))
            await asyncio.sleep(0.05)
            await client.publish("orders.created.eu", b"x")
            msg = await asyncio.wait_for(task, 2)
            assert msg.topic == "orders.created.eu"
        finally:
            await client.close()
            await server.close()


    @async_test
    async def test_connection_loss_wakes_consumer_and_reconnects(self, m):
        NATSError = m.NATSError
        server = m.MiniNATSServer()
        await server.start()
        port = server.port
        client = m.NATSClient(port=port)
        await client.connect()
        task = asyncio.ensure_future(client.subscribe("t", ""))
        await asyncio.sleep(0.05)
        await server.close()  # broker dies while consumer is blocked
        with pytest.raises(NATSError):
            await asyncio.wait_for(task, timeout=3)  # wakes, no hang
        # broker comes back on the same port: client self-heals
        server2 = m.MiniNATSServer(port=port)
        await server2.start()
        try:
            task2 = asyncio.ensure_future(client.subscribe("t", ""))
            await asyncio.sleep(0.1)
            await client.publish("t", b"back")
            msg = await asyncio.wait_for(task2, timeout=3)
            assert msg.value == b"back"
        finally:
            await client.close()
            await server2.close()


class TestMQTT:
    """``pubsub/mqtt``: QoS 0/1, wildcards, retained messages."""

    @pytest.fixture(params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("mqtt", request.param)

    @async_test
    async def test_pub_sub_qos1_roundtrip(self, m):
        broker = m.MiniMQTTBroker()
        await broker.start()
        client = m.MQTTClient(port=broker.port, qos=1)
        await client.connect()
        try:
            await client._ensure_sub("sensors/temp")
            await client.publish("sensors/temp", {"c": 21.5})
            msg = await asyncio.wait_for(
                client.subscribe("sensors/temp"), timeout=2)
            assert msg.bind() == {"c": 21.5}
            msg.commit()  # sends PUBACK for the inbound QoS1 message
            assert client.health_check()["status"] == "UP"
        finally:
            await client.close()
            await broker.close()

    @async_test
    async def test_wildcard_and_two_clients(self, m):
        broker = m.MiniMQTTBroker()
        await broker.start()
        alice = m.MQTTClient(port=broker.port, client_id="alice")
        bob = m.MQTTClient(port=broker.port, client_id="bob")
        await alice.connect()
        await bob.connect()
        try:
            await bob._ensure_sub("chat/+/msg")
            await alice.publish("chat/room1/msg", b"hi")
            msg = await asyncio.wait_for(bob.subscribe("chat/+/msg"), 2)
            assert msg.topic == "chat/room1/msg"
            assert msg.value == b"hi"
        finally:
            await alice.close()
            await bob.close()
            await broker.close()

    @async_test
    async def test_retained_message_replays_to_new_subscriber(self, m):
        broker = m.MiniMQTTBroker()
        await broker.start()
        publisher = m.MQTTClient(port=broker.port, client_id="p", retain=True)
        await publisher.connect()
        await publisher.publish("config/mode", b"serving")
        late = m.MQTTClient(port=broker.port, client_id="late")
        await late.connect()
        try:
            msg = await asyncio.wait_for(late.subscribe("config/#"), 2)
            assert msg.topic == "config/mode"
            assert msg.value == b"serving"
        finally:
            await publisher.close()
            await late.close()
            await broker.close()

    @async_test
    async def test_qos0_no_ack(self, m):
        broker = m.MiniMQTTBroker()
        await broker.start()
        client = m.MQTTClient(port=broker.port, qos=0)
        await client.connect()
        try:
            await client._ensure_sub("t")
            await client.publish("t", b"fire-and-forget")
            msg = await asyncio.wait_for(client.subscribe("t"), 2)
            assert msg.value == b"fire-and-forget"
        finally:
            await client.close()
            await broker.close()


class TestBackendSelection:
    def test_env_selects_nats(self):
        c = Container.create(DictConfig({"PUBSUB_BACKEND": "NATS",
                                         "PUBSUB_BROKER": "10.0.0.9:5222"}))
        assert type(c.pubsub).__name__ == "NATSClient"
        assert (c.pubsub.host, c.pubsub.port) == ("10.0.0.9", 5222)
        assert c.pubsub in c._deferred_connects  # async connect deferred

    def test_broker_addr_tolerates_scheme_and_bare_host(self):
        c = Container.create(DictConfig({"PUBSUB_BACKEND": "NATS",
                                         "PUBSUB_BROKER": "nats://h1:9000"}))
        assert (c.pubsub.host, c.pubsub.port) == ("h1", 9000)
        c2 = Container.create(DictConfig({"PUBSUB_BACKEND": "NATS",
                                          "PUBSUB_BROKER": "justahost"}))
        assert (c2.pubsub.host, c2.pubsub.port) == ("justahost", 4222)

    def test_mqtt_qos_clamped_to_implemented_range(self):
        c = Container.create(DictConfig({"PUBSUB_BACKEND": "MQTT",
                                         "MQTT_QOS": "2"}))
        assert c.pubsub.qos == 1

    def test_env_selects_mqtt(self):
        c = Container.create(DictConfig({"PUBSUB_BACKEND": "MQTT",
                                         "MQTT_PORT": "2883",
                                         "MQTT_QOS": "0"}))
        assert type(c.pubsub).__name__ == "MQTTClient"
        assert c.pubsub.port == 2883
        assert c.pubsub.qos == 0

    def test_env_selects_memory(self):
        c = Container.create(DictConfig({"PUBSUB_BACKEND": "MEMORY"}))
        assert type(c.pubsub).__name__ == "InMemoryBroker"

    @async_test
    async def test_connect_async_failure_leaves_store_down(self):
        c = Container.create(DictConfig({"PUBSUB_BACKEND": "NATS",
                                         "PUBSUB_BROKER": "127.0.0.1:1"}))
        await c.connect_async()  # refused connection: logged, not raised
        assert c.pubsub.health_check()["status"] == "DOWN"
        assert c._deferred_connects == []


# --------------------------------------------- end-to-end subscriber runtime
@async_test
async def test_subscriber_runtime_over_nats():
    """App-style flow: the port's SubscriptionManager pulls from a NATS
    server and drives a handler with commit-on-success."""
    from gofr_tpu_torch.pubsub.subscriber import SubscriptionManager

    server = port_nats.MiniNATSServer()
    await server.start()
    container = Container.create(DictConfig({}))
    client = port_nats.NATSClient(port=server.port)
    container.add_pubsub(client)
    await container.connect_async()

    received = asyncio.Event()
    seen = []

    async def handler(ctx):
        seen.append(ctx.bind())
        received.set()
        return None

    manager = SubscriptionManager(container)
    task = asyncio.ensure_future(manager.start_subscriber("events", handler))
    try:
        await asyncio.sleep(0.1)  # subscriber loop issues SUB
        await client.publish("events", {"kind": "ping"})
        await asyncio.wait_for(received.wait(), timeout=3)
        assert seen == [{"kind": "ping"}]
    finally:
        task.cancel()
        await client.close()
        await server.close()


async def _group_reads(kafka, topics: list, wait_s: float) -> dict:
    """One client, one group, a subscriber per topic (as the subscriber
    runtime runs them): topic -> the values read within ``wait_s``."""
    broker = port_kafka.MiniKafkaBroker()
    await broker.start()
    addr = f"127.0.0.1:{broker.port}"
    client = kafka.KafkaClient(addr, group_id="jobs")
    producer = kafka.KafkaClient(addr)
    got: dict = {t: [] for t in topics}

    async def consume(topic):
        while True:
            msg = await client.subscribe(topic, "jobs")
            got[topic].append(msg.value)
            msg.commit()
    tasks = [asyncio.ensure_future(consume(t)) for t in topics]
    try:
        for t in topics:
            for i in range(2):
                await producer.publish(t, f"{t}-{i}")
        deadline = asyncio.get_running_loop().time() + wait_s
        while asyncio.get_running_loop().time() < deadline and \
                any(len(v) < 2 for v in got.values()):
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.05)   # the commits land
        group = broker.groups["jobs"]
        return {t: (got[t], group.offsets.get((t, 0))) for t in topics}
    finally:
        for task in tasks:
            task.cancel()
        await client.close()
        await producer.close()
        await broker.close()


@async_test
async def test_one_group_reads_several_topics():
    """A consumer group with a subscriber on each of four topics (the
    app's ``subscribe`` on four topics under ``KAFKA_CONSUMER_GROUP``)
    reads and commits every topic: each member's consumer has a
    connection of its own, and the leader assigns each topic to the
    members that subscribe to it. JAX's client leaves the group's
    other topics unread (its leader assigns only its own topic)."""
    topics = [f"jobs-{i}" for i in range(4)]
    port = await _group_reads(port_kafka, topics, 10.0)
    assert port == {t: ([f"{t}-0".encode(), f"{t}-1".encode()], 2)
                    for t in topics}
    jax = await _group_reads(jax_kafka, topics, 2.0)
    assert sum(len(values) == 2 for values, _ in jax.values()) < 4


# ------------------------------------------------------ scripted sessions
def _msg(m) -> tuple:
    return (m.topic, m.key, m.value, dict(getattr(m, "metadata", {}) or {}))


def _error(exc) -> tuple:
    return ("error", type(exc).__name__, str(exc))


async def _kafka_session(p: Pair) -> list:
    broker = p.MiniKafkaBroker(default_partitions=2)
    await broker.start()
    addr = f"127.0.0.1:{broker.port}"
    client = p.KafkaClient(addr, group_id="g")
    out: list = []
    try:
        await client.publish("t", {"id": 1}, key="k1")
        await client.publish("t", "two", key="k1")
        await client.publish("t", b"three", key="k1")
        out.append(sorted(len(log) for log in broker.logs["t"]))
        for _ in range(3):
            msg = await asyncio.wait_for(client.subscribe("t", "g"), 10)
            out.append(_msg(msg))
            msg.commit()
        await asyncio.sleep(0.05)
        out.append(sorted(broker.groups["g"].offsets.values()))
        await client.create_topic_async("adm", partitions=3)
        out.append(len(broker.logs["adm"]))
        try:
            await client.publish("", "x")
        except Exception as exc:  # noqa: BLE001 — the typed error
            out.append(_error(exc))
        health = client.health_check()
        out.append((health["status"], health["details"]["group"]))
    finally:
        await client.close()
        await broker.close()
    dead = p.KafkaClient(f"127.0.0.1:{dead_port()}")
    try:
        await dead.connect()
    except Exception as exc:  # noqa: BLE001 — the typed error
        out.append(type(exc).__name__)
    return out


async def _nats_session(p: Pair) -> list:
    server = p.MiniNATSServer()
    await server.start()
    a, b = p.NATSClient(port=server.port, name="a"), \
        p.NATSClient(port=server.port, name="b")
    out: list = []
    try:
        for c in (a, b):
            await c.connect()
        plain = asyncio.ensure_future(a.subscribe("orders.>", ""))
        group = asyncio.ensure_future(b.subscribe("orders.created", "w"))
        await asyncio.sleep(0.05)
        await b.publish("orders.created", {"id": 9})
        out.append(_msg(await asyncio.wait_for(plain, 5)))
        out.append(_msg(await asyncio.wait_for(group, 5)))
        out.append(a.health_check()["status"])
        blocked = asyncio.ensure_future(a.subscribe("t", ""))
        await asyncio.sleep(0.05)
        await server.close()
        try:
            await asyncio.wait_for(blocked, 5)
        except Exception as exc:  # noqa: BLE001 — the typed error
            out.append(_error(exc))
    finally:
        for c in (a, b):
            await c.close()
        await server.close()
    return out


async def _jetstream_session(p: Pair) -> list:
    server = p.MiniJetStreamServer()
    await server.start()
    client = p.JetStreamClient(port=server.port, ack_wait_s=0.3)
    out: list = []
    try:
        await client.publish("orders.created", {"n": 1})
        await client.publish("orders.created", "two")
        out.append(len(server.streams["orders_created"].messages))
        first = await asyncio.wait_for(
            client.subscribe("orders.created", "eu.w"), 10)
        out.append(_msg(first))                 # not acked: redelivers
        await asyncio.sleep(0.4)
        for _ in range(2):
            msg = await asyncio.wait_for(
                client.subscribe("orders.created", "eu.w"), 10)
            out.append(_msg(msg))
            msg.commit()
        await asyncio.sleep(0.05)
        out.append(sorted(server.consumers))
        out.append(client.health_check()["backend"])
    finally:
        await client.close()
        await server.close()
    return out


async def _mqtt_session(p: Pair) -> list:
    broker = p.MiniMQTTBroker()
    await broker.start()
    pub = p.MQTTClient(port=broker.port, client_id="p", retain=True)
    sub = p.MQTTClient(port=broker.port, client_id="s", qos=1)
    out: list = []
    try:
        await pub.connect()
        await pub.publish("config/mode", b"serving")
        await sub.connect()
        retained = await asyncio.wait_for(sub.subscribe("config/#"), 5)
        out.append(_msg(retained))
        await sub._ensure_sub("chat/+/msg")
        await pub.publish("chat/room1/msg", {"hi": 1})
        msg = await asyncio.wait_for(sub.subscribe("chat/+/msg"), 5)
        out.append(_msg(msg))
        msg.commit()
        out.append(sub.health_check()["status"])
    finally:
        await pub.close()
        await sub.close()
        await broker.close()
    dead = p.MQTTClient(port=dead_port(), client_id="d")
    try:
        await dead.connect()
    except Exception as exc:  # noqa: BLE001 — the typed error
        out.append(type(exc).__name__)
    return out


async def _google_session(p: Pair) -> list:
    emu = p.MiniPubSubEmulator()
    await emu.start()
    client = p.GooglePubSubClient(f"127.0.0.1:{emu.port}", project="p")
    out: list = []
    try:
        await client._ensure_subscription("orders", "g-orders")
        await client.publish("orders", {"id": 7}, key="k",
                             metadata={"source": "web"})
        msg = await asyncio.wait_for(client.subscribe("orders", "g"), 10)
        out.append((msg.topic, msg.key, msg.value,
                    {k: v for k, v in msg.metadata.items()}))
        msg.commit()
        await asyncio.sleep(0.05)
        out.append(len(emu.subs["g-orders"]["outstanding"]))
        try:
            await client._call("POST", client._sub_path("missing")
                               + ":pull", {"maxMessages": 1})
        except Exception as exc:  # noqa: BLE001 — the typed error
            out.append((type(exc).__name__, "404" in str(exc)))
        out.append(client.health_check()["status"])
    finally:
        await client.close()
        await emu.close()
    return out


async def _eventhub_session(p: Pair) -> list:
    kafka = Pair("kafka", (p.client, p.server))
    broker = kafka.MiniKafkaBroker()
    await broker.start()
    client = p.EventHubClient(namespace=f"127.0.0.1:{broker.port}",
                              eventhub="telemetry")
    try:
        await client.publish(value={"reading": 42})
        msg = await asyncio.wait_for(client.subscribe(), 15)
        health = client.health_check()
        return [_msg(msg), health["status"], health["backend"],
                health["details"]["eventhub"]]
    finally:
        await client.close()
        await broker.close()


SESSIONS = {"kafka": _kafka_session, "nats": _nats_session,
            "jetstream": _jetstream_session, "mqtt": _mqtt_session,
            "google": _google_session, "eventhub": _eventhub_session}


@pytest.mark.parametrize("direction", PAIRS[1:], ids=PAIR_IDS[1:])
@pytest.mark.parametrize("protocol", list(SESSIONS))
def test_cross_session_matches_jax(protocol, direction):
    """The port's client on JAX's server, and JAX's client on the port's,
    see what JAX's client on JAX's server sees: the same messages (topic,
    key, bytes, attributes), offsets, redeliveries, health and typed
    errors (an empty topic, a dead broker, a missing subscription, a
    connection lost under a blocked consumer)."""
    session = SESSIONS[protocol]
    want = asyncio.run(session(Pair(protocol, ("jax", "jax"))))
    got = asyncio.run(session(Pair(protocol, direction)))
    assert got == want


def test_app_stop_closes_every_wire_client():
    """An app booted on the Postgres wire, RESP and Kafka (a subscriber
    on a topic, so a consumer connection too) holds connections to each
    Mini server while it runs, and ``App.stop`` leaves none open."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.datasource.postgres_wire import MiniPostgresServer
    from gofr_tpu_torch.datasource.redis_wire import MiniRedisServer

    from .torch_parity import AppThread
    from .torch_wire import LoopThread, open_connections, wait_until

    pg, rd = MiniPostgresServer(user="app", password="pw"), MiniRedisServer()
    pg.start()
    rd.start()
    loop = LoopThread()
    broker = port_kafka.MiniKafkaBroker()
    loop.run(broker.start())
    ports = (pg.port, rd.port, broker.port)
    try:
        app = App(config=DictConfig({
            "HTTP_PORT": "0", "METRICS_PORT": "0",
            "DB_DIALECT": "postgres", "DB_HOST": "127.0.0.1",
            "DB_PORT": str(pg.port), "DB_USER": "app", "DB_PASSWORD": "pw",
            "REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(rd.port),
            "REDIS_MODE": "network", "PUBSUB_BACKEND": "KAFKA",
            "PUBSUB_BROKER": f"127.0.0.1:{broker.port}"}))
        app.subscribe("jobs", lambda ctx: None)
        with AppThread(app):
            assert wait_until(lambda: all(open_connections(p) for p in ports))
            assert app.container.health()["checks"]["pubsub"]["status"] == "UP"
        assert wait_until(lambda: not any(open_connections(p)
                                          for p in ports), timeout=2)
    finally:
        loop.run(broker.close())
        loop.close()
        pg.close()
        rd.close()
