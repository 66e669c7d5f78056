"""The port's RESP2 client and Mini server (``datasource/redis_wire.py``)
against the JAX package's: every case of the JAX tests runs three ways
(the port on itself, the port's client on JAX's server, JAX's client on
the port's server: ``torch_wire.PAIRS``) over loopback sockets; then the
fragmentation and hostile-value cases, and one scripted session whose
replies and typed errors in both cross directions equal JAX's on JAX's.
"""

import pytest

from .torch_wire import PAIR_IDS, PAIRS, Pair


class TestRedisWire:
    """``redis_wire``: RESP2 framing, the command surface, redial on use."""

    @pytest.fixture(params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("redis", request.param)

    @pytest.fixture()
    def server(self, m):
        srv = m.MiniRedisServer()
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def client(self, m, server):
        c = m.RedisWire(host="127.0.0.1", port=server.port)
        c.connect()
        yield c
        c.close()

    def test_encode_command_resp2_frame(self, m):
        assert m.encode_command("SET", "k", "v") == \
            b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n"


    def test_strings_and_counters(self, m, client):
        assert client.ping()
        assert client.set("k", "hello")
        assert client.get("k") == "hello"
        assert client.get("missing") is None
        assert client.incr("n") == 1
        assert client.incr("n", 4) == 5
        assert client.decr("n") == 4
        assert client.delete("k", "n") == 2
        assert client.exists("k") == 0


    def test_expiry_over_the_wire(self, m, client):
        client.set("tmp", "x", ex=100)
        assert 0 < client.ttl("tmp") <= 100
        assert client.expire("tmp", 50)
        assert client.ttl("tmp") <= 50
        assert client.ttl("nope") == -2


    def test_hashes_lists_sets(self, m, client):
        client.hset("h", "a", "1")
        client.hset("h", "b", "2")
        assert client.hget("h", "a") == "1"
        assert client.hgetall("h") == {"a": "1", "b": "2"}
        assert client.hdel("h", "a") == 1

        client.rpush("l", "x", "y", "z")
        assert client.llen("l") == 3
        assert client.lrange("l", 0, -1) == ["x", "y", "z"]
        assert client.lpop("l") == "x"
        assert client.rpop("l") == "z"

        client.sadd("s", "a", "b")
        assert client.sismember("s", "a")
        assert client.smembers("s") == {"a", "b"}
        assert client.srem("s", "a") == 1


    def test_keys_and_flush(self, m, client):
        client.set("user:1", "x")
        client.set("user:2", "y")
        client.set("other", "z")
        assert sorted(client.keys("user:*")) == ["user:1", "user:2"]
        assert client.flushdb()
        assert client.keys() == []


    def test_server_error_is_raised_not_fatal(self, m, client):
        client.set("str", "x")
        with pytest.raises(m.RESP2Error):
            client.execute("HGET", "no")  # wrong arity -> -ERR reply
        # connection survives a server-side error
        assert client.get("str") == "x"


    def test_wrongtype_error(self, m, client):
        client.set("str", "x")
        with pytest.raises(m.RESP2Error, match="WRONGTYPE"):
            client.hset("str", "f", "v")


    def test_reconnects_after_server_restart(self, m, server, client):
        client.set("k", "1")
        server.close()
        with pytest.raises((m.RESP2Error, OSError)):
            client.get("k")
        # replacement server (fresh port — TIME_WAIT keeps the old one);
        # the client redials on next use
        srv2 = m.MiniRedisServer()
        srv2.start()
        client.port = srv2.port
        try:
            srv2.engine.set("k", "2")
            assert client.get("k") == "2"
        finally:
            srv2.close()


    def test_health_check_up_down(self, m, server, client):
        assert client.health_check()["status"] == "UP"
        server.close()
        assert client.health_check()["status"] == "DOWN"


    def test_new_redis_mode_switch(self, m, server):
        DictConfig = m.side("config.env").DictConfig
        cfg = DictConfig({"REDIS_HOST": "127.0.0.1",
                          "REDIS_PORT": str(server.port),
                          "REDIS_MODE": "network"})
        r = m.side("datasource.redis").new_redis(cfg)
        assert isinstance(r, m.RedisWire)
        assert r.set("via-env", "ok") and r.get("via-env") == "ok"
        r.close()

        Redis = m.side("datasource.redis").Redis
        r2 = m.side("datasource.redis").new_redis(
            DictConfig({"REDIS_HOST": "localhost"}))
        assert isinstance(r2, Redis)



@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_survives_byte_dribble(pair):
    """Commands and a 1000-byte bulk string over a proxy that forwards one
    byte at a time, both ways."""
    from .test_wire_fragmentation import DribbleProxy

    m = Pair("redis", pair)
    server = m.MiniRedisServer()
    server.start()
    proxy = DribbleProxy("127.0.0.1", server.port)
    try:
        r = m.RedisWire(host="127.0.0.1", port=proxy.port)
        r.connect()
        r.set("k", "v" * 1000)
        assert r.get("k") == "v" * 1000
        r.close()
    finally:
        proxy.close()
        server.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_roundtrip_matrix(pair):
    """Hostile strings round-trip byte for byte as values."""
    from .test_wire_roundtrip_matrix import ALL

    m = Pair("redis", pair)
    server = m.MiniRedisServer()
    server.start()
    client = m.RedisWire(host="127.0.0.1", port=server.port)
    client.connect()
    try:
        for i, value in enumerate(ALL):
            client.set(f"k{i}", value)
        assert [client.get(f"k{i}") for i in range(len(ALL))] == ALL
    finally:
        client.close()
        server.close()


def _redis_session(m) -> list:
    """One scripted session: strings, counters, expiry, hashes, lists,
    sets, keys, a wrong-type and an arity error, each reply as a plain
    value (a typed error by class name and message)."""
    server = m.MiniRedisServer()
    server.start()
    client = m.RedisWire(host="127.0.0.1", port=server.port)
    steps = [
        lambda: client.set("k", "hello"), lambda: client.get("k"),
        lambda: client.get("missing"), lambda: client.incr("n", 4),
        lambda: client.decr("n"), lambda: client.set("tmp", "x", ex=100),
        lambda: client.ttl("nope"), lambda: client.hset("h", "a", "1"),
        lambda: client.hgetall("h"), lambda: client.rpush("l", "x", "y"),
        lambda: client.lrange("l", 0, -1), lambda: client.sadd("s", "a"),
        lambda: sorted(client.smembers("s")),
        lambda: sorted(client.keys("*")),
        lambda: client.hset("k", "f", "v"),
        lambda: client.execute("HGET", "no"),
        lambda: client.delete("k", "n"), lambda: client.exists("k"),
        lambda: client.flushdb(), lambda: client.keys()]
    out = []
    try:
        client.connect()
        for step in steps:
            try:
                out.append(step())
            except Exception as exc:  # noqa: BLE001 — the error is the reply
                out.append(("error", type(exc).__name__, str(exc)))
        return out
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("direction", PAIRS[1:], ids=PAIR_IDS[1:])
def test_cross_session_matches_jax(direction):
    """The port's client on JAX's server, and JAX's client on the
    port's, get JAX-on-JAX's replies, typed errors included (WRONGTYPE,
    a wrong arity)."""
    want = _redis_session(Pair("redis", ("jax", "jax")))
    assert _redis_session(Pair("redis", direction)) == want
    assert sum(isinstance(r, tuple) and r[0] == "error" for r in want) == 2
