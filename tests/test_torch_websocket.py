"""The port's websocket layer (``gofr_tpu_torch/websocket/``) against the
JAX package's (``gofr_tpu/websocket/``): the frame codec on the same
seeded bytes (unmasked frames byte for byte, masked frames decoded to
the same payloads, the same ``accept_key`` and close payloads), then the
wire across packages — JAX's ``connect`` against the port's ``App`` and
the port's ``connect`` against JAX's ``App`` (and the port against
itself), following ``tests/test_websocket.py``: echo, bind, streaming,
error recovery, ping and large messages, 426, unknown paths, the auth
handshake, user middleware ahead of the upgrade, broadcast, and the
outbound ``WSService``. Last, what the port adds: a socket outlives
``REQUEST_TIMEOUT``, and ``stop`` closes every socket.
"""

from __future__ import annotations

import asyncio
import base64
import json
import struct
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import pytest

import gofr_tpu.websocket as jax_ws
import gofr_tpu.websocket.frames as jax_frames
import gofr_tpu_torch.websocket as port_ws
import gofr_tpu_torch.websocket.frames as port_frames
from gofr_tpu.websocket.service import WSService as JaxWSService
from gofr_tpu_torch.websocket.service import WSService as PortWSService

from .apputil import AppRunner
from .torch_parity import AppThread

WS = {"jax": jax_ws, "port": port_ws}
#: (client package, server package)
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]
FRAMES = {"jax": jax_frames, "port": port_frames}


def run(coro, timeout: float = 20.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ---------------------------------------------------------------- frames
def _payloads(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 1, 125, 126, 127, 1000, 65535, 65536, 70001)]


async def _decode(mod, data: bytes, require_mask: bool) -> list:
    reader = asyncio.StreamReader()
    reader.feed_data(data)
    reader.feed_eof()
    frames = []
    while True:
        frame = await mod.read_frame(reader, require_mask=require_mask)
        if frame is None:
            return frames
        frames.append((frame.opcode, frame.payload, frame.fin))


@pytest.mark.parametrize("seed", [0, 1])
def test_unmasked_frames_equal_jax_byte_for_byte(seed):
    for payload in _payloads(seed):
        for opcode in (port_frames.OP_TEXT, port_frames.OP_BINARY,
                       port_frames.OP_CONT):
            for fin in (True, False):
                assert port_frames.encode_frame(opcode, payload, fin=fin) \
                    == jax_frames.encode_frame(opcode, payload, fin=fin)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_frames_decode_alike_across_packages(seed):
    """A masked frame of either package decodes, in either package, to
    its payload; a mask the other side does not expect is refused."""
    payloads = _payloads(seed)
    for enc in ("jax", "port"):
        wire = b"".join(FRAMES[enc].encode_frame(port_frames.OP_BINARY, p,
                                                 mask=True)
                        for p in payloads)
        want = [(port_frames.OP_BINARY, p, True) for p in payloads]
        for dec in ("jax", "port"):
            assert run(_decode(FRAMES[dec], wire, True)) == want
            with pytest.raises(FRAMES[dec].WSProtocolError):
                run(_decode(FRAMES[dec], wire, False))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_accept_key_and_close_payloads_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        key = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        data = rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
        assert port_frames.apply_mask(data, key) == \
            jax_frames.apply_mask(data, key)
        client_key = base64.b64encode(
            rng.integers(0, 256, 16, dtype=np.uint8).tobytes()).decode()
        assert port_frames.accept_key(client_key) == \
            jax_frames.accept_key(client_key)
        code = int(rng.integers(1000, 5000))
        reason = "".join(chr(97 + int(c))
                         for c in rng.integers(0, 26, int(rng.integers(0, 200))))
        payload = port_frames.close_payload(code, reason)
        assert payload == jax_frames.close_payload(code, reason)
        assert port_frames.parse_close(payload) == \
            jax_frames.parse_close(payload)
    # RFC 6455 1.3's worked example
    assert port_frames.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    assert port_frames.parse_close(b"") == jax_frames.parse_close(b"")


def test_protocol_errors_equal_jax():
    """RSV bits, fragmented control frames and oversized frames."""
    cases = [bytes([0xC1, 0x00]),                       # RSV1 set
             bytes([0x09, 0x00]),                       # ping without FIN
             bytes([0x82, 127]) + struct.pack(">Q", (16 << 20) + 1)]
    for data in cases:
        got = []
        for mod in (jax_frames, port_frames):
            with pytest.raises(mod.WSProtocolError) as err:
                run(_decode(mod, data, False))
            got.append((str(err.value), err.value.code))
        assert got[0] == got[1]


# ------------------------------------------------------------ the wire
@dataclass
class ChatMessage:
    user: str
    text: str


def build_echo(app):
    """``tests/test_websocket.py``'s handlers, for either package's app."""
    @app.websocket("/ws/echo")
    def echo(ctx):
        return {"echo": ctx.bind(str)}

    @app.websocket("/ws/chat/{room}")
    def chat(ctx):
        msg = ctx.bind(ChatMessage)
        return {"room": ctx.path_param("room"), "from": msg.user,
                "text": msg.text.upper()}

    @app.websocket("/ws/stream")
    async def stream(ctx):
        n = int(ctx.bind(str))
        for i in range(n):
            await ctx.write_message_to_socket({"token": i})
        return {"done": n}

    @app.websocket("/ws/boom")
    def boom(ctx):
        raise ValueError("handler exploded")

    @app.get("/announce")
    async def announce(ctx):
        return {"sent": await ctx.ws_manager.broadcast({"announcement": "hi"})}


def _http_status(port: int, path: str, headers=None) -> int:
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=20)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


@contextmanager
def served(pkg: str, build, config: dict | None = None):
    """(HTTP port, app) of ``pkg``'s App built by ``build``."""
    cfg = {"HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "ws-test",
           **(config or {})}
    if pkg == "jax":
        with AppRunner(config=cfg, build=build) as r:
            yield r.port, r.app
        return
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    app = App(config=DictConfig(cfg))
    build(app)
    with AppThread(app) as t:
        yield t.port, app


async def _text(conn) -> dict:
    message = await conn.recv()
    assert message is not None
    return json.loads(message.text())


@pytest.mark.parametrize("client,server", PAIRS)
def test_echo_bind_and_path_params(client, server):
    with served(server, build_echo) as (port, _):
        async def go():
            conn = await WS[client].connect(f"ws://127.0.0.1:{port}/ws/echo")
            await conn.send("hello")
            assert await _text(conn) == {"echo": "hello"}
            await conn.close()
            conn = await WS[client].connect(
                f"ws://127.0.0.1:{port}/ws/chat/gpu")
            await conn.send({"user": "ada", "text": "hi"})
            assert await _text(conn) == {"room": "gpu", "from": "ada",
                                         "text": "HI"}
            await conn.close()
        run(go())


@pytest.mark.parametrize("client,server", PAIRS)
def test_streaming_and_error_recovery(client, server):
    with served(server, build_echo) as (port, _):
        async def go():
            conn = await WS[client].connect(
                f"ws://127.0.0.1:{port}/ws/stream")
            await conn.send("3")
            assert [await _text(conn) for _ in range(4)] == [
                {"token": 0}, {"token": 1}, {"token": 2}, {"done": 3}]
            await conn.close()
            conn = await WS[client].connect(f"ws://127.0.0.1:{port}/ws/boom")
            await conn.send("x")
            assert await _text(conn) == {"error": "internal server error"}
            await conn.send("y")      # the socket survives the error
            assert await _text(conn) == {"error": "internal server error"}
            await conn.close()
        run(go())


@pytest.mark.parametrize("client,server", PAIRS)
def test_ping_and_large_message(client, server):
    with served(server, build_echo) as (port, _):
        async def go():
            conn = await WS[client].connect(f"ws://127.0.0.1:{port}/ws/echo")
            await conn.ping(b"hb")
            big = "x" * 70000
            await conn.send(big)
            assert (await _text(conn))["echo"] == big
            await conn.close()
        run(go())


@pytest.mark.parametrize("client,server", PAIRS)
def test_plain_get_426_and_unknown_path(client, server):
    with served(server, build_echo) as (port, _):
        assert _http_status(port, "/ws/echo") == 426

        async def go():
            with pytest.raises(WS[client].WSHandshakeError):
                await WS[client].connect(f"ws://127.0.0.1:{port}/ws/nope")
        run(go())


@pytest.mark.parametrize("client,server", PAIRS)
def test_auth_handshake(client, server):
    def build(app):
        app.enable_basic_auth(alice="pw")
        build_echo(app)

    with served(server, build) as (port, _):
        token = base64.b64encode(b"alice:pw").decode()

        async def go():
            with pytest.raises(WS[client].WSHandshakeError, match="401"):
                await WS[client].connect(f"ws://127.0.0.1:{port}/ws/echo")
            conn = await WS[client].connect(
                f"ws://127.0.0.1:{port}/ws/echo",
                headers={"Authorization": f"Basic {token}"})
            await conn.send("hi")
            assert await _text(conn) == {"echo": "hi"}
            await conn.close()
        run(go())


@pytest.mark.parametrize("client,server", PAIRS)
def test_user_middleware_runs_before_the_handshake(client, server):
    def build(app):
        build_echo(app)
        if server == "jax":
            from gofr_tpu.http.responder import ResponseData
        else:
            from gofr_tpu_torch.http.responder import ResponseData

        def deny(next_handler):
            async def wrapped(request):
                if request.header("x-tenant") != "good":
                    return ResponseData(status=403, body=b"denied")
                return await next_handler(request)
            return wrapped
        app.use_middleware(deny)

    with served(server, build) as (port, _):
        async def go():
            with pytest.raises(WS[client].WSHandshakeError, match="403"):
                await WS[client].connect(f"ws://127.0.0.1:{port}/ws/echo")
            conn = await WS[client].connect(f"ws://127.0.0.1:{port}/ws/echo",
                                            headers={"X-Tenant": "good"})
            await conn.send("hi")
            assert await _text(conn) == {"echo": "hi"}
            await conn.close()
        run(go())


@pytest.mark.parametrize("client,server", PAIRS)
def test_broadcast_reaches_every_socket(client, server):
    with served(server, build_echo) as (port, app):
        async def go():
            socks = [await WS[client].connect(
                f"ws://127.0.0.1:{port}/ws/echo") for _ in range(3)]
            for _ in range(200):
                if len(app.container.ws_manager) == 3:
                    break
                await asyncio.sleep(0.01)
            reply = await asyncio.to_thread(_get_json, port, "/announce")
            assert reply == {"data": {"sent": 3}}
            for conn in socks:
                assert await _text(conn) == {"announcement": "hi"}
                await conn.close()
        run(go())


def _get_json(port: int, path: str):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=20)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_outbound_service_sends_and_receives(client, server):
    service_cls = {"jax": JaxWSService, "port": PortWSService}[client]
    with served(server, build_echo) as (port, _):
        async def go():
            got: list = []
            arrived = asyncio.Event()

            def on_message(msg):
                got.append(msg.text())
                arrived.set()
            service = service_cls("peer", f"ws://127.0.0.1:{port}/ws/echo",
                                  retry_interval=0.2, on_message=on_message)
            await service.start()
            assert await service.wait_connected(10)
            await service.send("ping")
            await asyncio.wait_for(arrived.wait(), 10)
            assert json.loads(got[0]) == {"echo": "ping"}
            await service.stop()
            assert not service.connected
        run(go())


def test_port_service_reports_disconnected():
    async def go():
        service = PortWSService("down", "ws://127.0.0.1:9/ws",
                                retry_interval=5)
        with pytest.raises(ConnectionError):
            await service.send("x")
    run(go())


# --------------------------------------------------------- port-only
def test_app_ws_service_is_registered_started_and_stopped():
    """``App.add_ws_service``: in the container, connected once the app
    is up (to the app's own echo route), stopped with the app."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    with served("port", build_echo) as (port, _):
        peer = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
        service = peer.add_ws_service("echo", f"ws://127.0.0.1:{port}/ws/echo",
                                      retry_interval=0.2)
        assert peer.container.get_ws_service("echo") is service
        with AppThread(peer) as t:
            assert t.call(service.wait_connected(10))
            t.call(service.send("over"))
        assert not service.connected


def test_socket_outlives_request_timeout():
    """``REQUEST_TIMEOUT`` bounds handlers, not a hijacked socket: the
    upgrade's request is answered (101) at once, and the socket serves on
    long past the timeout."""
    with served("port", build_echo, {"REQUEST_TIMEOUT": "0.2"}) as (port, _):
        async def go():
            conn = await port_ws.connect(f"ws://127.0.0.1:{port}/ws/echo")
            await asyncio.sleep(0.6)
            await conn.send("late")
            assert await _text(conn) == {"echo": "late"}
            await conn.close()
        run(go())


def test_stop_closes_every_socket():
    """``App.stop`` closes the sockets (close code 1001) before the
    servers go, and empties the manager."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
    build_echo(app)
    with AppThread(app) as t:
        port = t.port

        async def go():
            socks = [await port_ws.connect(f"ws://127.0.0.1:{port}/ws/echo")
                     for _ in range(3)]
            for _ in range(200):
                if len(app.container.ws_manager) == 3:
                    break
                await asyncio.sleep(0.01)
            assert len(app.container.ws_manager) == 3
            await asyncio.to_thread(t.call, app.stop())
            return [(await c.recv(), c.close_code) for c in socks]
        got = run(go())
    assert got == [(None, 1001)] * 3
    assert len(app.container.ws_manager) == 0


def test_write_message_to_socket_needs_a_socket():
    from gofr_tpu_torch.container.container import Container
    from gofr_tpu_torch.context import Context
    ctx = Context(request=None, container=Container())
    with pytest.raises(RuntimeError, match="not a websocket context"):
        run(ctx.write_message_to_socket("x"))
