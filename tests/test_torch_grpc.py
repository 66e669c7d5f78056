"""The port's gRPC transport (``gofr_tpu_torch/grpc/``) against the JAX
package's (``gofr_tpu/grpc/``): each case of JAX's ``test_grpc.py`` runs
the same client code against a JAX app (``AppRunner``) and a port
``ChatServer`` serving the same service, written once against each
package's decorators; the reflection codec and its gate; protogen's
output against JAX's for the same ``.proto`` (after swapping the package
name), served on the port and called through the generated client.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import sys
import textwrap
import threading
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass

import grpc
import pytest

import gofr_tpu.grpc as jax_grpc
import gofr_tpu_torch.grpc as port_grpc
from gofr_tpu.grpc import health as jax_health
from gofr_tpu.grpc import protogen as jax_protogen
from gofr_tpu.grpc import reflection as jax_reflection
from gofr_tpu_torch.grpc import health as port_health
from gofr_tpu_torch.grpc import protogen as port_protogen
from gofr_tpu_torch.grpc import reflection as port_reflection
from gofr_tpu_torch.serving.app import ChatServer

from .apputil import AppRunner

BACKENDS = ("jax", "port")


@dataclass
class Greeting:
    name: str
    excited: bool = False


def make_greeter(pkg):
    """The JAX test's ``GreeterService`` on ``pkg``'s decorators."""

    class GreeterService(pkg.GRPCService):
        name = "gofr.test.Greeter"

        @pkg.rpc
        def SayHello(self, ctx, request):
            greeting = ctx.bind(Greeting)
            suffix = "!" if greeting.excited else "."
            return {"message": f"hello {greeting.name}{suffix}"}

        @pkg.rpc
        def WhoAmI(self, ctx, request):
            # the host is injected at registration
            return {"injected": self.container is not None,
                    "metadata_probe": ctx.param("x-probe")}

        @pkg.rpc
        def Boom(self, ctx, request):
            raise RuntimeError("kaboom")

        @pkg.server_stream_rpc
        async def CountTo(self, ctx, request):
            for i in range(int(request["n"])):
                yield {"i": i}

        @pkg.client_stream_rpc
        async def Sum(self, ctx, request_iterator):
            total = 0
            async for item in request_iterator:
                total += item["x"]
            return {"total": total}

        @pkg.bidi_stream_rpc
        async def EchoAll(self, ctx, request_iterator):
            async for item in request_iterator:
                yield {"echo": item}

    return GreeterService()


@contextmanager
def port_server(service, env=None):
    """A port ``ChatServer`` without an engine serving ``service`` over
    gRPC on a free port; yields (server, gRPC port)."""
    server = ChatServer(("127.0.0.1", 0), None)
    server.env = {"GRPC_PORT": "0", **(env or {})}
    server.register_grpc_service(service)
    server.start_grpc()
    thread = threading.Thread(target=server.serve_forever, args=(0.05,),
                              daemon=True)
    thread.start()
    try:
        yield server, server.grpc_server.bound_port
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


@contextmanager
def serving(backend, env=None, service=None):
    """(metrics text getter, gRPC port) of the Greeter on ``backend``."""
    if backend == "jax":
        svc = service or make_greeter(jax_grpc)
        with AppRunner(build=lambda app: app.register_grpc_service(svc),
                       config={"GRPC_PORT": "0", **(env or {})}) as r:
            def metrics():
                status, _, data = r.request("GET", "/metrics",
                                            port=r.metrics_port)
                assert status == 200
                return data.decode()
            yield metrics, r.app.grpc_server.bound_port
    else:
        with port_server(service or make_greeter(port_grpc), env) as (s, p):
            yield s.metrics.render_prometheus, p


#: a local subchannel pool: a recycled port must not reuse a dead
#: server's connection
LOCAL_POOL = (("grpc.use_local_subchannel_pool", 1),)


@contextmanager
def channel(port):
    chan = grpc.insecure_channel(f"127.0.0.1:{port}", options=LOCAL_POOL)
    try:
        grpc.channel_ready_future(chan).result(timeout=20)
        yield chan
    finally:
        chan.close()


def connect(port) -> port_grpc.GRPCClient:
    """The port's client on a connected channel of its own."""
    c = port_grpc.GRPCClient(f"127.0.0.1:{port}", options=LOCAL_POOL)
    grpc.channel_ready_future(c._chan()).result(timeout=20)
    return c


def _json_method(chan, kind, path):
    return getattr(chan, kind)(
        path, request_serializer=lambda o: json.dumps(o).encode(),
        response_deserializer=json.loads)


@pytest.mark.parametrize("backend", BACKENDS)
def test_unary_and_dataclass_bind(backend):
    with serving(backend) as (_, port):
        client = connect(port)
        try:
            assert client.call("gofr.test.Greeter", "SayHello",
                               {"name": "ada", "excited": True},
                               timeout=20) == {"message": "hello ada!"}
            assert client.call("gofr.test.Greeter", "SayHello",
                               {"name": "bo"}, timeout=20) \
                == {"message": "hello bo."}
        finally:
            client.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_container_injection_and_metadata(backend):
    with serving(backend) as (_, port), channel(port) as chan:
        method = chan.unary_unary(
            "/gofr.test.Greeter/WhoAmI",
            request_serializer=lambda o: b"{}",
            response_deserializer=json.loads)
        reply = method({}, metadata=(("x-probe", "42"),), timeout=20)
        assert reply == {"injected": True, "metadata_probe": "42"}


@pytest.mark.parametrize("backend", BACKENDS)
def test_server_streaming(backend):
    with serving(backend) as (_, port):
        client = connect(port)
        try:
            got = list(client.stream("gofr.test.Greeter", "CountTo",
                                     {"n": 4}, timeout=20))
        finally:
            client.close()
        assert got == [{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}]


@pytest.mark.parametrize("backend", BACKENDS)
def test_client_stream_and_bidi(backend):
    with serving(backend) as (_, port), channel(port) as chan:
        def gen():
            for x in (1, 2, 3):
                yield {"x": x}
        total = _json_method(chan, "stream_unary", "/gofr.test.Greeter/Sum")
        assert total(gen(), timeout=20) == {"total": 6}
        echo = _json_method(chan, "stream_stream",
                            "/gofr.test.Greeter/EchoAll")
        assert [g["echo"]["x"] for g in echo(gen(), timeout=20)] == [1, 2, 3]


@pytest.mark.parametrize("backend", BACKENDS)
def test_handler_error_maps_to_internal(backend):
    with serving(backend) as (_, port):
        client = connect(port)
        try:
            with pytest.raises(grpc.RpcError) as err:
                client.call("gofr.test.Greeter", "Boom", {}, timeout=20)
        finally:
            client.close()
        assert err.value.code() == grpc.StatusCode.INTERNAL
        assert "kaboom" in err.value.details()


@pytest.mark.parametrize("backend", BACKENDS)
def test_unknown_method_unimplemented(backend):
    with serving(backend) as (_, port):
        client = connect(port)
        try:
            with pytest.raises(grpc.RpcError) as err:
                client.call("gofr.test.Greeter", "Nope", {}, timeout=20)
        finally:
            client.close()
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED


@pytest.mark.parametrize("backend", BACKENDS)
def test_standard_health_protocol(backend):
    with serving(backend) as (_, port):
        client = connect(port)
        try:
            got = [client.health_check(s, timeout=20) for s in
                   ("", "gofr.test.Greeter", "no.such.Service")]
        finally:
            client.close()
        assert got == ["SERVING", "SERVING", "SERVICE_UNKNOWN"]


def test_health_reads_the_hosts_aggregate_and_watch_streams():
    """``""`` is the host's health: DOWN answers NOT_SERVING; ``Watch``
    sends the status at once and again each interval."""
    with port_server(make_greeter(port_grpc)) as (server, port):
        client = connect(port)
        try:
            server.health = lambda: {"status": "DOWN"}
            assert client.health_check("", timeout=20) == "NOT_SERVING"
            assert client.health_check("gofr.test.Greeter",
                                       timeout=20) == "SERVING"
            server.health = lambda: {"status": "DEGRADED"}
            assert client.health_check("", timeout=20) == "SERVING"
            watch = client._chan().unary_stream(
                "/grpc.health.v1.Health/Watch",
                request_serializer=port_health.encode_check_request,
                response_deserializer=port_health.decode_check_response)
            call = watch("gofr.test.Greeter", timeout=20)
            assert [next(call), next(call)] == [port_health.SERVING] * 2
            call.cancel()
        finally:
            client.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_metrics_recorded(backend):
    with serving(backend) as (metrics, port):
        client = connect(port)
        try:
            client.call("gofr.test.Greeter", "SayHello", {"name": "x"},
                        timeout=20)
            with pytest.raises(grpc.RpcError):
                client.call("gofr.test.Greeter", "Boom", {}, timeout=20)
        finally:
            client.close()
        text = metrics()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("app_grpc_server_duration_count")]
    ok = [ln for ln in lines if "SayHello" in ln and 'status="OK"' in ln]
    boom = [ln for ln in lines if "Boom" in ln and 'status="INTERNAL"' in ln]
    assert ok and boom, lines
    assert ok[0].split()[-1] == boom[0].split()[-1] == "1"
    buckets = sorted({ln.split('le="')[1].split('"')[0]
                      for ln in text.splitlines()
                      if ln.startswith("app_grpc_server_duration_bucket")})
    assert "0.005" in buckets and "10" in buckets and "+Inf" in buckets


def test_span_per_rpc_joins_the_traceparent():
    from gofr_tpu_torch.tracing import InMemoryExporter, Tracer
    exporter = InMemoryExporter()
    svc = make_greeter(port_grpc)
    with port_server(svc) as (server, port), channel(port) as chan:
        server.tracer = Tracer(exporter=exporter)
        parent = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        method = _json_method(chan, "unary_unary",
                              "/gofr.test.Greeter/SayHello")
        method({"name": "t"}, metadata=(("traceparent", parent),),
               timeout=20)
    spans = [s for s in exporter.spans
             if s.name == "/gofr.test.Greeter/SayHello"]
    assert len(spans) == 1
    assert spans[0].trace_id == "ab" * 16 and spans[0].parent_id == "cd" * 8


def test_typed_status_and_bind_failure():
    """A handler's ``exc.grpc_status`` is the answer's code; a failed
    bind raises naming ``GRPC_PORT``."""

    class Typed(port_grpc.GRPCService):
        name = "gofr.test.Typed"

        @port_grpc.rpc
        def Full(self, ctx, request):
            exc = RuntimeError("queue full")
            exc.grpc_status = grpc.StatusCode.RESOURCE_EXHAUSTED
            raise exc

    with port_server(Typed()) as (_, port):
        client = connect(port)
        try:
            with pytest.raises(grpc.RpcError) as err:
                client.call("gofr.test.Typed", "Full", {}, timeout=20)
        finally:
            client.close()
        assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert err.value.details() == "queue full"
        # an address no local interface holds (TEST-NET-1): the bind
        # fails, nothing is sent
        host = ChatServer(("127.0.0.1", 0), None)
        unbound = port_grpc.GRPCServer(host, port=9000, host="192.0.2.1")
        unbound.register(Typed())
        try:
            with pytest.raises(RuntimeError, match="GRPC_PORT"):
                unbound.start()
        finally:
            host.server_close()


def test_rpcs_past_32_reach_admission_while_health_answers():
    """More chat RPCs than the old fixed pool's 32 threads, held on a
    stopped engine (queued, never decoded): every one reaches
    ``engine.submit`` (queued, or the scheduler's typed refusal), and
    ``Health.Check("")`` answers within 3 s while they wait."""
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.serving.app import build_engine, build_server
    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.grpc_chat import make_chat_service
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    n = 40
    engine = build_engine(
        LlamaConfig.tiny().scaled(vocab_size=260), device="cpu",
        engine_config=EngineConfig(max_batch=2, max_seq=256, page_size=16,
                                   seed=0, prefix_cache=False))
    engine.waiting.reopen()          # queue, but never start decoding
    submitted = []
    inner = engine.submit

    def submit(*args, **kwargs):
        submitted.append(inner(*args, **kwargs))
        return submitted[-1]

    engine.submit = submit
    server = build_server(engine, ByteTokenizer(), env={"GRPC_PORT": "0"},
                          tenant_of=lambda md: "anonymous")
    server.register_grpc_service(make_chat_service(engine, ByteTokenizer()))
    server.start_grpc()
    calls = []
    try:
        with channel(server.grpc_server.bound_port) as chan:
            stream = _json_method(chan, "unary_stream",
                                  "/gofr.serving.Chat/Stream")
            calls = [stream({"prompt": f"held {i}", "max_tokens": 8},
                            timeout=60) for i in range(n)]
            deadline = time.time() + 30
            while len(submitted) < n and time.time() < deadline:
                time.sleep(0.01)
            assert len(submitted) == n, len(submitted)
            assert all(r.error is None or r.reject is not None
                       for r in submitted)
            client = port_grpc.GRPCClient(
                f"127.0.0.1:{server.grpc_server.bound_port}",
                options=LOCAL_POOL)
            try:
                t0 = time.perf_counter()
                status = client.health_check("", timeout=3)
                assert time.perf_counter() - t0 < 3.0
            finally:
                client.close()
            assert status in ("SERVING", "NOT_SERVING")
            for call in calls:
                call.cancel()
            deadline = time.time() + 10
            while time.time() < deadline and not all(
                    r.cancelled or r.error for r in submitted):
                time.sleep(0.01)
            assert all(r.cancelled or r.error for r in submitted)
    finally:
        server.server_close()
        engine.close()


# ---------------------------------------------------------------- reflection
def _list_services_request() -> bytes:
    return bytes([7 << 3 | 2, 0])


def _parse_list_services(data: bytes) -> list[str]:
    """ServerReflectionResponse -> list_services_response(6) ->
    service(1) -> name(1)."""
    dec = port_health._decode_varint
    names, pos = [], 0
    while pos < len(data):
        tag, pos = dec(data, pos)
        length, pos = dec(data, pos)
        payload = data[pos:pos + length]
        pos += length
        if tag >> 3 != 6:
            continue
        spos = 0
        while spos < len(payload):
            _, spos = dec(payload, spos)
            slen, spos = dec(payload, spos)
            svc = payload[spos:spos + slen]
            spos += slen
            _, npos = dec(svc, 0)
            nlen, npos = dec(svc, npos)
            names.append(svc[npos:npos + nlen].decode())
    return names


def test_reflection_codec_equals_jax():
    req = _list_services_request()
    assert port_reflection.decode_reflection_request(req) \
        == jax_reflection.decode_reflection_request(req)
    sym = b"\x22\x05a.b.C"          # file_containing_symbol "a.b.C"
    assert port_reflection.decode_reflection_request(sym) \
        == jax_reflection.decode_reflection_request(sym) \
        == ("file_containing_symbol", sym, "a.b.C")
    for names in (["a.B", "c.D"], []):
        resp = port_reflection.encode_list_services_response(req, names)
        assert resp == jax_reflection.encode_list_services_response(req,
                                                                    names)
        assert _parse_list_services(resp) == names
    assert port_reflection.encode_error_response(req, 5, "nope") \
        == jax_reflection.encode_error_response(req, 5, "nope")
    for status in (0, 1, 2, 3, 300):
        assert port_health.encode_check_response(status) \
            == jax_health.encode_check_response(status)
    for service in ("", "gofr.serving.Chat", "x" * 200):
        raw = port_health.encode_check_request(service)
        assert raw == jax_health.encode_check_request(service)
        assert port_health.decode_check_request(raw) == service


@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_reflection_gate(enabled):
    env = {"GRPC_ENABLE_REFLECTION": "true"} if enabled else {}
    with port_server(make_greeter(port_grpc), env) as (_, port), \
            channel(port) as chan:
        for svc in ("grpc.reflection.v1alpha.ServerReflection",
                    "grpc.reflection.v1.ServerReflection"):
            method = chan.stream_stream(
                f"/{svc}/ServerReflectionInfo",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
            call = method(iter([_list_services_request()]), timeout=20)
            if not enabled:
                with pytest.raises(grpc.RpcError) as err:
                    next(call)
                assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
                continue
            names = _parse_list_services(next(call))
            call.cancel()
            assert names == sorted([
                "gofr.test.Greeter", "grpc.health.v1.Health",
                "grpc.reflection.v1alpha.ServerReflection",
                "grpc.reflection.v1.ServerReflection"])


# ------------------------------------------------------------------ protogen
PROTO = textwrap.dedent("""\
    syntax = "proto3";

    package demo.greeter;

    // a message with a few shapes
    message HelloRequest {
      string name = 1;
      int32 times = 2;
      repeated string tags = 3;
      map<string, int32> counts = 4;
      Inner inner = 5;
      message Inner { string v = 1; }
    }

    message HelloReply {
      string message = 1;
      bool ok = 2;
    }

    service Greeter {
      rpc SayHello (HelloRequest) returns (HelloReply);
      rpc StreamHello (HelloRequest) returns (stream HelloReply);
      rpc Collect (stream HelloRequest) returns (HelloReply);
      rpc Chat (stream HelloRequest) returns (stream HelloReply);
    }
""")


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("protogen")
    proto = tmp / "greeter.proto"
    proto.write_text(PROTO)
    source = port_protogen.generate(proto)
    out = tmp / "greeter_port_gofr.py"
    out.write_text(source)
    spec = importlib.util.spec_from_file_location("greeter_port_gofr", out)
    module = importlib.util.module_from_spec(spec)
    sys.modules["greeter_port_gofr"] = module
    spec.loader.exec_module(module)
    yield proto, source, module
    sys.modules.pop("greeter_port_gofr", None)


def test_protogen_output_equals_jax_after_the_package_swap(generated):
    proto, source, _ = generated
    assert asdict(port_protogen.parse_proto(PROTO)) \
        == asdict(jax_protogen.parse_proto(PROTO))
    want = jax_protogen.generate(proto).replace("gofr_tpu.grpc",
                                                "gofr_tpu_torch.grpc")
    assert source == want
    assert "import gofr_tpu." not in source and "from gofr_tpu." not in source


def test_generated_skeleton_served_and_called(generated):
    """Subclass the generated skeleton (coroutines, as generated), serve
    it on the port's server with its descriptors, call it through the
    generated client on an aio channel, and ask reflection for the
    service's symbol."""
    _, _, m = generated
    assert m.FILE_DESCRIPTOR_SET          # protoc is on PATH here
    assert {s.name: s.kind for s in m.GreeterBase.rpc_specs()} == {
        "SayHello": "unary", "StreamHello": "server_stream",
        "Collect": "client_stream", "Chat": "bidi_stream"}

    class Greeter(m.GreeterBase):
        async def SayHello(self, ctx, request):
            req = m.HelloRequest.from_dict(request)
            return {"message": f"hello {req.name}", "ok": True}

        async def StreamHello(self, ctx, request):
            req = m.HelloRequest.from_dict(request)
            for i in range(max(1, req.times)):
                yield {"message": f"hello {req.name} #{i}", "ok": True}

    env = {"GRPC_ENABLE_REFLECTION": "true"}
    with port_server(Greeter(), env) as (server, port):
        assert server.grpc_server._descriptors.file_containing_symbol(
            "demo.greeter.Greeter")

        async def scenario():
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{port}",
                    options=(("grpc.use_local_subchannel_pool", 1),)) as ch:
                client = m.GreeterClient(ch)
                reply = await client.SayHello(m.HelloRequest(name="world"))
                got = [e async for e in client.StreamHello(
                    m.HelloRequest(name="s", times=3))]
                with pytest.raises(grpc.aio.AioRpcError) as err:
                    async def one():
                        yield m.HelloRequest(name="x")
                    await client.Collect(one())
                return reply, got, err.value.code()

        reply, got, code = asyncio.run(asyncio.wait_for(scenario(), 30))
        assert reply == {"message": "hello world", "ok": True}
        assert [e["message"] for e in got] == [f"hello s #{i}"
                                               for i in range(3)]
        # the skeleton's unimplemented RPC is the handler's error
        assert code == grpc.StatusCode.INTERNAL

        with channel(port) as chan:
            stub = chan.stream_stream(
                "/grpc.reflection.v1.ServerReflection/ServerReflectionInfo",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
            sym = b"demo.greeter.HelloRequest.Inner"
            req = (port_health._encode_varint((4 << 3) | 2)
                   + port_health._encode_varint(len(sym)) + sym)
            call = stub(iter([req]), timeout=20)
            resp = next(call)
            call.cancel()
    # field 4 = file_descriptor_response
    tags, pos = [], 0
    while pos < len(resp):
        tag, pos = port_health._decode_varint(resp, pos)
        length, pos = port_health._decode_varint(resp, pos)
        tags.append(tag >> 3)
        pos += length
    assert 4 in tags


def test_descriptor_registry_equals_jax(generated):
    _, _, m = generated
    port_reg = port_reflection.DescriptorRegistry()
    jax_reg = jax_reflection.DescriptorRegistry()
    port_reg.add_serialized_set(m.FILE_DESCRIPTOR_SET)
    jax_reg.add_serialized_set(m.FILE_DESCRIPTOR_SET)
    assert port_reg._symbols == jax_reg._symbols
    for symbol in ("demo.greeter.Greeter", "demo.greeter.Greeter.SayHello",
                   "demo.greeter.HelloRequest.Inner", "demo.greeter.Nope"):
        assert port_reg.file_containing_symbol(symbol) \
            == jax_reg.file_containing_symbol(symbol)
    assert port_reg.file_by_filename("greeter.proto") \
        == jax_reg.file_by_filename("greeter.proto") is not None
