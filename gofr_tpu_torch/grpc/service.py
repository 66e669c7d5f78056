"""gRPC service model: decorator-registered RPCs on plain classes (a
copy of ``gofr_tpu/grpc/service.py``).

Each ``@rpc`` / ``@server_stream_rpc`` / ``@client_stream_rpc`` /
``@bidi_stream_rpc`` method becomes a gRPC method handler with a codec.
The default codec is JSON (any gRPC client that sends JSON bytes
interoperates); passing protobuf message classes switches to the proto
wire format, so protoc-generated clients work unchanged; a plain class
(a dataclass) as ``request_type`` is built from the decoded JSON.

Handlers take ``(self, ctx, request)``: ``ctx`` is the server's
:class:`~.server.RPCContext` (metadata, ``bind``, the host injected as
``container``). They may be plain functions and generators, which the
server's thread pool runs as they are, or coroutines and async
generators, which it runs on an event loop of the call's own.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from typing import Any, Callable

UNARY = "unary"
SERVER_STREAM = "server_stream"
CLIENT_STREAM = "client_stream"
BIDI_STREAM = "bidi_stream"


def _json_serialize(obj: Any) -> bytes:
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj)
    return json.dumps(obj).encode()


def _json_deserialize(data: bytes) -> Any:
    if not data:
        return {}
    try:
        return json.loads(data)
    except json.JSONDecodeError:
        return data


@dataclass
class RPCSpec:
    name: str
    kind: str
    fn: Callable
    request_deserializer: Callable[[bytes], Any]
    response_serializer: Callable[[Any], bytes]


def _make_codecs(request_type: Any, response_type: Any):
    """proto message classes -> proto codec; None -> JSON codec."""
    if request_type is not None and hasattr(request_type, "FromString"):
        deserializer = request_type.FromString
    elif request_type is not None and callable(request_type):
        deserializer = lambda b: request_type(_json_deserialize(b))
    else:
        deserializer = _json_deserialize
    if response_type is not None and hasattr(response_type, "SerializeToString"):
        serializer = lambda m: m.SerializeToString()
    else:
        serializer = _json_serialize
    return deserializer, serializer


def _decorate(kind: str):
    def factory(fn: Callable | None = None, *, request_type: Any = None,
                response_type: Any = None, name: str | None = None):
        def wrap(f: Callable) -> Callable:
            deserializer, serializer = _make_codecs(request_type,
                                                    response_type)
            f.__rpc_spec__ = RPCSpec(
                name=name or f.__name__, kind=kind, fn=f,
                request_deserializer=deserializer,
                response_serializer=serializer)
            return f
        return wrap(fn) if fn is not None else wrap
    return factory


rpc = _decorate(UNARY)
server_stream_rpc = _decorate(SERVER_STREAM)
client_stream_rpc = _decorate(CLIENT_STREAM)
bidi_stream_rpc = _decorate(BIDI_STREAM)


class GRPCService:
    """Base class: subclass, set ``name`` (the fully-qualified gRPC
    service name, e.g. ``chat.ChatService``), decorate methods."""

    name: str = ""

    #: the host the server serves beside (a ``ChatServer``), set at
    #: registration
    container: Any = None

    @classmethod
    def rpc_specs(cls) -> list[RPCSpec]:
        specs = []
        for attr in dir(cls):
            member = getattr(cls, attr)
            spec = getattr(member, "__rpc_spec__", None)
            if spec is None:
                # a subclass overriding a decorated base method (the
                # protogen skeleton pattern) keeps the base's spec but
                # serves the overriding implementation
                for base in cls.__mro__[1:]:
                    base_spec = getattr(getattr(base, attr, None),
                                        "__rpc_spec__", None)
                    if base_spec is not None:
                        spec = replace(base_spec, fn=member)
                        break
            if spec is not None:
                specs.append(spec)
        return specs
