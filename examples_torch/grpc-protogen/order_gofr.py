"""Generated from order.proto by gofr_tpu_torch.grpc.protogen
— the gofr-cli `wrap grpc` analog. Fill in the *Base methods.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, AsyncIterator

from gofr_tpu_torch.grpc.service import (GRPCService, bidi_stream_rpc,
                                   client_stream_rpc, rpc,
                                   server_stream_rpc)

@dataclass
class Order:
    id: str = ""
    item: str = ""
    quantity: int = 0

    @classmethod
    def from_dict(cls, d):
        d = d if isinstance(d, dict) else {}
        names = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class OrderAck:
    id: str = ""
    status: str = ""

    @classmethod
    def from_dict(cls, d):
        d = d if isinstance(d, dict) else {}
        names = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in names})


class OrderDeskBase(GRPCService):
    """Server skeleton for `examples.orders.OrderDesk` — subclass and implement each RPC."""

    name = "examples.orders.OrderDesk"

    @rpc
    async def Place(self, ctx, request) -> Any:
        """rpc Place(Order) returns (OrderAck)"""
        req = Order.from_dict(request)
        raise NotImplementedError("implement Place")

    @server_stream_rpc
    async def Track(self, ctx, request) -> AsyncIterator[dict]:
        """rpc Track(Order) returns (stream OrderAck)"""
        req = Order.from_dict(request)
        raise NotImplementedError("implement Track")
        yield {}  # pragma: no cover


class OrderDeskClient:
    """grpc.aio client for `examples.orders.OrderDesk` (JSON codec)."""

    def __init__(self, channel):
        import json as _json
        self._channel = channel
        self._dumps = lambda o: _json.dumps(
            o.__dict__ if hasattr(o, '__dataclass_fields__') else o).encode()
        self._loads = lambda b: _json.loads(b or b'{}')

    async def Place(self, request):
        call = self._channel.unary_unary(
            "/examples.orders.OrderDesk/Place",
            request_serializer=self._dumps,
            response_deserializer=self._loads)
        return await call(request)

    def Track(self, request):
        call = self._channel.unary_stream(
            "/examples.orders.OrderDesk/Track",
            request_serializer=self._dumps,
            response_deserializer=self._loads)
        return call(request)


#: protoc-compiled FileDescriptorSet — register with the server so
#: reflection answers file_containing_symbol with real descriptors
FILE_DESCRIPTOR_SET = b'\n\xab\x02\n\x0border.proto\x12\x0fexamples.orders"G\n\x05Order\x12\x0e\n\x02id\x18\x01 \x01(\tR\x02id\x12\x12\n\x04item\x18\x02 \x01(\tR\x04item\x12\x1a\n\x08quantity\x18\x03 \x01(\x05R\x08quantity"2\n\x08OrderAck\x12\x0e\n\x02id\x18\x01 \x01(\tR\x02id\x12\x16\n\x06status\x18\x02 \x01(\tR\x06status2\x85\x01\n\tOrderDesk\x12:\n\x05Place\x12\x16.examples.orders.Order\x1a\x19.examples.orders.OrderAck\x12<\n\x05Track\x12\x16.examples.orders.Order\x1a\x19.examples.orders.OrderAck0\x01b\x06proto3'
