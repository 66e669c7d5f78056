"""protogen workflow (the gofr-cli `wrap grpc` analog): generate the
service skeleton from order.proto, implement it, serve it.

Regenerate the glue after editing the proto:

    python -m gofr_tpu_torch.grpc.protogen examples_torch/grpc-protogen/order.proto

The generated ``order_gofr.py`` carries the dataclasses, the
``OrderDeskBase`` skeleton this module subclasses, an ``OrderDeskClient``
for callers, and the protoc-compiled descriptors that make server
reflection schema-aware (``GRPC_ENABLE_REFLECTION=true``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gofr_tpu_torch.app import App  # noqa: E402
from gofr_tpu_torch.grpc.protogen import generate  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_GLUE = os.path.join(_HERE, "order_gofr.py")
if not os.path.exists(_GLUE):  # first run: generate the glue in place
    with open(_GLUE, "w") as f:
        f.write(generate(os.path.join(_HERE, "order.proto")))

import order_gofr  # noqa: E402


class OrderDesk(order_gofr.OrderDeskBase):
    async def Place(self, ctx, request):
        order = order_gofr.Order.from_dict(request)
        ctx.logger.info(f"order placed: {order.item} x{order.quantity}")
        return {"id": order.id or "o-1", "status": "ACCEPTED"}

    async def Track(self, ctx, request):
        order = order_gofr.Order.from_dict(request)
        for status in ("ACCEPTED", "PACKED", "SHIPPED"):
            yield {"id": order.id, "status": status}


def build_app(config=None) -> App:
    app = App(config=config) if config is not None else App()
    app.register_grpc_service(OrderDesk())
    return app


if __name__ == "__main__":
    build_app().run()
