"""gRPC transport of the port (the counterpart of ``gofr_tpu/grpc/``):
a ``grpc.aio`` server with the observability chain, decorator-based
services, standard health, reflection, a client and the ``.proto``
skeleton generator. Importing it needs ``grpcio``; the rest of the port
does not."""

from .client import GRPCClient
from .health import NOT_SERVING, SERVICE_UNKNOWN, SERVING
from .server import GRPCServer, RPCContext
from .service import (
    GRPCService,
    bidi_stream_rpc,
    client_stream_rpc,
    rpc,
    server_stream_rpc,
)

__all__ = ["GRPCServer", "GRPCClient", "GRPCService", "RPCContext", "rpc",
           "server_stream_rpc", "client_stream_rpc", "bidi_stream_rpc",
           "SERVING", "NOT_SERVING", "SERVICE_UNKNOWN"]
