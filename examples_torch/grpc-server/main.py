"""gRPC service (reference examples/grpc/grpc-unary-server): unary +
server-stream RPCs with container injection and observability."""

from dataclasses import dataclass

from gofr_tpu_torch.app import App, new_app
from gofr_tpu_torch.grpc import GRPCService, rpc, server_stream_rpc


@dataclass
class HelloRequest:
    name: str = "world"


class GreeterService(GRPCService):
    name = "examples.Greeter"

    @rpc
    def SayHello(self, ctx, request):
        hello = ctx.bind(HelloRequest)
        return {"message": f"Hello {hello.name}!",
                "served_by": self.container.app_name}

    @server_stream_rpc
    async def Countdown(self, ctx, request):
        for i in range(int(request.get("from", 3)), 0, -1):
            yield {"t_minus": i}


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)
    app.register_grpc_service(GreeterService())
    return app


if __name__ == "__main__":
    build_app().run()
