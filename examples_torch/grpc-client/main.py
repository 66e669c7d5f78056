"""gRPC client app (reference examples/grpc/grpc-unary-client +
grpc-streaming-client): an HTTP service whose handlers call a
downstream gRPC server — unary, server-stream, and health — with trace
propagation through the client's metadata."""

from gofr_tpu_torch.app import App, new_app
from gofr_tpu_torch.grpc import GRPCClient


def build_app(config=None, grpc_target: str = "127.0.0.1:9000") -> App:
    app = new_app() if config is None else App(config=config)
    client = GRPCClient(grpc_target, tracer=app.container.tracer)

    @app.get("/hello")
    async def hello(ctx):
        reply = await client.call("examples.Greeter", "SayHello",
                                  {"name": ctx.param("name") or "world"})
        return reply

    @app.get("/countdown")
    async def countdown(ctx):
        seen = []
        async for message in client.stream(
                "examples.Greeter", "Countdown",
                {"from": int(ctx.param("from") or "3")}):
            seen.append(message)
        return {"messages": seen}

    @app.get("/downstream-health")
    async def downstream_health(ctx):
        return {"status": await client.health_check()}

    return app


if __name__ == "__main__":
    build_app().run()
