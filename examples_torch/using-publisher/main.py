"""Publisher (reference examples/using-publisher): HTTP ingress fanned
into the broker. PUBSUB_BACKEND env picks NATS/MQTT/MEMORY."""

from gofr_tpu_torch.app import App, new_app


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)
    if app.container.pubsub is None:
        from gofr_tpu_torch.pubsub.inmemory import InMemoryBroker
        app.container.add_pubsub(InMemoryBroker(
            logger=app.logger, metrics=app.container.metrics))

    @app.post("/publish/order")
    async def publish_order(ctx):
        await ctx.publish("orders", ctx.bind() or {})
        return {"queued": True}

    return app


if __name__ == "__main__":
    build_app().run()
