"""Subscriber (reference examples/using-subscriber/main.go:8-18): a
broker message drives the handler exactly like an HTTP request, with
commit-on-success."""

from gofr_tpu_torch.app import App, new_app

SEEN: list[dict] = []


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)
    if app.container.pubsub is None:
        from gofr_tpu_torch.pubsub.inmemory import InMemoryBroker
        app.container.add_pubsub(InMemoryBroker(
            logger=app.logger, metrics=app.container.metrics))

    @app.subscribe("orders")
    def on_order(ctx):
        order = ctx.bind() or {}
        SEEN.append(order)
        ctx.logger.info("order received", order=order)

    @app.get("/orders/seen")
    def seen(ctx):
        return SEEN

    return app


if __name__ == "__main__":
    build_app().run()
