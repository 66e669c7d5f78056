"""Custom metrics (reference examples/using-custom-metrics): register
app-level series next to the framework set; scrape at :2121/metrics."""

from gofr_tpu_torch.app import App, new_app


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)
    m = app.container.metrics
    m.new_counter("orders_created", "orders created by POST /order")
    m.new_histogram("order_amount", "order amount distribution",
                    buckets=(1, 5, 10, 50, 100, 500))
    m.new_gauge("inventory_level", "current stock")
    m.set_gauge("inventory_level", 100)

    @app.post("/order")
    def order(ctx):
        body = ctx.bind() or {}
        amount = float(body.get("amount", 1))
        ctx.metrics.increment_counter("orders_created")
        ctx.metrics.record_histogram("order_amount", amount)
        ctx.metrics.set_gauge("inventory_level", 100)
        return {"ok": True, "amount": amount}

    return app


if __name__ == "__main__":
    build_app().run()
