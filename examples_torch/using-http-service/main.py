"""Inter-service HTTP client (reference examples/using-http-service):
a named downstream with circuit breaker + retry decorators."""

from gofr_tpu_torch.app import App, new_app
from gofr_tpu_torch.service import CircuitBreaker, Retry, new_http_service


def build_app(config=None, downstream_url: str = "http://127.0.0.1:9001") -> App:
    app = new_app() if config is None else App(config=config)
    svc = new_http_service(
        downstream_url,
        Retry(max_retries=2),
        CircuitBreaker(threshold=3, interval_s=5.0),
        logger=app.logger, metrics=app.container.metrics,
        tracer=app.container.tracer)
    app.container.register_service("catalog", svc)

    @app.get("/proxy/{item}")
    async def proxy(ctx):
        catalog = ctx.get_http_service("catalog")
        resp = await catalog.get(f"/items/{ctx.path_param('item')}")
        return resp.json()

    return app


if __name__ == "__main__":
    build_app().run()
