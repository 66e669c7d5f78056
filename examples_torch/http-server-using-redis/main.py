"""HTTP server over Redis (reference examples/http-server-using-redis):
the in-process redis backend by default; REDIS_HOST selects a real one."""

from gofr_tpu_torch.app import App, new_app


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)
    if app.container.redis is None:
        from gofr_tpu_torch.datasource.redis import Redis
        app.container.add_redis(Redis())

    @app.post("/visit/{page}")
    def visit(ctx):
        count = ctx.redis.incr(f"visits:{ctx.path_param('page')}")
        return {"page": ctx.path_param("page"), "visits": count}

    @app.get("/visit/{page}")
    def visits(ctx):
        value = ctx.redis.get(f"visits:{ctx.path_param('page')}")
        return {"page": ctx.path_param("page"),
                "visits": int(value) if value else 0}

    return app


if __name__ == "__main__":
    build_app().run()
