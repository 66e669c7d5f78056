"""Auth middleware (reference examples/using-http-auth-middleware):
basic auth guards every route; /.well-known stays open."""

from gofr_tpu_torch.app import App, new_app


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)
    app.enable_basic_auth(ada="lovelace", grace="hopper")

    @app.get("/secret")
    def secret(ctx):
        return {"for": ctx.auth_info.get("username"),
                "data": "the MXU is a 128x128 systolic array"}

    return app


if __name__ == "__main__":
    build_app().run()
