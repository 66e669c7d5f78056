"""Basic HTTP server (reference examples/http-server/main.go:17-33):
plain routes, path params, error mapping, health for free."""

from dataclasses import dataclass

from gofr_tpu_torch.app import App, new_app
from gofr_tpu_torch.http.errors import ErrorEntityNotFound

USERS = {"1": {"id": "1", "name": "ada"}, "2": {"id": "2", "name": "grace"}}


@dataclass
class NewUser:
    name: str


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)

    @app.get("/greet")
    def greet(ctx):
        name = ctx.param("name") or "world"
        return f"Hello {name}!"

    @app.get("/users/{id}")
    def get_user(ctx):
        user = USERS.get(ctx.path_param("id"))
        if user is None:
            raise ErrorEntityNotFound("user", ctx.path_param("id"))
        return user

    @app.post("/users")
    def create_user(ctx):
        new = ctx.bind(NewUser)
        uid = str(len(USERS) + 1)
        USERS[uid] = {"id": uid, "name": new.name}
        return USERS[uid]

    return app


if __name__ == "__main__":
    build_app().run()
