"""HTML template rendering (reference examples/using-html-template):
Template responses render ./templates/<name> with $var substitution."""

import os

from gofr_tpu_torch.app import App, new_app
from gofr_tpu_torch.http.response import Template

_PAGE = """<!doctype html>
<html><body><h1>Hello $name</h1><p>Served by $app</p></body></html>
"""


def _ensure_templates() -> None:
    """Templates resolve relative to CWD (reference loads ./templates)."""
    os.makedirs("templates", exist_ok=True)
    path = os.path.join("templates", "hello.html")
    if not os.path.isfile(path):
        with open(path, "w") as f:
            f.write(_PAGE)


def build_app(config=None) -> App:
    _ensure_templates()
    app = new_app() if config is None else App(config=config)

    @app.get("/hello")
    def hello(ctx):
        return Template("hello.html",
                        {"name": ctx.param("name") or "world",
                         "app": ctx.container.app_name})

    return app


if __name__ == "__main__":
    build_app().run()
