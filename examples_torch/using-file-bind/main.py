"""Multipart upload binding (reference examples/using-file-bind):
file parts and form fields arrive through the same ctx.bind."""

from gofr_tpu_torch.app import App, new_app


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)

    @app.post("/upload")
    def upload(ctx):
        form = ctx.bind() or {}
        out = {}
        for key, value in form.items():
            if isinstance(value, dict) and "content" in value:  # file part
                out[key] = {"filename": value.get("filename", ""),
                            "bytes": len(value["content"])}
            else:
                out[key] = value
        return out

    return app


if __name__ == "__main__":
    build_app().run()
