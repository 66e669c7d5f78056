"""File store (reference examples/using-add-filestore): the FileSystem
abstraction over a local root; remote stores implement the same iface."""

import tempfile

from gofr_tpu_torch.app import App, new_app
from gofr_tpu_torch.datasource.file_store import LocalFileSystem


def build_app(config=None, root: str | None = None) -> App:
    app = new_app() if config is None else App(config=config)
    app.container.add_file_store(
        LocalFileSystem(root or tempfile.mkdtemp(prefix="gofr-files-")))

    @app.post("/notes/{name}")
    def write_note(ctx):
        body = ctx.bind() or {}
        ctx.file.create(f"{ctx.path_param('name')}.txt",
                        str(body.get("text", "")))
        return {"saved": ctx.path_param("name")}

    @app.get("/notes/{name}")
    def read_note(ctx):
        return {"text": ctx.file.read_text(f"{ctx.path_param('name')}.txt")}

    @app.get("/notes")
    def list_notes(ctx):
        return [info.name for info in ctx.file.read_dir(".")]

    return app


if __name__ == "__main__":
    build_app().run()
