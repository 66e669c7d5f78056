"""Auto-CRUD (reference examples/using-add-rest-handlers): one
dataclass becomes POST/GET/GET-all/PUT/DELETE SQL handlers."""

from dataclasses import dataclass

from gofr_tpu_torch.app import App, new_app


@dataclass
class Book:
    id: int
    title: str = ""
    author: str = ""


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)
    if app.container.sql is None:
        from gofr_tpu_torch.datasource.sql import SQL
        app.container.add_sql(SQL(database=":memory:"))
    app.container.sql.exec(
        "CREATE TABLE IF NOT EXISTS book "
        "(id INTEGER PRIMARY KEY, title TEXT, author TEXT)")
    app.add_rest_handlers(Book)
    return app


if __name__ == "__main__":
    build_app().run()
