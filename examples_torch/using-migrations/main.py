"""Versioned migrations (reference examples/using-migrations): the
ledger lives in gofr_migrations; each UP runs transactionally."""

from gofr_tpu_torch.app import App, new_app
from gofr_tpu_torch.migrations.runner import Migrate


def create_employee_table(ds) -> None:
    ds.sql.exec("CREATE TABLE IF NOT EXISTS employee "
                "(id INTEGER PRIMARY KEY, name TEXT NOT NULL)")


def seed_employees(ds) -> None:
    ds.sql.exec("INSERT INTO employee (id, name) VALUES (1, 'ada')")
    ds.sql.exec("INSERT INTO employee (id, name) VALUES (2, 'grace')")


ALL = {
    20240101000001: Migrate(up=create_employee_table),
    20240101000002: Migrate(up=seed_employees),
}


def build_app(config=None) -> App:
    app = new_app() if config is None else App(config=config)
    if app.container.sql is None:
        from gofr_tpu_torch.datasource.sql import SQL
        app.container.add_sql(SQL(database=":memory:"))
    app.migrate(ALL)

    @app.get("/employees")
    def employees(ctx):
        return [dict(r) for r in
                ctx.sql.query("SELECT * FROM employee ORDER BY id")]

    return app


if __name__ == "__main__":
    build_app().run()
