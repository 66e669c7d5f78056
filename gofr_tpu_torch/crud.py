"""Auto-CRUD: REST handlers generated from a dataclass entity (the port's
copy of ``gofr_tpu/crud.py``).

Mirrors reference pkg/gofr/crud_handlers.go: ``scanEntity``
(crud_handlers.go:67-113) — the FIRST dataclass field is the primary
key; the entity name snake-cases into the table name and REST path;
``table_name()`` / ``rest_path()`` classmethods override both
(crud_handlers.go:40-46). ``add_rest_handlers`` registers
POST /entity, GET /entity, GET /entity/{id}, PUT /entity/{id},
DELETE /entity/{id} (crud_handlers.go:116 registerCRUDHandlers),
building dialect-aware statements through the SQL layer's quoted
identifiers and placeholders (datasource/sql/query_builder.go analog).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from .datasource.sql import placeholders, quote_ident
from .http.errors import ErrorEntityNotFound, ErrorInvalidParam
from .http.request import bind_dataclass


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


@dataclasses.dataclass
class EntitySpec:
    cls: type
    name: str
    table: str
    path: str
    fields: list[str]
    primary_key: str


def scan_entity(cls: type) -> EntitySpec:
    """Reflect a dataclass into an entity spec
    (reference crud_handlers.go:67-113)."""
    if not (dataclasses.is_dataclass(cls) and isinstance(cls, type)):
        raise TypeError("add_rest_handlers requires a dataclass type")
    entity_fields = [f.name for f in dataclasses.fields(cls)]
    if not entity_fields:
        raise TypeError(f"{cls.__name__} has no fields")
    name = _snake(cls.__name__)
    table = getattr(cls, "table_name", lambda: name)()
    path = getattr(cls, "rest_path", lambda: name)()
    return EntitySpec(cls=cls, name=name, table=quote_ident(table),
                      path=path.strip("/"),
                      fields=[quote_ident(f) for f in entity_fields],
                      primary_key=quote_ident(entity_fields[0]))


def _row_to_entity(spec: EntitySpec, row: Any) -> Any:
    # oracle-family stores report UPPERCASE column names; match the
    # dataclass fields case-insensitively like OracleWire.select does
    by_fold = {str(k).lower(): k for k in row.keys()}
    return spec.cls(**{f: row[by_fold[f.lower()]]
                       for f in spec.fields if f.lower() in by_fold})


def _entity_to_dict(entity: Any) -> dict[str, Any]:
    return dataclasses.asdict(entity)


def add_rest_handlers(app: Any, cls: type, *,
                      table_name: str | None = None,
                      rest_path: str | None = None) -> EntitySpec:
    """Generate + register the five CRUD handlers
    (reference rest.go:53 AddRESTHandlers)."""
    spec = scan_entity(cls)
    if table_name is not None:
        spec.table = quote_ident(table_name)
    if rest_path is not None:
        spec.path = rest_path.strip("/")
    base = f"/{spec.path}"
    by_id = f"{base}/{{{spec.primary_key}}}"
    columns = ", ".join(spec.fields)

    def sql_of(ctx):
        sql = ctx.sql
        if sql is None:
            raise RuntimeError("no SQL datasource configured")
        return sql

    def create(ctx):
        sql = sql_of(ctx)
        entity = bind_dataclass(ctx.bind() or {}, spec.cls)
        values = [getattr(entity, f) for f in spec.fields]
        marks = placeholders(sql.dialect, len(spec.fields))
        sql.exec(f"INSERT INTO {spec.table} ({columns}) VALUES ({marks})",
                 *values)
        return {f"{spec.name}": _entity_to_dict(entity)}

    def get_all(ctx):
        sql = sql_of(ctx)
        rows = sql.query(f"SELECT {columns} FROM {spec.table}")
        return [_entity_to_dict(_row_to_entity(spec, r)) for r in rows]

    def _pk(ctx):
        value = ctx.path_param(spec.primary_key)
        if value == "":
            raise ErrorInvalidParam(spec.primary_key)
        return value

    def get_one(ctx):
        sql = sql_of(ctx)
        row = sql.query_row(
            f"SELECT {columns} FROM {spec.table} "
            f"WHERE {spec.primary_key} = {sql.ph(1)}", _pk(ctx))
        if row is None:
            raise ErrorEntityNotFound(spec.primary_key, _pk(ctx))
        return _entity_to_dict(_row_to_entity(spec, row))

    def update(ctx):
        sql = sql_of(ctx)
        pk_value = _pk(ctx)
        # the pk comes from the path, not the body (reference
        # crud_handlers.go Update); the body may omit it
        data = dict(ctx.bind() or {})
        data.setdefault(spec.primary_key, pk_value)
        entity = bind_dataclass(data, spec.cls)
        non_pk = [f for f in spec.fields if f != spec.primary_key]
        if not non_pk:
            raise ErrorInvalidParam("nothing to update")
        sets = ", ".join(f"{f} = {sql.ph(i + 1)}"
                         for i, f in enumerate(non_pk))
        args = [getattr(entity, f) for f in non_pk] + [pk_value]
        cur = sql.exec(
            f"UPDATE {spec.table} SET {sets} "
            f"WHERE {spec.primary_key} = {sql.ph(len(non_pk) + 1)}", *args)
        if getattr(cur, "rowcount", 1) == 0:
            raise ErrorEntityNotFound(spec.primary_key, pk_value)
        return f"{spec.name} successfully updated with id: {pk_value}"

    def delete(ctx):
        sql = sql_of(ctx)
        pk_value = _pk(ctx)
        cur = sql.exec(f"DELETE FROM {spec.table} "
                       f"WHERE {spec.primary_key} = {sql.ph(1)}", pk_value)
        if getattr(cur, "rowcount", 1) == 0:
            raise ErrorEntityNotFound(spec.primary_key, pk_value)
        return f"{spec.name} successfully deleted with id: {pk_value}"

    app.post(base, create)
    app.get(base, get_all)
    app.get(by_id, get_one)
    app.put(by_id, update)
    app.delete(by_id, delete)
    return spec
