"""The app's ``/debug/*`` routes (counterpart of
``gofr_tpu/app.py:_install_debug_routes``, the part the port's planes
feed): each answers ``{"data": {<model>: ...}}`` for the served engine.

- ``GET /debug/engine`` (``?n=`` newest passes): health, stats and the
  flight recorder's rings;
- ``GET /debug/efficiency``: goodput, watermarks, the recompile
  sentinel, speculation, the cost table;
- ``GET /debug/costs``: the per-signature cost table;
- ``GET /debug/integrity``: digest folds, the golden corpus, probe
  results, the mismatch latch;
- ``GET /debug/usage`` (``?tenant=``, ``?window=5m``): per-tenant usage;
- ``GET /debug/slo``: burn rates and the error budget;
- ``GET /debug/scheduler`` (``?fresh=1``): lanes, tenants, buckets,
  shedding;
- ``GET /debug/events`` (``?kind=``, ``?since=`` unix seconds, ``?n=``
  newest; ``?model=``): the event ring as ``gofr-events`` JSONL, 404
  when the ledger is disabled.

An integer parameter that is not an integer, a window or a ``since``
that does not parse, answers 400; an out-of-range integer is clamped.
"""

from __future__ import annotations

from typing import Any

from .observability import parse_window
from .responses import ErrorEntityNotFound, ErrorInvalidParam, File


def bounded_int_param(ctx: Any, name: str, default: int, lo: int,
                      hi: int) -> int:
    """Absent -> ``default``, out of range -> clamped into [lo, hi], not
    an integer -> 400."""
    raw = ctx.param(name)
    if raw is None or raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ErrorInvalidParam(name) from None
    return max(lo, min(hi, value))


def install_debug_routes(server: Any, engine: Any, name: str) -> None:
    """Register the debug routes on ``server`` (``ChatServer.get``) for
    ``engine`` served as model ``name``."""

    def engine_debug(ctx):
        n = bounded_int_param(ctx, "n", default=0, lo=0, hi=65536)
        return {name: {"health": engine.health_check(),
                       "stats": dict(engine.stats),
                       "flight": engine.recorder.snapshot(n or None)}}

    def usage_debug(ctx):
        tenant = ctx.param("tenant") or None
        try:
            window_s = parse_window(ctx.param("window") or None)
        except ValueError:
            raise ErrorInvalidParam("window") from None
        return {name: engine.usage_ledger.rollup(tenant=tenant,
                                                 window_s=window_s)}

    def slo_debug(ctx):
        slo = engine.slo
        return {name: slo.state() if slo is not None else None}

    def scheduler_debug(ctx):
        fresh = ctx.param("fresh") in ("1", "true")
        return {name: engine.waiting.state(fresh=fresh)}

    def events_debug(ctx):
        n = bounded_int_param(ctx, "n", default=0, lo=0, hi=1 << 20)
        kind = ctx.param("kind") or None
        raw_since = ctx.param("since")
        since = None
        if raw_since not in (None, ""):
            try:
                since = float(raw_since)
            except ValueError:
                raise ErrorInvalidParam("since") from None
        model = ctx.param("model") or name
        if model != name:
            raise ErrorEntityNotFound(f"model {model!r}")
        if not engine.events.enabled:
            raise ErrorEntityNotFound(
                f"model {name!r} has no event ledger "
                "(GOFR_EVENTS=0 or EngineConfig.events=False?)")
        body = engine.events.to_jsonl(kind=kind, since=since, n=n or None)
        return File(content=body.encode(),
                    content_type="application/jsonl; charset=utf-8")

    server.get("/debug/engine", engine_debug)
    server.get("/debug/efficiency",
               lambda ctx: {name: engine.efficiency_state()})
    server.get("/debug/costs", lambda ctx: {name: engine.cost_state()})
    server.get("/debug/integrity",
               lambda ctx: {name: engine.integrity_state()})
    server.get("/debug/usage", usage_debug)
    server.get("/debug/slo", slo_debug)
    server.get("/debug/scheduler", scheduler_debug)
    server.get("/debug/events", events_debug)
