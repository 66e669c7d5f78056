"""The app's ``/debug/*`` routes (counterpart of
``gofr_tpu/app.py:_install_debug_routes``, the part the port's planes
feed): each answers ``{"data": ...}`` for the served engine, most as
``{"data": {<model>: ...}}``.

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
  when the ledger is disabled;
- ``GET /debug/incidents``: the incident spool and the detector's
  state; ``?id=`` one full bundle (404 when unknown);
- ``GET /debug/workload`` (``?n=`` newest; ``?model=``): the capture
  ring as a ``gofr-workload`` JSONL file; ``POST /debug/workload/start``
  (body ``{"redact": true}`` for salted hashes) and ``/stop`` arm and
  disarm it;
- with ``profiler`` (the app's ``PROFILER_ENABLED``): ``POST
  /debug/profile/start`` (body ``{"dir", "max_capture_s"}``), ``POST
  /debug/profile/stop`` (body ``{"force": true}`` recovers a leaked
  capture) and ``GET /debug/profile``, over a ``ProfilerCapture`` in
  ``profile_dir``.

An integer parameter that is not an integer, a window or a ``since``
that does not parse, answers 400; an out-of-range integer is clamped.
"""

from __future__ import annotations

from typing import Any

from .observability import ProfilerCapture, parse_window
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


def _body_dict(ctx: Any) -> dict:
    """The JSON body when it is an object, else {} (a bad body is
    ignored, as the JAX routes do)."""
    try:
        body = ctx.bind()
    except Exception:  # noqa: BLE001 — a bad body means no options
        return {}
    return body if isinstance(body, dict) else {}


def install_debug_routes(server: Any, engine: Any, name: str, *,
                         profiler: bool = False,
                         profile_dir: str | None = None) -> None:
    """Register the debug routes on ``server`` (``ChatServer.get`` /
    ``post``) for ``engine`` served as model ``name``; with ``profiler``
    the profile routes too, their capture kept as ``server.profiler``."""

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

    def model_of(ctx) -> str:
        model = ctx.param("model") or name
        if model != name:
            raise ErrorEntityNotFound(f"model {model!r}")
        return model

    def incidents_debug(ctx):
        incident_id = ctx.param("id") or None
        if incident_id is not None:
            bundle = engine.incidents.get(incident_id)
            if bundle is None:
                raise ErrorEntityNotFound(f"incident {incident_id!r}")
            return bundle
        return {name: {"incidents": engine.incidents.list(),
                       "detector": engine.incidents.state()}}

    def workload_download(ctx):
        n = bounded_int_param(ctx, "n", default=0, lo=0, hi=1 << 20)
        model_of(ctx)
        return File(content=engine.workload.to_jsonl(n or None).encode(),
                    content_type="application/jsonl; charset=utf-8")

    def workload_start(ctx):
        body = _body_dict(ctx)
        redact = bool(body["redact"]) if "redact" in body else None
        return {"model": model_of(ctx),
                "workload": engine.workload.start(redact)}

    def workload_stop(ctx):
        return {"model": model_of(ctx), "workload": engine.workload.stop()}

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
    server.get("/debug/incidents", incidents_debug)
    server.get("/debug/workload", workload_download)
    server.post("/debug/workload/start", workload_start)
    server.post("/debug/workload/stop", workload_stop)
    if not profiler:
        return
    capture = ProfilerCapture(base_dir=profile_dir, logger=engine.logger)
    server.profiler = capture

    def profile_start(ctx):
        body = _body_dict(ctx)
        try:
            cap = float(body.get("max_capture_s") or 0.0)
        except (TypeError, ValueError):
            cap = 0.0
        return capture.start(body.get("dir"), max_capture_s=cap or None)

    def profile_stop(ctx):
        return capture.stop(force=bool(_body_dict(ctx).get("force")))

    server.post("/debug/profile/start", profile_start)
    server.post("/debug/profile/stop", profile_stop)
    server.get("/debug/profile", lambda ctx: capture.status())
