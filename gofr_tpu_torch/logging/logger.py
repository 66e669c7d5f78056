"""Leveled structured logger with JSON and pretty terminal modes (the
port's copy of ``gofr_tpu/logging/logger.py``, and the port's one
logger: ``serving/logger.py`` re-exports it).

Six levels DEBUG..FATAL (:func:`level_from_string`), JSON lines
``{"level", "time", "trace_id"?, "span_id"?, <fleet context>,
"message", **fields}`` on non-terminals and colored one-liners on
terminals, a ``PrettyPrint`` protocol so structured records (request
logs) render as single colored lines, live ``change_level``, a file
logger for CLI apps, and a ``ContextLogger`` that reads the base
logger's level live.

Correlation ids ride a ``contextvars.ContextVar`` set by the tracer
(``tracing.Tracer.start_span``), so any log emitted inside a request
handler carries ``trace_id``/``span_id`` without plumbing; a handler
that runs on a worker thread gets them because the app copies the
context into that thread.

The process-wide **fleet context** (``host_id``, ``rank``,
``generation``: :func:`set_fleet_context`, set at a control-plane join
and on every re-rank) is merged into every record under its own fields,
and into every span by the tracer, so one grep and one trace correlate a
leader with its workers.

One deviation from the JAX logger, in where lines go by default: ``out``
defaults to the process's standard error (read at the time of writing,
not of construction) and ``err`` to ``out``. A serving process's
standard output belongs to whatever drives it (``chip_smoke.py`` prints
its JSON result lines there); pass ``out=sys.stdout`` for the JAX
logger's split.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
from contextvars import ContextVar
from typing import Any, Protocol, TextIO, runtime_checkable

# ---------------------------------------------------------------- levels

DEBUG, INFO, NOTICE, WARN, ERROR, FATAL = 1, 2, 3, 4, 5, 6

_LEVEL_NAMES = {DEBUG: "DEBUG", INFO: "INFO", NOTICE: "NOTICE",
                WARN: "WARN", ERROR: "ERROR", FATAL: "FATAL"}
_LEVEL_COLORS = {DEBUG: 36, INFO: 36, NOTICE: 36, WARN: 33, ERROR: 31, FATAL: 31}

Level = int


def level_from_string(name: str) -> Level:
    return {v: k for k, v in _LEVEL_NAMES.items()}.get((name or "").upper(), INFO)


# ------------------------------------------------- correlation contextvar

# (trace_id, span_id) for the active request; set by tracing middleware.
_trace_ctx: ContextVar[tuple[str, str] | None] = ContextVar("gofr_trace_ctx", default=None)


def set_trace_context(trace_id: str, span_id: str):
    return _trace_ctx.set((trace_id, span_id))


def reset_trace_context(token) -> None:
    _trace_ctx.reset(token)


def current_trace_ids() -> tuple[str, str] | None:
    return _trace_ctx.get()


# ------------------------------------------------- fleet (host) context
#
# Process-wide host identity for multi-host serving: set once at
# control-plane join (serving/control_plane.py) and merged into every
# log record next to trace_id/span_id, and into every span's
# attributes by the tracer — so one grep (and one trace) correlates
# leader and worker. A plain dict, not a contextvar: the whole process
# IS one host, there is nothing request-scoped about it.
_fleet_ctx: dict[str, Any] = {}


def set_fleet_context(**attrs: Any) -> None:
    """Merge host identity (``host_id``, ``rank``, ``generation``) into
    the process-wide fleet context; None values are dropped."""
    _fleet_ctx.update({k: v for k, v in attrs.items() if v is not None})


def clear_fleet_context() -> None:
    _fleet_ctx.clear()


def current_fleet_context() -> dict[str, Any]:
    return dict(_fleet_ctx)


@runtime_checkable
class PrettyPrint(Protocol):
    """Structured records that know how to render a colored one-liner.

    Mirrors reference logging/logger.go:19-21.
    """

    def pretty_print(self, out: TextIO) -> None: ...


class Logger:
    """Leveled logger. JSON lines by default; pretty colors on a tty."""

    def __init__(self, level: Level = INFO, out: TextIO | None = None,
                 err: TextIO | None = None, pretty: bool | None = None) -> None:
        self._level = level
        # None: the process's stderr when a line is written
        self._out = out
        self._err = err if err is not None else out
        self._lock = threading.Lock()
        if pretty is None:
            pretty = self._is_terminal(self._out or sys.stderr)
        self._pretty = pretty

    # -- level management (remote log level service calls change_level)
    @property
    def level(self) -> Level:
        return self._level

    def change_level(self, level: Level) -> None:
        self._level = level

    @staticmethod
    def _is_terminal(out: TextIO) -> bool:
        try:
            return os.isatty(out.fileno())
        except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
            return False

    # -- emit
    def _log(self, level: Level, args: tuple, fields: dict[str, Any]) -> None:
        if level < self._level:
            return
        out = (self._err if level >= ERROR else self._out) or sys.stderr
        # %-style formatting when called like logger.info("x=%s", x)
        if len(args) > 1 and isinstance(args[0], str) and "%" in args[0]:
            try:
                message: Any = args[0] % args[1:]
            except (TypeError, ValueError):
                message = " ".join(str(a) for a in args)
        elif len(args) == 1:
            message = args[0]
        else:
            message = " ".join(str(a) for a in args)

        trace = _trace_ctx.get()
        if self._pretty:
            self._emit_pretty(level, message, fields, trace, out)
        else:
            self._emit_json(level, message, fields, trace, out)

    def _emit_json(self, level: Level, message: Any, fields: dict[str, Any],
                   trace: tuple[str, str] | None, out: TextIO) -> None:
        now = time.time()
        record: dict[str, Any] = {
            "level": _LEVEL_NAMES[level],
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(now))
                    + f".{int((now % 1) * 1e6):06d}Z",
        }
        if trace:
            record["trace_id"], record["span_id"] = trace
        for k, v in _fleet_ctx.items():
            record.setdefault(k, v)
        if isinstance(message, PrettyPrint):
            record["message"] = getattr(message, "__dict__", str(message))
        elif isinstance(message, (dict, list, str, int, float, bool, type(None))):
            record["message"] = message
        else:
            record["message"] = str(message)
        if fields:
            record.update(fields)
        with self._lock:
            out.write(json.dumps(record, default=str) + "\n")
            out.flush()

    def _emit_pretty(self, level: Level, message: Any, fields: dict[str, Any],
                     trace: tuple[str, str] | None, out: TextIO) -> None:
        color = _LEVEL_COLORS[level]
        name = _LEVEL_NAMES[level]
        ts = time.strftime("%H:%M:%S")
        with self._lock:
            out.write(f"\x1b[{color}m{name:<6}\x1b[0m [{ts}] ")
            if trace:
                out.write(f"\x1b[38;5;8m{trace[0]}\x1b[0m ")
            if isinstance(message, PrettyPrint):
                message.pretty_print(out)
            else:
                out.write(str(message))
            if _fleet_ctx:
                out.write(" " + " ".join(f"{k}={v}"
                                         for k, v in _fleet_ctx.items()))
            if fields:
                out.write(" " + " ".join(f"{k}={v}" for k, v in fields.items()))
            out.write("\n")
            out.flush()

    # -- the public 6-level surface (reference logger.go:26-42)
    def debug(self, *args: Any, **fields: Any) -> None:
        self._log(DEBUG, args, fields)

    def info(self, *args: Any, **fields: Any) -> None:
        self._log(INFO, args, fields)

    def notice(self, *args: Any, **fields: Any) -> None:
        self._log(NOTICE, args, fields)

    def warn(self, *args: Any, **fields: Any) -> None:
        self._log(WARN, args, fields)

    def error(self, *args: Any, **fields: Any) -> None:
        self._log(ERROR, args, fields)

    def fatal(self, *args: Any, **fields: Any) -> None:
        """Log at FATAL and terminate, matching reference logger.go:152."""
        self._log(FATAL, args, fields)
        raise SystemExit(1)

    def log(self, *args: Any, **fields: Any) -> None:
        self._log(INFO, args, fields)

    def log_at(self, level: Level, *args: Any, **fields: Any) -> None:
        self._log(level, args, fields)


class ContextLogger(Logger):
    """Logger view bound to a request; shares the base logger's sinks.

    The base logger's level is read live so a remote level change
    affects in-flight request loggers too (reference ctx_logger.go).
    """

    def __init__(self, base: Logger) -> None:
        self._base = base
        super().__init__(level=base.level, out=base._out, err=base._err,
                         pretty=base._pretty)
        self._lock = base._lock

    @property
    def level(self) -> Level:
        return self._base.level

    def _log(self, level: Level, args: tuple, fields: dict[str, Any]) -> None:
        if level < self._base.level:
            return
        self._level = self._base.level
        Logger._log(self, level, args, fields)


def new_logger(level: Level = INFO, **kw: Any) -> Logger:
    return Logger(level=level, **kw)


def new_file_logger(path: str, level: Level = INFO) -> Logger:
    """File logger for CLI apps (reference logger.go:213-232)."""
    f = open(path, "a", buffering=1)
    return Logger(level=level, out=f, err=f, pretty=False)


class MockLogger(Logger):
    """Captures records in memory for test assertions."""

    def __init__(self, level: Level = DEBUG) -> None:
        self.buffer = io.StringIO()
        super().__init__(level=level, out=self.buffer, err=self.buffer, pretty=False)

    @property
    def lines(self) -> list[dict[str, Any]]:
        return [json.loads(line) for line in self.buffer.getvalue().splitlines() if line]
