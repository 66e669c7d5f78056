"""A small logger with the JAX package's call shape
(``gofr_tpu/logging/logger.py``): ``info / warn / error(message,
**fields)``, one JSON object a line, ``{"level", "time", "message",
**fields}``, on stderr. The engine's WARNs (recompiles, cost drift,
probe mismatches, incident bundles) and errors (a crash, a restart, a
stall, with the flight recorder's dump) go through it.

The process-wide **fleet context** (``host_id``, ``rank``,
``generation``: :func:`set_fleet_context`, set at a control-plane join
and on every re-rank) is merged into every record under its own fields,
and into every span by the tracer, so one grep and one trace correlate a
leader with its workers.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, TextIO

#: host identity for multi-host serving: a plain dict, not a context
#: variable, because the whole process is one host
_fleet_ctx: dict[str, Any] = {}


def set_fleet_context(**attrs: Any) -> None:
    """Merge host identity (``host_id``, ``rank``, ``generation``) into
    the process-wide fleet context; None values are dropped."""
    _fleet_ctx.update({k: v for k, v in attrs.items() if v is not None})


def clear_fleet_context() -> None:
    _fleet_ctx.clear()


def current_fleet_context() -> dict[str, Any]:
    return dict(_fleet_ctx)


class Logger:
    """JSON lines to ``out`` (default: stderr at the time of writing)."""

    def __init__(self, out: TextIO | None = None) -> None:
        self._out = out
        self._lock = threading.Lock()

    def _log(self, level: str, message: Any, fields: dict) -> None:
        now = time.time()
        record = {"level": level,
                  "time": time.strftime("%Y-%m-%dT%H:%M:%S",
                                        time.gmtime(now))
                  + f".{int((now % 1) * 1e6):06d}Z",
                  "message": message, **fields}
        for k, v in _fleet_ctx.items():
            record.setdefault(k, v)
        out = self._out if self._out is not None else sys.stderr
        with self._lock:
            out.write(json.dumps(record, default=str) + "\n")
            out.flush()

    def info(self, message: Any, **fields: Any) -> None:
        self._log("INFO", message, fields)

    def warn(self, message: Any, **fields: Any) -> None:
        self._log("WARN", message, fields)

    def error(self, message: Any, **fields: Any) -> None:
        self._log("ERROR", message, fields)
