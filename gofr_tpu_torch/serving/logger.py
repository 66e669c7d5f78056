"""A small logger with the JAX package's call shape
(``gofr_tpu/logging/logger.py``): ``info / warn / error(message,
**fields)``, one JSON object a line, ``{"level", "time", "message",
**fields}``, on stderr. The engine's WARNs (recompiles, cost drift,
probe mismatches, incident bundles) and errors (a crash, a restart, a
stall, with the flight recorder's dump) go through it.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, TextIO


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
