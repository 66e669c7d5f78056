"""Remote log-level switching (reference
logging/remotelogger/dynamic_level_logger.go:141-214).

A background task polls ``REMOTE_LOG_URL`` every
``REMOTE_LOG_FETCH_INTERVAL`` seconds and applies the returned level to
the live logger via ``change_level`` — turn DEBUG on in production
without a restart. Accepts both the reference's response shape
(``{"data": [{"serviceName": ..., "logLevel": {"LOG_LEVEL": "DEBUG"}}]}``)
and a plain ``{"level": "DEBUG"}``.

The port's copy of ``gofr_tpu/logging/remote.py``. The port's service client is synchronous, so
each fetch runs on a worker thread.
"""

from __future__ import annotations

import asyncio
from typing import Any

from .logger import _LEVEL_NAMES, level_from_string

DEFAULT_INTERVAL_S = 15.0


def parse_level_response(payload: Any) -> str | None:
    """Extract a level name from either supported response shape."""
    if not isinstance(payload, dict):
        return None
    if isinstance(payload.get("level"), str):
        return payload["level"]
    data = payload.get("data")
    if isinstance(data, dict):
        data = [data]
    if isinstance(data, list):
        for entry in data:
            if not isinstance(entry, dict):
                continue
            log_level = entry.get("logLevel")
            if isinstance(log_level, dict) and \
                    isinstance(log_level.get("LOG_LEVEL"), str):
                return log_level["LOG_LEVEL"]
            if isinstance(entry.get("LOG_LEVEL"), str):
                return entry["LOG_LEVEL"]
    return None


class RemoteLevelUpdater:
    """Poll loop; ``service`` is anything with ``get(path) -> Response``
    (an HTTPService — circuit breaker/retry options apply), called on a
    worker thread since the port's service client is synchronous."""

    def __init__(self, logger: Any, service: Any, path: str = "",
                 interval_s: float = DEFAULT_INTERVAL_S) -> None:
        self.logger = logger
        self.service = service
        self.path = path
        self.interval_s = interval_s
        self.fetches = 0
        self.applied = 0

    async def poll_once(self) -> bool:
        """One fetch+apply; True iff the level changed."""
        self.fetches += 1
        try:
            resp = await asyncio.to_thread(self.service.get, self.path)
            if not getattr(resp, "ok", False):
                return False
            name = parse_level_response(resp.json())
        except Exception as exc:
            self.logger.debug(f"remote level fetch failed: {exc}")
            return False
        if name is None or (name or "").upper() not in _LEVEL_NAMES.values():
            # unknown names must not coerce to INFO — a garbage response
            # would silently change the production log level
            return False
        new_level = level_from_string(name)
        if new_level == self.logger.level:
            return False
        self.logger.info(
            f"LOG_LEVEL updated from "
            f"{_LEVEL_NAMES.get(self.logger.level, '?')} to "
            f"{_LEVEL_NAMES.get(new_level, '?')}")
        self.logger.change_level(new_level)
        self.applied += 1
        return True

    async def run(self) -> None:
        while True:
            await self.poll_once()
            await asyncio.sleep(self.interval_s)


def from_config(config: Any, logger: Any,
                metrics: Any = None) -> RemoteLevelUpdater | None:
    """Build the updater when REMOTE_LOG_URL is configured (reference
    container.go:107 wires remotelogger.New the same way)."""
    url = config.get_or_default("REMOTE_LOG_URL", "")
    if not url:
        return None
    try:
        interval = float(config.get_or_default("REMOTE_LOG_FETCH_INTERVAL",
                                               str(DEFAULT_INTERVAL_S)))
    except ValueError:
        logger.error("invalid REMOTE_LOG_FETCH_INTERVAL; using default")
        interval = DEFAULT_INTERVAL_S
    # a zero/negative interval would hot-loop against the endpoint
    interval = max(interval, 1.0)
    from ..service import HTTPService
    from urllib.parse import urlsplit
    parts = urlsplit(url)
    base = f"{parts.scheme}://{parts.netloc}"
    path = parts.path + (f"?{parts.query}" if parts.query else "")
    service = HTTPService(base, logger=logger, metrics=metrics,
                          timeout=10.0, service_name="remote-logger")
    return RemoteLevelUpdater(logger, service, path=path,
                              interval_s=interval)
