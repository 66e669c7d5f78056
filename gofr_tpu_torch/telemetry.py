"""Anonymous usage telemetry, opt-out (reference telemetry.go +
metrics/exporters/telemetry.go).

On ``app.Run`` start and stop, a minimal ping (app name/version,
framework version, event) POSTs to the telemetry endpoint — unless
``GOFR_TELEMETRY=false`` (reference constants.go:15 defaults it on;
tests disable it globally, gofr_test.go:30-33). Failures are silent
and bounded: telemetry must never delay boot/shutdown or surface
errors (the deployment may have zero egress).

The port's copy of ``gofr_tpu/telemetry.py``. The ping's request runs on a worker thread
(the port's ``service._raw_request`` is synchronous).
"""

from __future__ import annotations

import asyncio
import json
import platform
from typing import Any

from .version import FRAMEWORK

TELEMETRY_URL = "https://telemetry.gofr-tpu.dev/api/v1/ping"
TIMEOUT_S = 2.0


def enabled(config: Any) -> bool:
    import os
    # config first; a DictConfig (tests/embedding) falls through to the
    # process env so the global CI opt-out (conftest.py) always works
    value = config.get("GOFR_TELEMETRY") if hasattr(config, "get") else None
    if value in (None, ""):
        value = os.environ.get("GOFR_TELEMETRY", "true")
    return str(value).strip().lower() not in ("false", "0", "no", "off")


def payload(container: Any, event: str) -> dict:
    return {
        "event": event,
        "app_name": getattr(container, "app_name", ""),
        "app_version": getattr(container, "app_version", ""),
        "framework_version": FRAMEWORK,
        "os": platform.system().lower(),
        "python": platform.python_version(),
    }


async def ping(container: Any, event: str,
               url: str = TELEMETRY_URL) -> bool:
    """Fire one event; True iff delivered. Never raises."""
    if not enabled(container.config):
        return False
    try:
        from .service import _raw_request
        body = json.dumps(payload(container, event)).encode()
        # the port's request is synchronous: it runs on a worker thread
        resp = await asyncio.wait_for(
            asyncio.to_thread(_raw_request, "POST", url,
                              headers={"Content-Type": "application/json"},
                              body=body, timeout=TIMEOUT_S),
            timeout=TIMEOUT_S + 0.5)
        return bool(getattr(resp, "ok", False))
    except Exception:
        return False  # telemetry is best-effort by definition
