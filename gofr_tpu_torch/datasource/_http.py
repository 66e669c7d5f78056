"""Shared JSON-over-HTTP request helper for the wire clients.

The ES/Solr/OpenTSDB/Arango clients all speak JSON REST; this is their
one urlopen + error-decode path, so timeout and error handling behave
identically across them.

The port's copy of ``gofr_tpu/datasource/_http.py``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any


def json_call(endpoint: str, method: str, path: str, *,
              body: Any = None, raw_body: bytes | None = None,
              headers: dict[str, str] | None = None,
              timeout_s: float = 30.0) -> tuple[int, Any]:
    """One request; -> (status, decoded JSON | text-fallback dict).

    ``body`` is JSON-encoded; ``raw_body`` is sent verbatim (callers
    set their own Content-Type via ``headers``).
    """
    send = {"Content-Type": "application/json"}
    send.update(headers or {})
    if raw_body is not None:
        data: bytes | None = raw_body
    elif body is not None:
        data = json.dumps(body).encode()
    else:
        data = None
    req = urllib.request.Request(endpoint + path, data=data, method=method,
                                 headers=send)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            payload = r.read()
            return r.status, (json.loads(payload) if payload else None)
    except urllib.error.HTTPError as exc:
        payload = exc.read()
        try:
            return exc.code, json.loads(payload or b"null")
        except json.JSONDecodeError:
            return exc.code, {"error": payload.decode("utf-8", "replace")}
