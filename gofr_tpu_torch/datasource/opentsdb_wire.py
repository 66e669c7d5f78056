"""OpenTSDB network client speaking the HTTP API, plus a mini server.

The reference's OpenTSDB module is an HTTP client over the TSDB REST
surface (container/datasources.go:501-598, datasource/opentsdb). This
client speaks that surface directly — ``POST /api/put`` with a JSON
array of datapoints, ``POST /api/query`` with the queries envelope,
``POST /api/annotation`` and ``GET /api/annotation`` — behind the same
method surface as the embedded
:class:`~gofr_tpu_torch.datasource.timeseries.OpenTSDB` adapter, so swapping
is a constructor change.

:class:`MiniOpenTSDBServer` serves those endpoints over the embedded
adapter on the framework's HTTP server.

The port's copy of ``gofr_tpu/datasource/opentsdb_wire.py``.
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Any

from . import Instrumented
from ._http import json_call
from .miniserver import ThreadedHTTPMiniServer
from .timeseries import OpenTSDB, TimeseriesError


class OpenTSDBWireError(TimeseriesError):
    pass


class OpenTSDBWire(Instrumented):
    """HTTP client with the embedded adapter's verbs (put_data_points/
    query/put_annotation/query_annotations)."""

    metric = "app_opentsdb_stats"
    log_tag = "TSDB"

    def __init__(self, *, endpoint: str = "http://localhost:4242",
                 timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to opentsdb",
                             endpoint=self.endpoint)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, method: str, path: str,
              body: Any = None) -> tuple[int, Any]:
        return json_call(self.endpoint, method, path, body=body,
                         timeout_s=self.timeout_s)

    # ----------------------------------------------------- native verbs
    def put_data_points(self, datapoints: list[dict]) -> int:
        def op():
            status, data = self._call("POST", "/api/put?details",
                                      body=datapoints)
            if status not in (200, 204):
                raise OpenTSDBWireError(f"put -> {status}: {data}")
            if isinstance(data, dict) and data.get("failed"):
                raise OpenTSDBWireError(f"put failed points: {data}")
            return len(datapoints)
        return self._observed("PUT", f"{len(datapoints)} pts", op)

    def query(self, metric: str, aggregator: str = "sum",
              start: float | None = None, end: float | None = None,
              tags: dict | None = None) -> dict:
        def op():
            envelope: dict[str, Any] = {
                "queries": [{"metric": metric, "aggregator": aggregator,
                             "tags": tags or {}}]}
            if start is not None:
                envelope["start"] = start
            if end is not None:
                envelope["end"] = end
            status, data = self._call("POST", "/api/query", body=envelope)
            if status != 200:
                raise OpenTSDBWireError(f"query -> {status}: {data}")
            first = data[0] if data else {"metric": metric, "dps": {}}
            return {"metric": first.get("metric", metric),
                    "aggregator": aggregator,
                    "dps": first.get("dps", {}),
                    "value": first.get("value")}
        return self._observed("QUERY", metric, op)

    def put_annotation(self, annotation: dict) -> None:
        def op():
            status, data = self._call("POST", "/api/annotation",
                                      body=annotation)
            if status not in (200, 201, 204):
                raise OpenTSDBWireError(f"annotate -> {status}: {data}")
        self._observed("ANNOTATE",
                       str(annotation.get("description", ""))[:30], op)

    def query_annotations(self, start: float, end: float) -> list[dict]:
        def op():
            params = urllib.parse.urlencode({"start": start, "end": end})
            status, data = self._call("GET", f"/api/annotation?{params}")
            if status != 200:
                raise OpenTSDBWireError(f"annotations -> {status}: {data}")
            return data or []
        return self._observed("ANNOTATIONS", f"{start}-{end}", op)

    def health_check(self) -> dict[str, Any]:
        try:
            status, data = self._call("GET", "/api/version")
            return {"status": "UP" if status == 200 else "DOWN",
                    "details": {"endpoint": self.endpoint,
                                "version": (data or {}).get("version", "")}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

class MiniOpenTSDBServer(ThreadedHTTPMiniServer):
    """The OpenTSDB REST surface over the embedded adapter."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host, port)
        self.store = OpenTSDB()

    def handle(self, request) -> tuple[int, bytes, str]:
        try:
            return self._route(request)
        except (TimeseriesError, KeyError, ValueError) as exc:
            return 400, json.dumps(
                {"error": {"message": str(exc)}}).encode(), "application/json"

    def _route(self, request) -> tuple[int, bytes, str]:
        path = request.path
        if path == "/api/version":
            return 200, b'{"version": "2.4-mini"}', "application/json"
        if path.startswith("/api/put") and request.method == "POST":
            points = json.loads(request.body)
            if isinstance(points, dict):
                points = [points]
            n = self.store.put_data_points(points)
            return 200, json.dumps(
                {"success": n, "failed": 0}).encode(), "application/json"
        if path == "/api/query" and request.method == "POST":
            envelope = json.loads(request.body)
            out = []
            for q in envelope.get("queries", []):
                result = self.store.query(
                    q["metric"], q.get("aggregator", "sum"),
                    envelope.get("start"), envelope.get("end"),
                    q.get("tags") or None)
                out.append(result)
            return 200, json.dumps(out).encode(), "application/json"
        if path == "/api/annotation" and request.method == "POST":
            self.store.put_annotation(json.loads(request.body))
            return 200, b"{}", "application/json"
        if path.startswith("/api/annotation") and request.method == "GET":
            start = float(request.param("start") or 0)
            end = float(request.param("end") or 2**62)
            found = self.store.query_annotations(start, end)
            return 200, json.dumps(found).encode(), "application/json"
        return 404, b'{"error": {"message": "no route"}}', "application/json"
