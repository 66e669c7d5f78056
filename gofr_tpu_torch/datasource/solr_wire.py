"""Solr network client speaking the HTTP API, plus a mini server.

The reference's Solr module is an HTTP client over the Solr REST
surface (container/datasources.go:386-406, datasource/solr). This
client speaks that surface directly — ``POST /solr/{core}/update``
with JSON documents (add and delete commands),
``GET /solr/{core}/select?q=...&rows=...`` — behind the same method
surface as the embedded :class:`~gofr_tpu_torch.datasource.document.Solr`
adapter, so swapping is a constructor change.

:class:`MiniSolrServer` serves those endpoints over the embedded
adapter on the framework's HTTP server, sharing search semantics with
the in-process backend by delegation.

The port's copy of ``gofr_tpu/datasource/solr_wire.py``.
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Any, Iterable

from . import Instrumented
from ._http import json_call
from .document import DocumentEngine, DocumentError, Solr
from .miniserver import ThreadedHTTPMiniServer


class SolrWireError(DocumentError):
    pass


class SolrWire(Instrumented):
    """HTTP client with the embedded adapter's verbs
    (add/search/delete)."""

    metric = "app_solr_stats"
    log_tag = "SOLR"

    def __init__(self, *, endpoint: str = "http://localhost:8983",
                 timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to solr", endpoint=self.endpoint)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, method: str, path: str,
              body: Any = None) -> tuple[int, dict]:
        status, data = json_call(self.endpoint, method, path, body=body,
                                 timeout_s=self.timeout_s)
        return status, data if isinstance(data, dict) else {}

    # ----------------------------------------------------- native verbs
    def add(self, core: str, documents: Iterable[dict]) -> int:
        docs = list(documents)

        def op():
            status, data = self._call(
                "POST",
                f"/solr/{urllib.parse.quote(core)}/update?commit=true",
                body=docs)
            if status != 200:
                raise SolrWireError(f"add -> {status}: {data}")
            return len(docs)
        return self._observed("ADD", core, op)

    def search(self, core: str, query: str, rows: int = 10) -> dict:
        def op():
            params = urllib.parse.urlencode({"q": query, "rows": rows,
                                             "wt": "json"})
            status, data = self._call(
                "GET", f"/solr/{urllib.parse.quote(core)}/select?{params}")
            if status != 200:
                raise SolrWireError(f"search -> {status}: {data}")
            return data
        return self._observed("SEARCH", core, op)

    def delete(self, core: str, doc_id: Any) -> None:
        def op():
            status, data = self._call(
                "POST",
                f"/solr/{urllib.parse.quote(core)}/update?commit=true",
                body={"delete": {"id": doc_id}})
            if status != 200:
                raise SolrWireError(f"delete -> {status}: {data}")
        self._observed("DELETE", core, op)

    def health_check(self) -> dict[str, Any]:
        try:
            status, data = self._call(
                "GET", "/solr/admin/info/system?wt=json")
            return {"status": "UP" if status == 200 else "DOWN",
                    "details": {"endpoint": self.endpoint,
                                "solr_version":
                                    data.get("lucene", {}).get(
                                        "solr-spec-version", "")}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

class MiniSolrServer(ThreadedHTTPMiniServer):
    """The Solr HTTP surface over the embedded adapter."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host, port)
        self.store = Solr(DocumentEngine())

    def handle(self, request) -> tuple[int, bytes, str]:
        try:
            return self._route(request)
        except DocumentError as exc:
            return 400, json.dumps(
                {"error": str(exc)}).encode(), "application/json"

    def _route(self, request) -> tuple[int, bytes, str]:
        parts = [p for p in request.path.split("/") if p]
        if request.path.startswith("/solr/admin/info/system"):
            return 200, json.dumps(
                {"lucene": {"solr-spec-version": "9.0-mini"}}
            ).encode(), "application/json"
        if len(parts) == 3 and parts[0] == "solr":
            core, verb = parts[1], parts[2]
            if verb == "update" and request.method == "POST":
                body = json.loads(request.body or b"null")
                if isinstance(body, list):
                    self.store.add(core, body)
                    return 200, b'{"responseHeader": {"status": 0}}', \
                        "application/json"
                if isinstance(body, dict) and "delete" in body:
                    self.store.delete(core, body["delete"].get("id"))
                    return 200, b'{"responseHeader": {"status": 0}}', \
                        "application/json"
                return 400, b'{"error": "unsupported update body"}', \
                    "application/json"
            if verb == "select":
                query = request.param("q") or "*:*"
                rows = int(request.param("rows") or "10")
                result = self.store.search(core, query, rows=rows)
                result["responseHeader"] = {"status": 0}
                return 200, json.dumps(result).encode(), "application/json"
        return 400, b'{"error": "unsupported route"}', "application/json"
