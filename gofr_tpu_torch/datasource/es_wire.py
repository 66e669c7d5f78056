"""Elasticsearch network client speaking the REST API, plus a mini
server.

The reference's Elasticsearch module is a driver-backed network client
(container/datasources.go:708-746 over go-elasticsearch). This client
speaks the database's HTTP surface directly — ``PUT /{index}/_doc/{id}``,
``GET /{index}/_doc/{id}``, ``POST /{index}/_search`` with the query
DSL, ``POST /_bulk`` with NDJSON — behind the same method surface as
the embedded :class:`~gofr_tpu_torch.datasource.document.Elasticsearch`
adapter, so swapping is a constructor change.

:class:`MiniESServer` serves the same endpoints over the embedded
adapter on the framework's HTTP server — the wire client and the
embedded engine share one search semantics by construction.

The port's copy of ``gofr_tpu/datasource/es_wire.py``.
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Any, Iterable

from . import Instrumented
from ._http import json_call
from .document import DocumentEngine, DocumentError, DocumentNotFound, \
    Elasticsearch
from .miniserver import ThreadedHTTPMiniServer


class ESWireError(DocumentError):
    pass


class ElasticsearchWire(Instrumented):
    """REST client with the embedded adapter's verbs
    (index/get/delete/search/bulk)."""

    metric = "app_elasticsearch_stats"
    log_tag = "ES"

    def __init__(self, *, endpoint: str = "http://localhost:9200",
                 timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to elasticsearch",
                             endpoint=self.endpoint)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, method: str, path: str, body: Any = None,
              *, ndjson: str | None = None) -> tuple[int, dict]:
        if ndjson is not None:
            status, data = json_call(
                self.endpoint, method, path, raw_body=ndjson.encode(),
                headers={"Content-Type": "application/x-ndjson"},
                timeout_s=self.timeout_s)
        else:
            status, data = json_call(self.endpoint, method, path,
                                     body=body, timeout_s=self.timeout_s)
        return status, data if isinstance(data, dict) else {}

    @staticmethod
    def _doc_path(index: str, doc_id: Any) -> str:
        return (f"/{urllib.parse.quote(index, safe='')}/_doc/"
                f"{urllib.parse.quote(str(doc_id), safe='')}")

    # ----------------------------------------------------- native verbs
    def index(self, index: str, doc_id: Any, document: dict) -> None:
        def op():
            status, data = self._call(
                "PUT", self._doc_path(index, doc_id), body=document)
            if status not in (200, 201):
                raise ESWireError(f"index -> {status}: {data}")
        self._observed("INDEX", index, op)

    def get(self, index: str, doc_id: Any) -> dict:
        def op():
            status, data = self._call(
                "GET", self._doc_path(index, doc_id))
            if status == 404:
                raise DocumentNotFound(f"{index}/{doc_id}")
            if status != 200:
                raise ESWireError(f"get -> {status}: {data}")
            source = dict(data.get("_source", {}))
            source["_id"] = data.get("_id", doc_id)
            return source
        return self._observed("GET", index, op)

    def delete(self, index: str, doc_id: Any) -> None:
        def op():
            status, data = self._call(
                "DELETE", self._doc_path(index, doc_id))
            if status == 404:
                raise DocumentNotFound(f"{index}/{doc_id}")
            if status != 200:
                raise ESWireError(f"delete -> {status}: {data}")
        self._observed("DELETE", index, op)

    def search(self, index: str, query: dict | None = None,
               size: int = 10) -> dict:
        def op():
            body = {"size": size}
            if query is not None:
                body["query"] = query
            status, data = self._call(
                "POST", f"/{urllib.parse.quote(index)}/_search", body=body)
            if status != 200:
                raise ESWireError(f"search -> {status}: {data}")
            return data
        return self._observed("SEARCH", index, op)

    def bulk(self, index: str, documents: Iterable[tuple[Any, dict]]) -> int:
        docs = list(documents)

        def op():
            lines = []
            for doc_id, doc in docs:
                lines.append(json.dumps(
                    {"index": {"_index": index, "_id": doc_id}}))
                lines.append(json.dumps(doc))
            status, data = self._call("POST", "/_bulk",
                                      ndjson="\n".join(lines) + "\n")
            if status != 200 or data.get("errors"):
                raise ESWireError(f"bulk -> {status}: {data}")
            return len(docs)
        return self._observed("BULK", index, op)

    def health_check(self) -> dict[str, Any]:
        try:
            status, data = self._call("GET", "/_cluster/health")
            up = status == 200 and data.get("status") in ("green", "yellow")
            return {"status": "UP" if up else "DOWN",
                    "details": {"endpoint": self.endpoint,
                                "cluster_status": data.get("status")}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

class MiniESServer(ThreadedHTTPMiniServer):
    """The Elasticsearch REST surface over the embedded adapter —
    search semantics are shared with the in-process backend by
    delegation, not reimplementation."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host, port)
        self.store = Elasticsearch(DocumentEngine())

    def handle(self, request) -> tuple[int, bytes, str]:
        try:
            return self._route(request)
        except DocumentNotFound:
            return 404, b'{"found": false}', "application/json"
        except DocumentError as exc:
            return 400, json.dumps(
                {"error": str(exc)}).encode(), "application/json"

    def _route(self, request) -> tuple[int, bytes, str]:
        parts = [p for p in request.path.split("/") if p]
        if request.path == "/_cluster/health":
            return 200, b'{"status": "green"}', "application/json"
        if parts and parts[0] == "_bulk":
            return self._bulk(request.body)
        if len(parts) == 2 and parts[1] == "_search":
            body = json.loads(request.body or b"{}")
            result = self.store.search(parts[0], body.get("query"),
                                       size=int(body.get("size", 10)))
            return 200, json.dumps(result).encode(), "application/json"
        if len(parts) == 3 and parts[1] == "_doc":
            index, doc_id = parts[0], parts[2]
            if request.method == "PUT":
                created = True
                try:
                    self.store.get(index, doc_id)
                    created = False
                except DocumentNotFound:
                    pass
                self.store.index(index, doc_id,
                                 json.loads(request.body or b"{}"))
                return (201 if created else 200), json.dumps(
                    {"_index": index, "_id": doc_id,
                     "result": "created" if created else "updated"}
                ).encode(), "application/json"
            if request.method == "GET":
                doc = self.store.get(index, doc_id)
                source = {k: v for k, v in doc.items() if k != "_id"}
                return 200, json.dumps(
                    {"_index": index, "_id": doc_id, "found": True,
                     "_source": source}).encode(), "application/json"
            if request.method == "DELETE":
                self.store.get(index, doc_id)  # 404 when absent
                self.store.delete(index, doc_id)
                return 200, json.dumps(
                    {"_id": doc_id, "result": "deleted"}
                ).encode(), "application/json"
        return 400, b'{"error": "unsupported route"}', "application/json"

    def _bulk(self, body: bytes) -> tuple[int, bytes, str]:
        lines = [ln for ln in body.decode().splitlines() if ln.strip()]
        items = []
        i = 0
        while i < len(lines):
            action = json.loads(lines[i])
            if "index" not in action:
                return 400, b'{"error": "only index actions supported"}', \
                    "application/json"
            meta = action["index"]
            doc = json.loads(lines[i + 1])
            self.store.index(meta["_index"], meta["_id"], doc)
            items.append({"index": {"_id": meta["_id"], "status": 200}})
            i += 2
        return 200, json.dumps(
            {"errors": False, "items": items}).encode(), "application/json"
