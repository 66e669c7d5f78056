"""ArangoDB network client speaking the HTTP document API, plus a mini
server.

The reference's ArangoDB module is a driver-backed network client
(container/datasources.go:637-706 over arangodb/go-driver). This
client speaks the database's HTTP surface directly — document CRUD
(``POST/GET/PATCH/DELETE /_db/{db}/_api/document/...``), edge
documents (``_from``/``_to``), by-example queries
(``PUT /_api/simple/by-example``), and graph traversal
(``POST /_api/traversal``) — with HTTP basic auth, behind the same
method surface as the embedded
:class:`~gofr_tpu_torch.datasource.graph.ArangoDB` adapter, so swapping is a
constructor change.

:class:`MiniArangoServer` serves those endpoints over the embedded
adapter on the framework's HTTP server, rejecting bad credentials with
401 like a real deployment.

The port's copy of ``gofr_tpu/datasource/arango_wire.py``.
"""

from __future__ import annotations

import base64
import json
import urllib.parse
from typing import Any

from . import Instrumented
from ._http import json_call
from .graph import ArangoDB, GraphEngine, GraphError, NodeNotFound
from .miniserver import ThreadedHTTPMiniServer


class ArangoWireError(GraphError):
    pass


class ArangoWire(Instrumented):
    """HTTP client with the embedded adapter's verbs (create/get/
    update/delete document, edge documents, query, traversal)."""

    metric = "app_arangodb_stats"
    log_tag = "ARANGO"

    def __init__(self, *, endpoint: str = "http://localhost:8529",
                 database: str = "_system", username: str = "root",
                 password: str = "", timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.database = database
        self.username = username
        self.password = password
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to arangodb",
                             endpoint=self.endpoint, database=self.database)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, method: str, path: str,
              body: Any = None) -> tuple[int, Any]:
        token = base64.b64encode(
            f"{self.username}:{self.password}".encode()).decode()
        status, data = json_call(
            self.endpoint, method,
            f"/_db/{urllib.parse.quote(self.database)}{path}", body=body,
            headers={"Authorization": f"Basic {token}"},
            timeout_s=self.timeout_s)
        return status, data if data is not None else {}

    @staticmethod
    def _key_of(arango_id: str) -> str:
        """``collection/key`` -> ``key`` (the embedded adapter's ids)."""
        return arango_id.rpartition("/")[2]

    # ----------------------------------------------------- native verbs
    def create_document(self, collection: str, document: dict) -> str:
        def op():
            status, data = self._call(
                "POST",
                f"/_api/document/{urllib.parse.quote(collection)}",
                body=document)
            if status not in (200, 201, 202):
                raise ArangoWireError(f"create -> {status}: {data}")
            return data["_key"]
        return self._observed("CREATE_DOC", collection, op)

    def get_document(self, collection: str, doc_id: str) -> dict:
        def op():
            status, data = self._call(
                "GET", f"/_api/document/{urllib.parse.quote(collection)}/"
                       f"{urllib.parse.quote(doc_id)}")
            if status == 404:
                raise NodeNotFound(f"{collection}/{doc_id}")
            if status != 200:
                raise ArangoWireError(f"get -> {status}: {data}")
            return {k: v for k, v in data.items()
                    if k not in ("_id", "_key", "_rev")}
        return self._observed("GET_DOC", collection, op)

    def update_document(self, collection: str, doc_id: str,
                        changes: dict) -> None:
        def op():
            status, data = self._call(
                "PATCH",
                f"/_api/document/{urllib.parse.quote(collection)}/"
                f"{urllib.parse.quote(doc_id)}", body=changes)
            if status == 404:
                raise NodeNotFound(f"{collection}/{doc_id}")
            if status not in (200, 201, 202):
                raise ArangoWireError(f"update -> {status}: {data}")
        self._observed("UPDATE_DOC", collection, op)

    def delete_document(self, collection: str, doc_id: str) -> None:
        def op():
            status, data = self._call(
                "DELETE",
                f"/_api/document/{urllib.parse.quote(collection)}/"
                f"{urllib.parse.quote(doc_id)}")
            if status == 404:
                raise NodeNotFound(f"{collection}/{doc_id}")
            if status not in (200, 202):
                raise ArangoWireError(f"delete -> {status}: {data}")
        self._observed("DELETE_DOC", collection, op)

    def create_edge_document(self, edge_collection: str, from_id: str,
                             to_id: str) -> None:
        # the embedded adapter takes bare keys; the wire format demands
        # collection/key — accept both
        if "/" not in from_id:
            from_id = f"v/{from_id}"
        if "/" not in to_id:
            to_id = f"v/{to_id}"

        def op():
            status, data = self._call(
                "POST",
                f"/_api/document/{urllib.parse.quote(edge_collection)}",
                body={"_from": from_id, "_to": to_id})
            if status not in (200, 201, 202):
                raise ArangoWireError(f"edge -> {status}: {data}")
        self._observed("CREATE_EDGE", edge_collection, op)

    def query(self, collection: str, flt: dict | None = None) -> list[dict]:
        def op():
            status, data = self._call(
                "PUT", "/_api/simple/by-example",
                body={"collection": collection, "example": flt or {}})
            if status != 201:
                raise ArangoWireError(f"query -> {status}: {data}")
            out = []
            for doc in data.get("result", []):
                row = {k: v for k, v in doc.items()
                       if k not in ("_id", "_key", "_rev")}
                row["_id"] = self._key_of(doc.get("_id", ""))
                out.append(row)
            return out
        return self._observed("QUERY", collection, op)

    def traversal(self, start_id: str, edge_collection: str,
                  depth: int = 1) -> list[dict]:
        def op():
            status, data = self._call(
                "POST", "/_api/traversal",
                body={"startVertex": start_id,
                      "edgeCollection": edge_collection,
                      "direction": "outbound", "maxDepth": depth})
            if status != 200:
                raise ArangoWireError(f"traversal -> {status}: {data}")
            out = []
            vertices = data.get("result", {}).get("visited", {}) \
                .get("vertices", [])
            for doc in vertices:
                row = {k: v for k, v in doc.items()
                       if k not in ("_id", "_key", "_rev")}
                row["_id"] = self._key_of(doc.get("_id", ""))
                out.append(row)
            return out
        return self._observed("TRAVERSAL", edge_collection, op)

    def health_check(self) -> dict[str, Any]:
        try:
            status, data = self._call("GET", "/_api/version")
            return {"status": "UP" if status == 200 else "DOWN",
                    "details": {"endpoint": self.endpoint,
                                "version": data.get("version", "")}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

class MiniArangoServer(ThreadedHTTPMiniServer):
    """The ArangoDB HTTP document surface over the embedded adapter."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 username: str = "root", password: str = "") -> None:
        super().__init__(host, port)
        self.username = username
        self.password = password
        self.store = ArangoDB(GraphEngine())

    def _authorized(self, request) -> bool:
        if not self.password:
            return True
        got = request.headers.get("authorization", "")
        want = base64.b64encode(
            f"{self.username}:{self.password}".encode()).decode()
        return got == f"Basic {want}"

    def handle(self, request) -> tuple[int, bytes, str]:
        if not self._authorized(request):
            return 401, b'{"error": true, "code": 401}', "application/json"
        try:
            return self._route(request)
        except NodeNotFound as exc:
            return 404, json.dumps(
                {"error": True, "code": 404,
                 "errorMessage": str(exc)}).encode(), "application/json"
        except GraphError as exc:
            return 400, json.dumps(
                {"error": True, "code": 400,
                 "errorMessage": str(exc)}).encode(), "application/json"

    def _route(self, request) -> tuple[int, bytes, str]:
        path = request.path
        # strip the /_db/{name} prefix real deployments use
        if path.startswith("/_db/"):
            path = "/" + path.split("/", 3)[3]
        if path == "/_api/version":
            return 200, b'{"server": "arango", "version": "3.11-mini"}', \
                "application/json"
        if path == "/_api/simple/by-example" and request.method == "PUT":
            body = json.loads(request.body)
            docs = self.store.query(body["collection"],
                                    body.get("example") or None)
            result = [dict(d, _id=f"{body['collection']}/{d['_id']}",
                           _key=d["_id"]) for d in docs]
            return 201, json.dumps(
                {"result": result, "count": len(result)}).encode(), \
                "application/json"
        if path == "/_api/traversal" and request.method == "POST":
            body = json.loads(request.body)
            docs = self.store.traversal(body["startVertex"],
                                        body["edgeCollection"],
                                        int(body.get("maxDepth", 1)))
            vertices = [dict(d, _id=f"v/{d['_id']}", _key=d["_id"])
                        for d in docs]
            return 200, json.dumps(
                {"result": {"visited": {"vertices": vertices,
                                        "paths": []}}}).encode(), \
                "application/json"
        if path.startswith("/_api/document/"):
            rest = path[len("/_api/document/"):]
            collection, _, key = rest.partition("/")
            if request.method == "POST":
                doc = json.loads(request.body)
                if "_from" in doc and "_to" in doc:
                    self.store.create_edge_document(
                        collection,
                        doc["_from"].rpartition("/")[2],
                        doc["_to"].rpartition("/")[2])
                    new_key = ""
                else:
                    new_key = self.store.create_document(collection, doc)
                return 201, json.dumps(
                    {"_id": f"{collection}/{new_key}",
                     "_key": new_key}).encode(), "application/json"
            if request.method == "GET":
                doc = self.store.get_document(collection, key)
                doc.update(_id=f"{collection}/{key}", _key=key)
                return 200, json.dumps(doc).encode(), "application/json"
            if request.method == "PATCH":
                self.store.update_document(collection, key,
                                           json.loads(request.body))
                return 200, json.dumps(
                    {"_id": f"{collection}/{key}",
                     "_key": key}).encode(), "application/json"
            if request.method == "DELETE":
                self.store.get_document(collection, key)  # 404 if absent
                self.store.delete_document(collection, key)
                return 200, json.dumps(
                    {"_id": f"{collection}/{key}"}).encode(), \
                    "application/json"
        return 400, b'{"error": true, "code": 400}', "application/json"
