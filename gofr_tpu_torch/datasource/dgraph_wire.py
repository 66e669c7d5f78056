"""Dgraph network client speaking the HTTP API, plus a mini server.

The reference's Dgraph module is a driver-backed network client
(container/datasources.go:408-499 over dgo/gRPC; Dgraph also serves
the same operations over HTTP, which this client speaks):
``POST /mutate?commitNow=true`` with a JSON ``set`` mutation,
``POST /query`` with DQL text, ``POST /alter`` with schema text.
``query(flt, expand)`` *generates* real DQL —
``{ q(func: eq(k, v)) @filter(eq(k2, v2)) { uid expand(_all_) … } }``
— so the bytes on the wire are valid against a real Dgraph alpha. The
method surface mirrors the embedded
:class:`~gofr_tpu_torch.datasource.graph.Dgraph` adapter.

:class:`MiniDgraphServer` serves those endpoints over the embedded
adapter, parsing the DQL subset the client emits.

The port's copy of ``gofr_tpu/datasource/dgraph_wire.py``.
"""

from __future__ import annotations

import json
import re
from typing import Any

from . import Instrumented
from ._http import json_call
from .graph import Dgraph, GraphEngine, GraphError
from .miniserver import ThreadedHTTPMiniServer


class DgraphWireError(GraphError):
    pass


def _dql_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return str(value)
    text = str(value).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{text}"'


def build_query_dql(flt: dict, expand: str | None = None) -> str:
    """Filter dict -> one DQL block valid against real Dgraph.

    Predicate names (and the expand edge) ride in the query text, so
    they are validated; values are escaped into DQL literals.
    """
    for name in (*flt, *( [expand] if expand else [] )):
        if not re.fullmatch(r"\w[\w.]*", str(name)):
            raise DgraphWireError(f"invalid predicate name {name!r}")
    items = sorted(flt.items())
    if items:
        k0, v0 = items[0]
        func = f"eq({k0}, {_dql_value(v0)})"
    else:
        func = "has(dgraph.type)"
    filters = " AND ".join(f"eq({k}, {_dql_value(v)})"
                           for k, v in items[1:])
    body = "uid expand(_all_)"
    if expand:
        body += f" {expand} {{ uid expand(_all_) }}"
    dql = f"{{ q(func: {func})"
    if filters:
        dql += f" @filter({filters})"
    return dql + f" {{ {body} }} }}"


class DgraphWire(Instrumented):
    """HTTP client with the embedded adapter's verbs
    (mutate/query/alter)."""

    metric = "app_dgraph_stats"
    log_tag = "DGRAPH"

    def __init__(self, *, endpoint: str = "http://localhost:8080",
                 timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to dgraph", endpoint=self.endpoint)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, path: str, raw: bytes,
              content_type: str) -> tuple[int, Any]:
        return json_call(self.endpoint, "POST", path, raw_body=raw,
                         headers={"Content-Type": content_type},
                         timeout_s=self.timeout_s)

    @staticmethod
    def _check(status: int, data: Any, op: str) -> dict:
        if status != 200 or (isinstance(data, dict) and data.get("errors")):
            raise DgraphWireError(f"{op} -> {status}: {data}")
        return data.get("data", {}) if isinstance(data, dict) else {}

    # ----------------------------------------------------- native verbs
    def mutate(self, set_json: dict | list[dict]) -> dict[str, str]:
        docs = set_json if isinstance(set_json, list) else [set_json]

        def op():
            status, data = self._call(
                "/mutate?commitNow=true",
                json.dumps({"set": docs}).encode(), "application/json")
            return self._check(status, data, "mutate").get("uids", {})
        return self._observed("MUTATE", f"{len(docs)} docs", op)

    def query(self, flt: dict, expand: str | None = None) -> list[dict]:
        def op():
            dql = build_query_dql(flt, expand)
            status, data = self._call("/query", dql.encode(),
                                      "application/dql")
            return self._check(status, data, "query").get("q", [])
        return self._observed("QUERY", str(sorted(flt)), op)

    def alter(self, schema: str) -> None:
        def op():
            status, data = self._call("/alter", schema.encode(),
                                      "application/rdf")
            self._check(status, data, "alter")
        self._observed("ALTER", schema[:40], op)

    def health_check(self) -> dict[str, Any]:
        try:
            status, data = json_call(self.endpoint, "GET", "/health",
                                     timeout_s=self.timeout_s)
            healthy = status == 200
            if isinstance(data, list) and data:
                healthy = healthy and data[0].get("status") == "healthy"
            return {"status": "UP" if healthy else "DOWN",
                    "details": {"endpoint": self.endpoint}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

# quote-aware: a quoted value may contain " AND ", ")" or escaped
# quotes — the value pattern consumes the whole literal before the
# closing paren is matched
_EQ_RE = re.compile(
    r'eq\((\w[\w.]*),\s*(?:"((?:[^"\\]|\\.)*)"|([^)"]+))\)')
_HEAD_RE = re.compile(r"\{\s*q\(func:\s*(eq|has)\(")
_EDGE_RE = re.compile(r"uid expand\(_all_\)\s*(?:(\w+)\s*\{)?")


def _decode_eq(match: "re.Match[str]") -> tuple[str, Any]:
    key, quoted, bare = match.groups()
    if quoted is not None:
        value: Any = quoted.replace('\\"', '"').replace("\\\\", "\\")
    else:
        text = bare.strip()
        if text in ("true", "false"):
            value = text == "true"
        else:
            try:
                value = int(text)
            except ValueError:
                try:
                    value = float(text)
                except ValueError:
                    raise DgraphWireError(
                        f"unsupported DQL value: {text!r}") from None
    return key, value


class MiniDgraphServer(ThreadedHTTPMiniServer):
    """The Dgraph HTTP surface over the embedded adapter, parsing the
    DQL subset :func:`build_query_dql` emits."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host, port)
        self.store = Dgraph(GraphEngine())

    def handle(self, request) -> tuple[int, bytes, str]:
        try:
            return self._route(request)
        except (GraphError, ValueError) as exc:
            return 200, json.dumps(  # dgraph reports errors in-body
                {"errors": [{"message": str(exc)}]}).encode(), \
                "application/json"

    def _route(self, request) -> tuple[int, bytes, str]:
        path = request.path
        if path == "/health":
            return 200, b'[{"status": "healthy"}]', "application/json"
        if path.startswith("/mutate") and request.method == "POST":
            body = json.loads(request.body)
            uids = self.store.mutate(body.get("set", []))
            return 200, json.dumps(
                {"data": {"uids": uids}}).encode(), "application/json"
        if path == "/query" and request.method == "POST":
            return self._query(request.body.decode())
        if path == "/alter" and request.method == "POST":
            self.store.alter(request.body.decode())
            return 200, b'{"data": {"code": "Success"}}', \
                "application/json"
        return 404, b'{"errors": [{"message": "no route"}]}', \
            "application/json"

    def _query(self, dql: str) -> tuple[int, bytes, str]:
        text = dql.strip()
        head = _HEAD_RE.match(text)
        if not head or "uid expand(_all_)" not in text:
            raise DgraphWireError(f"unsupported DQL: {dql!r}")
        # every eq(...) — func position and @filter conditions alike —
        # contributes one filter entry; the quote-aware regex keeps
        # values containing " AND " or ")" intact
        flt: dict[str, Any] = {}
        for match in _EQ_RE.finditer(text):
            key, value = _decode_eq(match)
            flt[key] = value
        if head.group(1) == "eq" and not flt:
            raise DgraphWireError(f"unsupported DQL predicate in {dql!r}")
        edge = _EDGE_RE.search(text)
        expand = edge.group(1) if edge else None
        rows = self.store.query(flt, expand)
        return 200, json.dumps(
            {"data": {"q": rows}}).encode(), "application/json"
