"""Graph family: Dgraph-, ArangoDB- and SurrealDB-shaped stores over
one embedded property-graph engine.

Reference interfaces: Dgraph container/datasources.go:408-499 (query /
mutate / alter), ArangoDB :637-706 (databases, collections, documents,
edge collections, graph traversal), SurrealDB :302-344 (record ids
``table:id``, query/create/update/delete). Each adapter exposes its
store's native surface over :class:`GraphEngine`; a production
deployment swaps the engine for a network client behind the same
interface.

The port's copy of ``gofr_tpu/datasource/graph.py``.
"""

from __future__ import annotations

import copy
import itertools
import threading
from typing import Any

from . import Instrumented


class GraphError(Exception):
    pass


class NodeNotFound(GraphError):
    pass


class GraphEngine:
    """Embedded property graph: nodes with attributes, labeled edges."""

    def __init__(self) -> None:
        self._nodes: dict[str, dict] = {}
        self._edges: dict[str, list[tuple[str, str]]] = {}  # label -> [(from,to)]
        self._lock = threading.RLock()
        self._ids = itertools.count(1)

    def put_node(self, node_id: str | None, attrs: dict) -> str:
        with self._lock:
            if node_id is None:
                node_id = f"0x{next(self._ids):x}"
            node = self._nodes.setdefault(node_id, {})
            node.update(copy.deepcopy(attrs))
            return node_id

    def get_node(self, node_id: str) -> dict:
        with self._lock:
            if node_id not in self._nodes:
                raise NodeNotFound(node_id)
            return copy.deepcopy(self._nodes[node_id])

    def delete_node(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)
            for label in self._edges:
                self._edges[label] = [
                    (f, t) for f, t in self._edges[label]
                    if f != node_id and t != node_id]

    def add_edge(self, label: str, from_id: str, to_id: str) -> None:
        with self._lock:
            for node_id in (from_id, to_id):
                if node_id not in self._nodes:
                    raise NodeNotFound(node_id)
            self._edges.setdefault(label, []).append((from_id, to_id))

    def out_neighbors(self, node_id: str, label: str) -> list[str]:
        with self._lock:
            return [t for f, t in self._edges.get(label, []) if f == node_id]

    def find_nodes(self, flt: dict) -> list[tuple[str, dict]]:
        with self._lock:
            return [(nid, copy.deepcopy(n)) for nid, n in self._nodes.items()
                    if all(n.get(k) == v for k, v in flt.items())]

    def traverse(self, start: str, label: str, depth: int) -> list[str]:
        """BFS over one edge label up to ``depth`` hops (Arango-style)."""
        seen, frontier, order = {start}, [start], []
        for _ in range(depth):
            nxt = []
            for nid in frontier:
                for t in self.out_neighbors(nid, label):
                    if t not in seen:
                        seen.add(t)
                        order.append(t)
                        nxt.append(t)
            frontier = nxt
        return order

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"nodes": len(self._nodes),
                    "edges": sum(len(v) for v in self._edges.values())}


class _GraphStore(Instrumented):
    backend_name = "graph"

    def __init__(self, engine: GraphEngine | None = None) -> None:
        self.engine = engine if engine is not None else GraphEngine()

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.debug(f"connected {self.backend_name} store")

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "details": {"backend": self.backend_name,
                                            **self.engine.stats()}}

    def close(self) -> None:
        pass


class Dgraph(_GraphStore):
    """Dgraph-shaped surface (reference container/datasources.go:408-499):
    ``mutate`` set-nquad-style dicts, ``query`` by attribute filter,
    ``alter`` (schema ops are accepted and recorded)."""

    metric = "app_dgraph_stats"
    log_tag = "DGRAPH"
    backend_name = "dgraph"

    def __init__(self, engine: GraphEngine | None = None) -> None:
        super().__init__(engine)
        self.schema: list[str] = []

    def mutate(self, set_json: dict | list[dict]) -> dict[str, str]:
        """Insert nodes; list-valued attrs of dicts become edges.
        Returns assigned uids keyed by client-side "uid" markers."""
        docs = set_json if isinstance(set_json, list) else [set_json]
        def op():
            uids: dict[str, str] = {}
            for doc in docs:
                scalar = {k: v for k, v in doc.items()
                          if not isinstance(v, (dict, list)) and k != "uid"}
                marker = doc.get("uid")
                node_id = self.engine.put_node(
                    marker if marker and not str(marker).startswith("_:")
                    else None, scalar)
                if marker:
                    uids[str(marker).lstrip("_:")] = node_id
                for key, value in doc.items():
                    children = (value if isinstance(value, list)
                                else [value] if isinstance(value, dict) else [])
                    for child in children:
                        if not isinstance(child, dict):
                            continue
                        child_id = self.engine.put_node(
                            None, {k: v for k, v in child.items()
                                   if not isinstance(v, (dict, list))})
                        self.engine.add_edge(key, node_id, child_id)
            return uids
        return self._observed("MUTATE", f"{len(docs)} docs", op)

    def query(self, flt: dict, expand: str | None = None) -> list[dict]:
        def op():
            out = []
            for nid, attrs in self.engine.find_nodes(flt):
                attrs["uid"] = nid
                if expand:
                    attrs[expand] = [
                        dict(self.engine.get_node(t), uid=t)
                        for t in self.engine.out_neighbors(nid, expand)]
                out.append(attrs)
            return out
        return self._observed("QUERY", str(sorted(flt)), op)

    def alter(self, schema: str) -> None:
        self._observed("ALTER", schema[:40],
                       lambda: self.schema.append(schema))


class ArangoDB(_GraphStore):
    """ArangoDB-shaped surface (reference container/datasources.go:637-706):
    document collections + edge collections + graph traversal, all in
    one engine (documents are nodes tagged with their collection)."""

    metric = "app_arangodb_stats"
    log_tag = "ARANGO"
    backend_name = "arangodb"

    def create_document(self, collection: str, document: dict) -> str:
        return self._observed(
            "CREATE_DOC", collection,
            lambda: self.engine.put_node(
                None, dict(document, _collection=collection)))

    def get_document(self, collection: str, doc_id: str) -> dict:
        def op():
            doc = self.engine.get_node(doc_id)
            if doc.get("_collection") != collection:
                raise NodeNotFound(f"{collection}/{doc_id}")
            doc.pop("_collection", None)
            return doc
        return self._observed("GET_DOC", collection, op)

    def update_document(self, collection: str, doc_id: str,
                        changes: dict) -> None:
        def op():
            self.get_document(collection, doc_id)  # existence check
            self.engine.put_node(doc_id, changes)
        self._observed("UPDATE_DOC", collection, op)

    def delete_document(self, collection: str, doc_id: str) -> None:
        self._observed("DELETE_DOC", collection,
                       lambda: self.engine.delete_node(doc_id))

    def create_edge_document(self, edge_collection: str, from_id: str,
                             to_id: str) -> None:
        self._observed(
            "CREATE_EDGE", edge_collection,
            lambda: self.engine.add_edge(edge_collection, from_id, to_id))

    def query(self, collection: str, flt: dict | None = None) -> list[dict]:
        def op():
            out = []
            for nid, attrs in self.engine.find_nodes(
                    dict(flt or {}, _collection=collection)):
                attrs.pop("_collection", None)
                attrs["_id"] = nid
                out.append(attrs)
            return out
        return self._observed("QUERY", collection, op)

    def traversal(self, start_id: str, edge_collection: str,
                  depth: int = 1) -> list[dict]:
        def op():
            out = []
            for nid in self.engine.traverse(start_id, edge_collection, depth):
                doc = self.engine.get_node(nid)
                doc.pop("_collection", None)
                doc["_id"] = nid
                out.append(doc)
            return out
        return self._observed("TRAVERSAL", edge_collection, op)


class SurrealDB(_GraphStore):
    """SurrealDB-shaped surface (reference container/datasources.go:302-344):
    record ids ``table:id``, create/select/update/delete/query."""

    metric = "app_surrealdb_stats"
    log_tag = "SURREAL"
    backend_name = "surrealdb"

    @staticmethod
    def _split(thing: str) -> tuple[str, str | None]:
        table, _, rid = thing.partition(":")
        return table, (rid or None)

    def create(self, thing: str, data: dict) -> dict:
        table, rid = self._split(thing)
        def op():
            node_id = self.engine.put_node(
                f"{table}:{rid}" if rid else None,
                dict(data, _table=table))
            if not rid:  # engine-assigned: normalize to table:id form
                attrs = self.engine.get_node(node_id)
                self.engine.delete_node(node_id)
                node_id = f"{table}:{node_id.lstrip('0x')}"
                self.engine.put_node(node_id, attrs)
            doc = self.engine.get_node(node_id)
            doc.pop("_table", None)
            doc["id"] = node_id
            return doc
        return self._observed("CREATE", table, op)

    def select(self, thing: str) -> list[dict]:
        table, rid = self._split(thing)
        def op():
            if rid:
                doc = self.engine.get_node(thing)
                doc.pop("_table", None)
                doc["id"] = thing
                return [doc]
            out = []
            for nid, attrs in self.engine.find_nodes({"_table": table}):
                attrs.pop("_table", None)
                attrs["id"] = nid
                out.append(attrs)
            return out
        return self._observed("SELECT", table, op)

    def update(self, thing: str, data: dict) -> dict:
        table, rid = self._split(thing)
        if not rid:
            raise GraphError("update requires table:id")
        def op():
            self.engine.get_node(thing)  # existence check
            self.engine.put_node(thing, data)
            doc = self.engine.get_node(thing)
            doc.pop("_table", None)
            doc["id"] = thing
            return doc
        return self._observed("UPDATE", table, op)

    def delete(self, thing: str) -> None:
        table, rid = self._split(thing)
        def op():
            if rid:
                self.engine.delete_node(thing)
            else:
                for nid, _ in self.engine.find_nodes({"_table": table}):
                    self.engine.delete_node(nid)
        self._observed("DELETE", table, op)

    def query(self, table: str, flt: dict | None = None) -> list[dict]:
        def op():
            out = []
            for nid, attrs in self.engine.find_nodes(
                    dict(flt or {}, _table=table)):
                attrs.pop("_table", None)
                attrs["id"] = nid
                out.append(attrs)
            return out
        return self._observed("QUERY", table, op)
