"""Document-store family: Mongo-, Elasticsearch-, Solr- and
Couchbase-shaped stores over one embedded document engine.

The reference declares a canonical interface per store in
container/datasources.go (Mongo :232, Elasticsearch :708, Solr :386,
Couchbase :748) and ships driver-backed modules for each
(datasource/mongo, datasource/elasticsearch, ...). Here each store is a
thin protocol adapter over :class:`DocumentEngine` — an embedded,
thread-safe collection-of-dicts engine — so the full API surface is
real and testable without external servers; a production deployment
swaps the engine for a network client behind the same interface.

The port's copy of ``gofr_tpu/datasource/document.py``.
"""

from __future__ import annotations

import copy
import itertools
import threading
from typing import Any, Iterable

from . import Instrumented


class DocumentError(Exception):
    pass


class DocumentNotFound(DocumentError):
    pass


def _matches(doc: dict, flt: dict) -> bool:
    """Mongo-style filter: equality plus $gt/$gte/$lt/$lte/$ne/$in."""
    for key, cond in flt.items():
        value = doc.get(key)
        if isinstance(cond, dict):
            for op, operand in cond.items():
                if op == "$gt" and not (value is not None and value > operand):
                    return False
                elif op == "$gte" and not (value is not None and value >= operand):
                    return False
                elif op == "$lt" and not (value is not None and value < operand):
                    return False
                elif op == "$lte" and not (value is not None and value <= operand):
                    return False
                elif op == "$ne" and value == operand:
                    return False
                elif op == "$in" and value not in operand:
                    return False
        elif value != cond:
            return False
    return True


class DocumentEngine:
    """Embedded collections-of-dicts store with Mongo-style filters."""

    def __init__(self) -> None:
        self._collections: dict[str, dict[Any, dict]] = {}
        self._lock = threading.RLock()
        self._ids = itertools.count(1)

    def insert(self, collection: str, doc: dict, doc_id: Any = None) -> Any:
        with self._lock:
            coll = self._collections.setdefault(collection, {})
            if doc_id is None:
                doc_id = doc.get("_id")
            if doc_id is None:
                doc_id = next(self._ids)
            if doc_id in coll:
                raise DocumentError(f"duplicate id {doc_id!r} in {collection}")
            stored = copy.deepcopy(doc)
            stored["_id"] = doc_id
            coll[doc_id] = stored
            return doc_id

    def upsert(self, collection: str, doc_id: Any, doc: dict) -> None:
        with self._lock:
            coll = self._collections.setdefault(collection, {})
            stored = copy.deepcopy(doc)
            stored["_id"] = doc_id
            coll[doc_id] = stored

    def get(self, collection: str, doc_id: Any) -> dict:
        with self._lock:
            coll = self._collections.get(collection, {})
            if doc_id not in coll:
                raise DocumentNotFound(f"{collection}/{doc_id}")
            return copy.deepcopy(coll[doc_id])

    def find(self, collection: str, flt: dict | None = None,
             limit: int | None = None) -> list[dict]:
        with self._lock:
            docs = list(self._collections.get(collection, {}).values())
        out = [copy.deepcopy(d) for d in docs
               if flt is None or _matches(d, flt)]
        return out[:limit] if limit is not None else out

    def update(self, collection: str, flt: dict, changes: dict) -> int:
        with self._lock:
            coll = self._collections.get(collection, {})
            n = 0
            for doc in coll.values():
                if _matches(doc, flt):
                    doc.update(copy.deepcopy(changes))
                    n += 1
            return n

    def delete(self, collection: str, flt: dict) -> int:
        with self._lock:
            coll = self._collections.get(collection, {})
            victims = [k for k, d in coll.items() if _matches(d, flt)]
            for k in victims:
                del coll[k]
            return len(victims)

    def drop(self, collection: str) -> None:
        with self._lock:
            self._collections.pop(collection, None)

    def collections(self) -> list[str]:
        with self._lock:
            return sorted(self._collections)

    def count(self, collection: str) -> int:
        with self._lock:
            return len(self._collections.get(collection, {}))


class _DocumentStore(Instrumented):
    """Shared provider/health plumbing for the family."""

    backend_name = "document"

    def __init__(self, engine: DocumentEngine | None = None) -> None:
        self.engine = engine if engine is not None else DocumentEngine()
        self._connected = False

    def connect(self) -> None:
        self._connected = True
        if self.logger is not None:
            self.logger.debug(f"connected {self.backend_name} store")

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP",
                "details": {"backend": self.backend_name,
                            "collections": len(self.engine.collections())}}

    def close(self) -> None:
        self._connected = False


class Mongo(_DocumentStore):
    """Mongo-shaped API (reference container/datasources.go:232-300)."""

    metric = "app_mongo_stats"
    log_tag = "MONGO"
    backend_name = "mongo"

    def insert_one(self, collection: str, document: dict) -> Any:
        return self._observed("INSERT", collection,
                              lambda: self.engine.insert(collection, document))

    def insert_many(self, collection: str, documents: Iterable[dict]) -> list:
        docs = list(documents)
        return self._observed(
            "INSERT_MANY", collection,
            lambda: [self.engine.insert(collection, d) for d in docs])

    def find(self, collection: str, flt: dict | None = None,
             limit: int | None = None) -> list[dict]:
        return self._observed("FIND", collection,
                              lambda: self.engine.find(collection, flt, limit))

    def find_one(self, collection: str, flt: dict | None = None) -> dict | None:
        def op():
            hits = self.engine.find(collection, flt, limit=1)
            return hits[0] if hits else None
        return self._observed("FIND_ONE", collection, op)

    def update_many(self, collection: str, flt: dict, update: dict) -> int:
        changes = update.get("$set", update)
        return self._observed(
            "UPDATE", collection,
            lambda: self.engine.update(collection, flt, changes))

    update_one = update_many

    def delete_many(self, collection: str, flt: dict) -> int:
        return self._observed("DELETE", collection,
                              lambda: self.engine.delete(collection, flt))

    delete_one = delete_many

    def count_documents(self, collection: str, flt: dict | None = None) -> int:
        return len(self.find(collection, flt))

    def drop(self, collection: str) -> None:
        self._observed("DROP", collection,
                       lambda: self.engine.drop(collection))


def _tokenize(text: str) -> set[str]:
    return {t for t in "".join(c.lower() if c.isalnum() else " "
                               for c in text).split() if t}


class Elasticsearch(_DocumentStore):
    """Elasticsearch-shaped API (reference container/datasources.go:708-746):
    index/get/delete documents plus a match query with naive token
    scoring (hits sorted by overlap count)."""

    metric = "app_elasticsearch_stats"
    log_tag = "ES"
    backend_name = "elasticsearch"

    def index(self, index: str, doc_id: Any, document: dict) -> None:
        self._observed("INDEX", index,
                       lambda: self.engine.upsert(index, doc_id, document))

    def get(self, index: str, doc_id: Any) -> dict:
        return self._observed("GET", index,
                              lambda: self.engine.get(index, doc_id))

    def delete(self, index: str, doc_id: Any) -> None:
        self._observed("DELETE", index,
                       lambda: self.engine.delete(index, {"_id": doc_id}))

    def search(self, index: str, query: dict | None = None,
               size: int = 10) -> dict:
        """Supports {"match": {field: text}}, {"term": {field: v}}, and
        {"match_all": {}} queries; returns the ES hits envelope."""
        def op():
            docs = self.engine.find(index)
            if not query or "match_all" in query:
                scored = [(1.0, d) for d in docs]
            elif "term" in query:
                ((field, value),) = query["term"].items()
                scored = [(1.0, d) for d in docs if d.get(field) == value]
            elif "match" in query:
                ((field, text),) = query["match"].items()
                wanted = _tokenize(str(text))
                scored = []
                for d in docs:
                    overlap = len(wanted & _tokenize(str(d.get(field, ""))))
                    if overlap:
                        scored.append((float(overlap), d))
                scored.sort(key=lambda p: -p[0])
            else:
                raise DocumentError(f"unsupported query: {sorted(query)}")
            hits = [{"_index": index, "_id": d["_id"], "_score": s,
                     "_source": {k: v for k, v in d.items() if k != "_id"}}
                    for s, d in scored[:size]]
            return {"hits": {"total": {"value": len(scored)}, "hits": hits}}
        return self._observed("SEARCH", index, op)

    def bulk(self, index: str, documents: Iterable[tuple[Any, dict]]) -> int:
        docs = list(documents)
        def op():
            for doc_id, doc in docs:
                self.engine.upsert(index, doc_id, doc)
            return len(docs)
        return self._observed("BULK", index, op)


class Solr(_DocumentStore):
    """Solr-shaped API (reference container/datasources.go:386-406):
    add/search/delete against named cores."""

    metric = "app_solr_stats"
    log_tag = "SOLR"
    backend_name = "solr"

    def add(self, core: str, documents: Iterable[dict]) -> int:
        docs = list(documents)
        def op():
            for d in docs:
                self.engine.upsert(core, d.get("id", d.get("_id")), d)
            return len(docs)
        return self._observed("ADD", core, op)

    def search(self, core: str, query: str, rows: int = 10) -> dict:
        """`field:value` or bare-text query over all fields."""
        def op():
            docs = self.engine.find(core)
            if query in ("*", "*:*"):
                hits = docs
            elif ":" in query:
                field, value = query.split(":", 1)
                hits = [d for d in docs if str(d.get(field)) == value]
            else:
                wanted = _tokenize(query)
                hits = [d for d in docs
                        if wanted & _tokenize(" ".join(map(str, d.values())))]
            return {"response": {"numFound": len(hits),
                                 "docs": hits[:rows]}}
        return self._observed("SEARCH", core, op)

    def delete(self, core: str, doc_id: Any) -> None:
        self._observed("DELETE", core,
                       lambda: self.engine.delete(core, {"_id": doc_id}))


class Couchbase(_DocumentStore):
    """Couchbase-shaped API (reference container/datasources.go:748-788):
    bucket get/upsert/remove plus N1QL-lite query over a bucket."""

    metric = "app_couchbase_stats"
    log_tag = "CB"
    backend_name = "couchbase"

    def get(self, bucket: str, key: str) -> dict:
        return self._observed("GET", bucket,
                              lambda: self.engine.get(bucket, key))

    def upsert(self, bucket: str, key: str, document: dict) -> None:
        self._observed("UPSERT", bucket,
                       lambda: self.engine.upsert(bucket, key, document))

    def insert(self, bucket: str, key: str, document: dict) -> None:
        self._observed(
            "INSERT", bucket,
            lambda: self.engine.insert(bucket, document, doc_id=key))

    def remove(self, bucket: str, key: str) -> None:
        def op():
            if not self.engine.delete(bucket, {"_id": key}):
                raise DocumentNotFound(f"{bucket}/{key}")
        self._observed("REMOVE", bucket, op)

    def query(self, bucket: str, flt: dict | None = None) -> list[dict]:
        return self._observed("QUERY", bucket,
                              lambda: self.engine.find(bucket, flt))
