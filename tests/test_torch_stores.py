"""The port's breadth stores in process (``datasource/document.py``,
``columnar.py``, ``graph.py``, ``timeseries.py``, ``object_store.py``)
against the JAX package's: every case of ``tests/test_datasource_breadth.py``
that needs no mock container, the cases of ``tests/test_migrations_stores.py``
and the object-store cases of ``tests/test_remote_file_stores.py`` run on
both packages (``side``), with the same calls, results and typed errors;
then seeded sessions of random operations on each family give the same
outcomes on both.
"""

import numpy as np
import pytest

from .torch_wire import Side as _Side

SIDES = ["port", "jax"]
#: the modules a side's names resolve from, in order
_MODULES = ("datasource.document", "datasource.columnar", "datasource.graph",
            "datasource.timeseries", "datasource.object_store",
            "datasource.file_store", "migrations", "container.container",
            "config.env", "datasource.sql", "pubsub.inmemory", "context")


def Side(side: str) -> _Side:
    return _Side(side, _MODULES)


@pytest.fixture(params=SIDES)
def S(request):
    return Side(request.param)


# ---------------------------------------------------------------- document
class TestMongo:
    def test_crud_roundtrip(self, S):
        m = S.Mongo()
        m.connect()
        m.insert_one("users", {"name": "ada", "age": 36})
        m.insert_one("users", {"name": "grace", "age": 45})
        assert m.count_documents("users") == 2
        hits = m.find("users", {"age": {"$gt": 40}})
        assert [h["name"] for h in hits] == ["grace"]
        assert m.find_one("users", {"name": "ada"})["age"] == 36
        assert m.update_many("users", {"name": "ada"},
                             {"$set": {"age": 37}}) == 1
        assert m.find_one("users", {"name": "ada"})["age"] == 37
        assert m.delete_many("users", {"age": {"$lt": 40}}) == 1
        assert m.count_documents("users") == 1

    def test_filter_operators(self, S):
        m = S.Mongo()
        m.insert_many("n", [{"v": i} for i in range(5)])
        assert len(m.find("n", {"v": {"$gte": 2, "$lte": 3}})) == 2
        assert len(m.find("n", {"v": {"$ne": 0}})) == 4
        assert len(m.find("n", {"v": {"$in": [1, 4, 9]}})) == 2


class TestElasticsearch:
    def test_index_search_ranking(self, S):
        es = S.Elasticsearch()
        es.index("docs", 1, {"title": "tpu systolic matmul"})
        es.index("docs", 2, {"title": "hbm bandwidth tpu"})
        es.index("docs", 3, {"title": "unrelated prose"})
        out = es.search("docs", {"match": {"title": "tpu matmul"}})
        assert out["hits"]["total"]["value"] == 2
        assert out["hits"]["hits"][0]["_id"] == 1  # 2-token overlap first

    def test_term_get_delete_bulk(self, S):
        es = S.Elasticsearch()
        assert es.bulk("i", [(n, {"k": n % 2}) for n in range(4)]) == 4
        assert es.search("i", {"term": {"k": 0}})["hits"]["total"][
            "value"] == 2
        assert es.get("i", 3)["k"] == 1
        es.delete("i", 3)
        with pytest.raises(S.DocumentNotFound):
            es.get("i", 3)


class TestSolrCouchbase:
    def test_solr_add_search(self, S):
        s = S.Solr()
        s.add("books", [{"id": "b1", "title": "jax on tpu"},
                        {"id": "b2", "title": "go services"}])
        assert s.search("books", "title:jax on tpu")["response"][
            "numFound"] == 1
        assert s.search("books", "*:*")["response"]["numFound"] == 2
        s.delete("books", "b1")
        assert s.search("books", "*:*")["response"]["numFound"] == 1

    def test_couchbase_bucket_ops(self, S):
        cb = S.Couchbase()
        cb.upsert("main", "u:1", {"name": "ada"})
        cb.insert("main", "u:2", {"name": "grace"})
        assert cb.get("main", "u:1")["name"] == "ada"
        assert len(cb.query("main")) == 2
        cb.remove("main", "u:1")
        with pytest.raises(S.DocumentNotFound):
            cb.remove("main", "u:1")


# ---------------------------------------------------------------- columnar
@pytest.mark.parametrize("cls", ["Cassandra", "ScyllaDB", "Clickhouse",
                                 "Oracle"])
def test_cql_family_statements(S, cls):
    store = getattr(S, cls)()
    store.connect()
    store.exec("CREATE TABLE t (id INTEGER PRIMARY KEY, name TEXT)")
    store.exec("INSERT INTO t (id, name) VALUES (?, ?)", 1, "ada")
    store.exec("INSERT INTO t (id, name) VALUES (?, ?)", 2, "grace")
    rows = store.query("SELECT * FROM t ORDER BY id")
    assert [r["name"] for r in rows] == ["ada", "grace"]
    assert store.health_check()["status"] == "UP"
    store.close()
    assert store.health_check()["status"] == "DOWN"


def test_cassandra_batch_atomicity(S):
    c = S.Cassandra()
    c.connect()
    c.exec("CREATE TABLE t (id INTEGER PRIMARY KEY)")
    c.new_batch("b1")
    c.batch_query("b1", "INSERT INTO t (id) VALUES (?)", 1)
    c.batch_query("b1", "INSERT INTO t (id) VALUES (?)", 2)
    c.execute_batch("b1")
    assert len(c.query("SELECT * FROM t")) == 2
    # failing batch rolls back entirely
    c.new_batch("b2")
    c.batch_query("b2", "INSERT INTO t (id) VALUES (?)", 3)
    c.batch_query("b2", "INSERT INTO t (id) VALUES (?)", 1)  # dup PK
    with pytest.raises(Exception):
        c.execute_batch("b2")
    assert len(c.query("SELECT * FROM t")) == 2
    with pytest.raises(S.BatchNotInitialised):
        c.batch_query("nope", "SELECT 1")


def test_cql_strips_cql_only_clauses(S):
    c = S.ScyllaDB()
    c.connect()
    c.exec("CREATE TABLE t (id INTEGER)")
    c.exec("INSERT INTO t (id) VALUES (?) USING TTL 60", 1)
    assert c.query("SELECT * FROM t ALLOW FILTERING") == [{"id": 1}]


def test_oracle_tx_commit_rollback(S):
    o = S.Oracle()
    o.connect()
    o.exec("CREATE TABLE m (v INTEGER)")
    tx = o.begin()
    tx.exec("INSERT INTO m (v) VALUES (?)", 1)
    tx.rollback()
    assert o.select("SELECT * FROM m") == []
    tx = o.begin()
    tx.exec("INSERT INTO m (v) VALUES (?)", 2)
    tx.commit()
    assert o.select("SELECT * FROM m") == [{"v": 2}]


# ------------------------------------------------------------------- graph
class TestDgraph:
    def test_mutate_query_expand(self, S):
        d = S.Dgraph()
        d.connect()
        uids = d.mutate({"uid": "_:ada", "name": "ada",
                         "follows": [{"name": "grace"}, {"name": "alan"}]})
        assert "ada" in uids
        hits = d.query({"name": "ada"}, expand="follows")
        assert len(hits) == 1
        assert {f["name"] for f in hits[0]["follows"]} == {"grace", "alan"}
        d.alter("name: string @index(term) .")
        assert d.schema

    def test_edge_to_missing_node(self, S):
        d = S.Dgraph()
        with pytest.raises(S.NodeNotFound):
            d.engine.add_edge("knows", "0xdead", "0xbeef")


class TestArango:
    def test_documents_and_traversal(self, S):
        a = S.ArangoDB()
        a.connect()
        i1 = a.create_document("people", {"name": "ada"})
        i2 = a.create_document("people", {"name": "grace"})
        i3 = a.create_document("people", {"name": "alan"})
        a.create_edge_document("knows", i1, i2)
        a.create_edge_document("knows", i2, i3)
        assert a.get_document("people", i1)["name"] == "ada"
        a.update_document("people", i1, {"name": "ada lovelace"})
        two_hops = a.traversal(i1, "knows", depth=2)
        assert [d["name"] for d in two_hops] == ["grace", "alan"]
        a.delete_document("people", i3)
        assert len(a.query("people")) == 2


class TestSurreal:
    def test_record_id_crud(self, S):
        s = S.SurrealDB()
        s.connect()
        created = s.create("user:ada", {"age": 36})
        assert created["id"] == "user:ada"
        s.create("user", {"age": 45})  # engine-assigned id
        assert len(s.select("user")) == 2
        assert s.select("user:ada")[0]["age"] == 36
        assert s.update("user:ada", {"age": 37})["age"] == 37
        with pytest.raises(S.GraphError):
            s.update("user", {})
        s.delete("user:ada")
        assert len(s.query("user")) == 1


# ------------------------------------------------------------- time-series
class TestOpenTSDB:
    def test_put_query_aggregate(self, S):
        t = S.OpenTSDB()
        t.connect()
        t.put_data_points([
            {"metric": "sys.cpu", "timestamp": 100, "value": 10,
             "tags": {"host": "a"}},
            {"metric": "sys.cpu", "timestamp": 200, "value": 30,
             "tags": {"host": "a"}},
            {"metric": "sys.cpu", "timestamp": 300, "value": 50,
             "tags": {"host": "b"}},
        ])
        assert t.query("sys.cpu", "avg", start=100, end=250)["value"] == 20
        assert t.query("sys.cpu", "max")["value"] == 50
        assert t.query("sys.cpu", "sum", tags={"host": "a"})["value"] == 40
        with pytest.raises(S.TimeseriesError):
            t.engine.aggregate("sys.cpu", "median")

    def test_annotations(self, S):
        t = S.OpenTSDB()
        t.put_annotation({"startTime": 150, "description": "deploy"})
        assert t.query_annotations(100, 200)[0]["description"] == "deploy"
        assert t.query_annotations(300, 400) == []


class TestInfluxDB:
    def test_buckets_and_points(self, S):
        i = S.InfluxDB()
        i.connect()
        i.create_bucket("metrics")
        i.write_point("metrics", "temp", 1.0, {"c": 21.0}, {"room": "lab"})
        i.write_point("metrics", "temp", 2.0, {"c": 23.0}, {"room": "lab"})
        assert i.query("metrics", "temp", "c") == [(1.0, 21.0), (2.0, 23.0)]
        assert i.aggregate("metrics", "temp", "c", "avg") == 22.0
        assert i.health_check()["details"]["buckets"] == 1
        i.delete_bucket("metrics")
        assert i.list_buckets() == []


# ----------------------------------------------- container + context wiring
_BREADTH = {"mongo": "Mongo", "elasticsearch": "Elasticsearch",
            "solr": "Solr", "couchbase": "Couchbase",
            "cassandra": "Cassandra", "scylladb": "ScyllaDB",
            "clickhouse": "Clickhouse", "oracle": "Oracle",
            "dgraph": "Dgraph", "arangodb": "ArangoDB",
            "surrealdb": "SurrealDB", "opentsdb": "OpenTSDB",
            "influxdb": "InfluxDB"}


def test_container_holds_every_breadth_slot(S):
    c = S.Container()
    stores = {name: getattr(S, cls)() for name, cls in _BREADTH.items()}
    for name, store in stores.items():
        added = getattr(c, f"add_{name}")(store)
        assert added is store
        assert store.logger is c.logger  # provider wiring ran
    checks = c.health()["checks"]
    for name in stores:
        assert checks[name]["status"] == "UP", name


def test_context_resolves_breadth_slots(S):
    """The breadth case of ``test_context_resolves_breadth_slots`` on a
    plain container (JAX's takes the mock container, which the port does
    not have yet)."""
    c = S.Container()
    c.add_dgraph(S.Dgraph())
    ctx = S.Context(request=None, container=c)
    assert ctx.dgraph is c.dgraph
    with pytest.raises(AttributeError):
        ctx.no_such_store


# --------------------------------------------------------------- migrations
LEDGER_Q = "SELECT version FROM gofr_migrations"


def _container(S, **stores):
    c = S.Container(config=S.DictConfig({}))
    for slot, store in stores.items():
        store.connect()
        setattr(c, slot, store)
    return c


class TestStoreMigrations:
    def test_cassandra_ledger_and_order(self, S):
        c = _container(S, cassandra=S.Cassandra())
        applied = S.run(c, {
            2: S.Migrate(up=lambda ds: ds.cassandra.exec(
                "INSERT INTO spans (id) VALUES (1)")),
            1: S.Migrate(up=lambda ds: ds.cassandra.exec(
                "CREATE TABLE spans (id BIGINT PRIMARY KEY)")),
        })
        assert applied == [1, 2]
        assert sorted(r["version"] for r in
                      c.cassandra.query(LEDGER_Q)) == [1, 2]
        assert len(c.cassandra.query("SELECT * FROM spans")) == 1

    def test_cassandra_rerun_is_idempotent(self, S):
        c = _container(S, cassandra=S.Cassandra())
        migrations = {1: S.Migrate(up=lambda ds: ds.cassandra.exec(
            "CREATE TABLE t1 (id BIGINT PRIMARY KEY)"))}
        assert S.run(c, migrations) == [1]
        assert S.run(c, migrations) == []

    def test_scylla_uses_same_cql_ledger(self, S):
        c = _container(S, scylladb=S.ScyllaDB())
        assert S.run(c, {1: S.Migrate(up=lambda ds: ds.scylladb.exec(
            "CREATE TABLE s1 (id BIGINT PRIMARY KEY)"))}) == [1]
        assert [r["version"] for r in c.scylladb.query(LEDGER_Q)] == [1]

    def test_clickhouse_ledger_and_data(self, S):
        c = _container(S, clickhouse=S.Clickhouse())
        applied = S.run(c, {
            1: S.Migrate(up=lambda ds: ds.clickhouse.exec(
                "CREATE TABLE events (ts BIGINT, kind TEXT)")),
            2: S.Migrate(up=lambda ds: ds.clickhouse.exec(
                "INSERT INTO events (ts, kind) VALUES (1, 'boot')")),
        })
        assert applied == [1, 2]
        assert sorted(r["version"] for r in
                      c.clickhouse.query(LEDGER_Q)) == [1, 2]
        assert c.clickhouse.query("SELECT kind FROM events")[0]["kind"] \
            == "boot"

    def test_clickhouse_rerun_is_idempotent(self, S):
        c = _container(S, clickhouse=S.Clickhouse())
        migrations = {7: S.Migrate(up=lambda ds: ds.clickhouse.exec(
            "CREATE TABLE e2 (id BIGINT)"))}
        assert S.run(c, migrations) == [7]
        assert S.run(c, migrations) == []

    def test_oracle_ledger_and_data(self, S):
        c = _container(S, oracle=S.Oracle())
        assert S.run(c, {1: S.Migrate(up=lambda ds: ds.oracle.exec(
            "CREATE TABLE accounts (id BIGINT PRIMARY KEY, "
            "balance BIGINT)"))}) == [1]
        assert [r["version"] for r in c.oracle.query(LEDGER_Q)] == [1]
        assert S.run(c, {1: S.Migrate(up=lambda ds: None)}) == []

    def test_mongo_document_ledger(self, S):
        wire = S.module("datasource.mongo_wire")
        server = wire.MiniMongoServer()
        server.start()
        mongo = wire.MongoWire(host="127.0.0.1", port=server.port,
                               database="t")
        mongo.connect()
        try:
            c = S.Container(config=S.DictConfig({}))
            c.mongo = mongo
            assert S.run(c, {
                1: S.Migrate(up=lambda ds: ds.mongo.insert_one(
                    "users", {"name": "ada"})),
                2: S.Migrate(up=lambda ds: ds.mongo.insert_one(
                    "users", {"name": "lin"})),
            }) == [1, 2]
            assert sorted(d["version"] for d in
                          mongo.find("gofr_migrations")) == [1, 2]
            assert S.run(c, {2: S.Migrate(up=lambda ds: None)}) == []
            assert len(mongo.find("users")) == 2
        finally:
            mongo.close()
            server.close()

    def test_shared_last_version_across_stores(self, S):
        sql = S.SQL()
        sql.connect()
        c = _container(S, cassandra=S.Cassandra())
        c.sql = sql
        assert S.run(c, {1: S.Migrate(up=lambda ds: ds.cassandra.exec(
            "CREATE TABLE x1 (id BIGINT PRIMARY KEY)"))}) == [1]
        assert [r["version"] for r in c.cassandra.query(LEDGER_Q)] == [1]
        assert [r["version"] for r in sql.query(LEDGER_Q)] == [1]
        assert S.run(c, {1: S.Migrate(up=lambda ds: None)}) == []

    def test_pubsub_topic_create_with_cassandra_ledger(self, S):
        c = _container(S, cassandra=S.Cassandra())
        c.pubsub = S.InMemoryBroker()
        assert S.run(c, {1: S.Migrate(
            up=lambda ds: ds.pubsub.create_topic("orders"))}) == [1]
        assert "orders" in c.pubsub.topics
        assert S.run(c, {1: S.Migrate(up=lambda ds: None)}) == []

    def test_statement_store_failure_keeps_ledger_clean(self, S):
        c = _container(S, cassandra=S.Cassandra())

        def boom(ds):
            raise RuntimeError("mid-migration crash")

        with pytest.raises(RuntimeError):
            S.run(c, {1: S.Migrate(up=boom)})
        assert c.cassandra.query(LEDGER_Q) == []
        assert S.run(c, {1: S.Migrate(up=lambda ds: ds.cassandra.exec(
            "CREATE TABLE ok (id BIGINT PRIMARY KEY)"))}) == [1]


# ------------------------------------------------------------ object family
@pytest.mark.parametrize("cls", ["S3FileSystem", "GCSFileSystem",
                                 "AzureBlobFileSystem"])
class TestObjectFileSystemSurface:
    def test_filesystem_roundtrip(self, S, cls):
        fs = getattr(S, cls)("models")
        fs.connect()
        fs.create("weights/llama/params.npz", b"\x00\x01")
        assert fs.read("weights/llama/params.npz") == b"\x00\x01"
        fs.append("logs/run.txt", "a")
        fs.append("logs/run.txt", "b")
        assert fs.read_text("logs/run.txt") == "ab"
        assert fs.exists("logs/run.txt")
        info = fs.stat("logs/run.txt")
        assert (info.name, info.size, info.is_dir) == ("run.txt", 2, False)
        fs.rename("logs/run.txt", "logs/run2.txt")
        assert not fs.exists("logs/run.txt")
        fs.remove("logs/run2.txt")
        with pytest.raises(S.ObjectNotFound):
            fs.read("logs/run2.txt")

    def test_read_dir_emulates_one_level(self, S, cls):
        fs = getattr(S, cls)("b")
        fs.create("a.txt", b"1")
        fs.create("sub/b.txt", b"2")
        fs.create("sub/deep/c.txt", b"3")
        assert {e.name: e.is_dir for e in fs.read_dir()} == \
            {"a.txt": False, "sub": True}
        assert {e.name: e.is_dir for e in fs.read_dir("sub")} == \
            {"b.txt": False, "deep": True}

    def test_rows_and_glob_and_health(self, S, cls):
        fs = getattr(S, cls)("data")
        fs.create("t.csv", "x,y\n1,2\n3,4\n")
        assert list(fs.read_rows("t.csv"))[0]["x"] == "1"
        fs.create("a/1.json", b"[]")
        assert fs.glob("a/*.json") == ["a/1.json"]
        assert fs.health_check()["status"] == "UP"


def test_s3_native_verbs(S):
    s3 = S.S3FileSystem("bkt")
    s3.put_object("k1", b"v1")
    s3.put_object("k2", b"v2")
    assert s3.get_object("k1") == b"v1"
    assert [o["Key"] for o in s3.list_objects("k")] == ["k1", "k2"]
    s3.delete_object("k1")
    assert [o["Key"] for o in s3.list_objects()] == ["k2"]


def test_gcs_and_azure_native_verbs(S):
    gcs = S.GCSFileSystem("bkt")
    gcs.upload("blob1", b"x")
    assert gcs.download("blob1") == b"x"
    assert gcs.list_blobs() == ["blob1"]
    az = S.AzureBlobFileSystem("container")
    az.upload_blob("b1", b"y")
    with pytest.raises(S.FileError):
        az.upload_blob("b1", b"z", overwrite=False)
    assert az.download_blob("b1") == b"y"
    az.delete_blob("b1")
    assert az.list_blob_names() == []


def test_container_add_file_store_accepts_object_store(S):
    c = S.Container()
    fs = c.add_file_store(S.S3FileSystem("app-bucket"))
    assert fs.logger is c.logger
    assert c.health()["checks"]["file"]["status"] == "UP"


# --------------------------------------------------- seeded random sessions
def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        return ("error", type(exc).__name__, str(exc))


def _document_session(S, seed: int) -> list:
    """Random inserts, filters ($gt/$gte/$lt/$lte/$ne/$in, equality on
    nested values), updates, deletes and counts on one Mongo store, and
    match / term searches on an Elasticsearch store."""
    rng = np.random.default_rng(seed)
    m, es = S.Mongo(), S.Elasticsearch()
    words = ["cache", "page", "token", "slot", "walk", "prefix"]
    out = []
    for i in range(40):
        doc = {"_id": f"d{i}", "v": int(rng.integers(0, 10)),
               "w": str(rng.choice(words)),
               "n": {"k": int(rng.integers(0, 3))}}
        out.append(_outcome(lambda doc=doc: m.insert_one("c", doc)))
        es.index("i", f"d{i}", {"body": " ".join(rng.choice(words, 3))})
    out.append(_outcome(lambda: m.insert_one("c", {"_id": "d7"})))
    ops = ["$gt", "$gte", "$lt", "$lte", "$ne"]
    for _ in range(30):
        op, x = str(rng.choice(ops)), int(rng.integers(0, 10))
        out.append(_outcome(lambda: [d["_id"] for d in
                                     m.find("c", {"v": {op: x}})]))
        pick = [int(v) for v in rng.integers(0, 10, 3)]
        out.append(_outcome(lambda: m.count_documents(
            "c", {"v": {"$in": pick}, "n": {"k": 1}})))
        out.append(_outcome(lambda: m.update_many(
            "c", {"w": str(rng.choice(words))},
            {"$set": {"v": int(rng.integers(0, 10))}})))
        query = " ".join(rng.choice(words, 2))
        out.append(_outcome(lambda: [(h["_id"], h["_score"]) for h in
                                     es.search("i", {"match": {
                                         "body": query}})["hits"]["hits"]]))
    out.append(_outcome(lambda: m.delete_many("c", {"v": {"$lt": 5}})))
    out.append(_outcome(lambda: sorted(d["_id"] for d in m.find("c"))))
    return out


def _columnar_session(S, seed: int) -> list:
    """Random inserts (NULLs among them), selects, batches (some failing
    on a duplicate key) on Cassandra and ClickHouse stores."""
    rng = np.random.default_rng(seed)
    out = []
    for cls in ("Cassandra", "Clickhouse"):
        db = getattr(S, cls)()
        db.connect()
        db.exec("CREATE TABLE t (id INTEGER PRIMARY KEY, s TEXT, x REAL)")
        for i in range(30):
            s = None if rng.random() < 0.2 else str(rng.integers(0, 99))
            out.append(_outcome(lambda i=i, s=s: db.exec(
                "INSERT INTO t (id, s, x) VALUES (?, ?, ?)", i, s,
                float(rng.integers(-50, 50)) / 4)))
        for _ in range(10):
            lo = int(rng.integers(0, 30))
            out.append(_outcome(lambda: db.query(
                "SELECT id, s, x FROM t WHERE id >= ? ORDER BY id", lo)))
        if cls == "Cassandra":
            for b in range(5):
                db.new_batch(f"b{b}")
                for _ in range(3):
                    db.batch_query(f"b{b}", "INSERT INTO t (id) VALUES (?)",
                                   int(rng.integers(25, 40)))
                out.append(_outcome(lambda b=b: db.execute_batch(f"b{b}")))
        out.append(_outcome(lambda: db.query("SELECT COUNT(*) AS n FROM t")))
        out.append(_outcome(lambda: db.query("SELECT * FROM missing")))
    return out


def _graph_session(S, seed: int) -> list:
    """Random nodes and edges through Dgraph, ArangoDB and SurrealDB:
    mutations, queries with expansion, traversals, record CRUD."""
    rng = np.random.default_rng(seed)
    out = []
    d, a, s = S.Dgraph(), S.ArangoDB(), S.SurrealDB()
    for i in range(12):
        out.append(_outcome(lambda i=i: d.mutate({
            "uid": f"_:n{i}", "name": f"n{i}",
            "rank": int(rng.integers(0, 4)),
            "knows": [{"name": f"m{i}"}]})))
    for _ in range(6):
        r = int(rng.integers(0, 4))
        out.append(_outcome(lambda: sorted(h["name"] for h in d.query(
            {"rank": r}, expand="knows"))))
    keys = [a.create_document("v", {"label": f"v{i}"}) for i in range(10)]
    for _ in range(15):
        i, j = (int(x) for x in rng.integers(0, 10, 2))
        a.create_edge_document("e", keys[i], keys[j])
    for _ in range(6):
        start, depth = int(rng.integers(0, 10)), int(rng.integers(1, 4))
        out.append(_outcome(lambda: [x["label"] for x in a.traversal(
            keys[start], "e", depth=depth)]))
    for i in range(8):
        out.append(_outcome(lambda i=i: s.create(
            f"t:{i}", {"g": int(rng.integers(0, 3))})))
    out.append(_outcome(lambda: sorted(r["id"] for r in s.query(
        "t", {"g": 1}))))
    out.append(_outcome(lambda: s.update("t", {})))
    out.append(_outcome(lambda: a.get_document("v", "missing")))
    return out


def _series_session(S, seed: int) -> list:
    """Random points through OpenTSDB and InfluxDB stores, then every
    aggregate over random ranges and tags."""
    rng = np.random.default_rng(seed)
    t, i = S.OpenTSDB(), S.InfluxDB()
    i.create_bucket("b")
    points = [{"metric": "m", "timestamp": int(ts),
               "value": float(rng.integers(0, 100)),
               "tags": {"h": str(rng.choice(["a", "b"]))}}
              for ts in rng.choice(1000, 40, replace=False)]
    t.put_data_points(points)
    for p in points:
        i.write_point("b", "m", float(p["timestamp"]), {"v": p["value"]},
                      p["tags"])
    out = []
    for _ in range(20):
        agg = str(rng.choice(["sum", "avg", "max", "min", "count"]))
        lo = int(rng.integers(0, 500))
        tag = str(rng.choice(["a", "b"]))
        out.append(_outcome(lambda: t.query("m", agg, start=lo,
                                            tags={"h": tag})))
        out.append(_outcome(lambda: i.aggregate("b", "m", "v", agg,
                                                start=float(lo))))
        out.append(_outcome(lambda: i.query("b", "m", "v", start=float(lo),
                                            tags={"h": tag})))
    out.append(_outcome(lambda: t.query("m", "median")))
    return out


def _object_session(S, seed: int) -> list:
    """Random creates, appends, renames, removes and listings through the
    three object file systems."""
    rng = np.random.default_rng(seed)
    out = []
    for cls in ("S3FileSystem", "GCSFileSystem", "AzureBlobFileSystem"):
        fs = getattr(S, cls)("b")
        names = [f"{d}/{n}.txt" for d in ("a", "b", "a/c") for n in "xyz"]
        for _ in range(30):
            name, op = str(rng.choice(names)), int(rng.integers(0, 5))
            blob = bytes(rng.integers(0, 256, int(rng.integers(0, 8)),
                                      dtype=np.uint8))
            if op == 0:
                out.append(_outcome(lambda: fs.create(name, blob)))
            elif op == 1:
                out.append(_outcome(lambda: fs.append(name, blob)))
            elif op == 2:
                out.append(_outcome(lambda: fs.read(name)))
            elif op == 3:
                out.append(_outcome(lambda: fs.remove(name)))
            else:
                out.append(_outcome(lambda: fs.rename(
                    name, str(rng.choice(names)))))
        out.append(_outcome(lambda: [(e.name, e.size, e.is_dir)
                                     for e in fs.read_dir("a")]))
        out.append(_outcome(lambda: fs.glob("a/*.txt")))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", [_document_session, _columnar_session,
                                    _graph_session, _series_session,
                                    _object_session],
                         ids=["document", "columnar", "graph", "series",
                              "object"])
def test_random_session_matches_jax(family, seed):
    """A seeded session of random operations on each family gives the
    same results and typed errors on the port's stores as on JAX's."""
    got = family(Side("port"), seed)
    want = family(Side("jax"), seed)
    assert got == want
    assert any(step[0] == "error" for step in want)
