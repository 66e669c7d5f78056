"""The port's wire clients and Mini servers of the breadth stores
(``datasource/mongo_wire.py``, ``cassandra_wire.py``, ``clickhouse_wire.py``,
``es_wire.py``, ``solr_wire.py``, ``couchbase_wire.py``, ``s3_wire.py``,
``dynamo_wire.py``, ``gcs_wire.py``, ``azure_blob_wire.py``,
``influx_wire.py``, ``opentsdb_wire.py``, ``dgraph_wire.py``,
``arango_wire.py``, ``surreal_wire.py``) against the JAX package's: every
case of the JAX tests of each module runs three ways, the port's client on
the port's server, the port's client on JAX's server and JAX's client on
the port's server (``torch_wire.PAIRS``), with real protocol bytes over
loopback sockets; a codec's output is decoded by the other side's decoder.
Then, in both cross directions: one scripted session per protocol gives
the same documents, rows, hits, points and objects, with the same typed
errors, as JAX's client on JAX's server; the binary protocols survive a
proxy that forwards one byte at a time; hostile strings round-trip; each
client records its ``app_<store>_stats`` histogram; migrations run over
the Cassandra, ClickHouse and Mongo wires; and 32 plain handlers of the
port's app hit ``ctx.mongo`` and ``ctx.cassandra`` over the wire at once,
answering as the in-process stores do.
"""

import base64
import datetime
import urllib.error

import pytest

from .torch_wire import (PAIR_IDS, PAIRS, Pair, server_connections, started,
                         wait_until)

AZ_KEY = base64.b64encode(b"super-secret-account-key").decode()


def _plain(value):
    """``value`` with every ObjectId (either package's) as ``("oid",
    raw)``, so the two packages' decodings compare."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_plain(v) for v in value]
    if type(value).__name__ == "ObjectId":
        return ("oid", value.raw)
    return value


# ------------------------------------------------------------------ Mongo
class TestMongo:
    """``mongo_wire``: BSON, OP_MSG, ``MongoWire`` on ``MiniMongoServer``."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("mongo", request.param)

    @pytest.fixture()
    def server(self, m):
        srv = m.MiniMongoServer()
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def client(self, m, server):
        c = m.MongoWire(host="127.0.0.1", port=server.port,
                        database="testdb")
        c.connect()
        yield c
        c.close()

    def test_bson_roundtrip_all_types(self, m):
        doc = {
            "str": "héllo", "int32": 42, "int64": 1 << 40, "neg": -7,
            "float": 3.5, "bool_t": True, "bool_f": False, "null": None,
            "binary": b"\x00\x01\xff", "oid": m.ObjectId(),
            "when": datetime.datetime(2026, 7, 30, 12, 0,
                                      tzinfo=datetime.timezone.utc),
            "nested": {"a": [1, "two", {"three": 3}]},
        }
        raw = m.encode_bson(doc)
        got, pos = m.srv("decode_bson")(raw)
        assert pos == len(raw)
        assert _plain(got) == _plain(doc)
        assert m.srv("encode_bson")(got) == raw

    def test_object_ids_unique_and_stable(self, m):
        a, b = m.ObjectId(), m.ObjectId()
        assert a != b
        assert len(a.raw) == 12
        assert m.ObjectId(a.raw) == a
        assert str(a) == a.raw.hex()
        assert str(m.srv("ObjectId")(a.raw)) == str(a)

    def test_op_msg_roundtrip(self, m):
        frame = m.encode_op_msg(7, {"ping": 1, "$db": "x"})
        request_id, response_to, body = m.srv("decode_op_msg")(frame)
        assert request_id == 7 and response_to == 0
        assert body == {"ping": 1, "$db": "x"}
        assert m.srv("encode_op_msg")(7, body) == frame

    def test_insert_find_roundtrip(self, m, client):
        oid = client.insert_one("users", {"name": "ada", "age": 36})
        assert isinstance(oid, m.ObjectId)
        rows = client.find("users", {"name": "ada"})
        assert len(rows) == 1
        assert rows[0]["age"] == 36
        assert rows[0]["_id"] == oid
        assert client.find_one("users", {"name": "nobody"}) is None

    def test_filters_update_delete_count(self, m, client):
        client.insert_many("n", [{"v": i} for i in range(10)])
        assert client.count_documents("n") == 10
        assert len(client.find("n", {"v": {"$gte": 5}})) == 5
        assert client.update_many("n", {"v": {"$lt": 3}},
                                  {"flag": True}) == 3
        assert client.count_documents("n", {"flag": True}) == 3
        assert client.delete_many("n", {"v": {"$gte": 8}}) == 2
        assert client.count_documents("n") == 8
        client.drop("n")
        assert client.count_documents("n") == 0

    def test_find_by_object_id(self, m, client):
        oid = client.insert_one("docs", {"body": "x"})
        got = client.find_one("docs", {"_id": oid})
        assert got is not None and got["body"] == "x"

    def test_duplicate_id_errors_but_connection_survives(self, m, client):
        oid = client.insert_one("dup", {"a": 1})
        with pytest.raises(m.MongoWireError, match="duplicate"):
            client.command({"insert": "dup",
                            "documents": [{"_id": oid, "a": 2}]})
        assert client.count_documents("dup") == 1  # still usable

    def test_health_check_up_down(self, m, server, client):
        assert client.health_check()["status"] == "UP"
        server.close()
        assert client.health_check()["status"] == "DOWN"

    def test_write_errors_raise(self, m, client, monkeypatch):
        """ok:1 + writeErrors (how real servers report failed writes)
        must raise, not silently succeed."""
        real = m.MiniMongoServer._execute

        def with_write_error(self, body):
            if "insert" in body:
                return {"ok": 1.0, "n": 0,
                        "writeErrors": [{"index": 0, "code": 11000,
                                         "errmsg": "E11000 duplicate key"}]}
            return real(self, body)

        monkeypatch.setattr(m.MiniMongoServer, "_execute", with_write_error)
        with pytest.raises(m.MongoWireError, match="duplicate key"):
            client.insert_one("w", {"a": 1})


# -------------------------------------------------------------- Cassandra
class TestCassandra:
    """``cassandra_wire``: CQL native protocol v4, PlainText auth."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("cassandra", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniCassandraServer(keyspace="ks", user="cassandra",
                                    password="cassandra")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def db(self, m, server):
        c = m.CassandraWire(host="127.0.0.1", port=server.port,
                            keyspace="ks", username="cassandra",
                            password="cassandra")
        c.connect()
        yield c
        c.close()

    def test_query_roundtrip_with_typed_columns(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS readings "
                "(id INTEGER, temp REAL, raw BLOB, label TEXT)")
        db.exec("DELETE FROM readings")
        db.exec("INSERT INTO readings VALUES (?, ?, ?, ?)",
                1, 21.5, b"\x01\x02", "lab")
        rows = db.query("SELECT id, temp, raw, label FROM readings")
        assert rows == [{"id": 1, "temp": 21.5, "raw": b"\x01\x02",
                         "label": "lab"}]
        # ints ride as bigint (8-byte), floats as double — both exact
        assert isinstance(rows[0]["id"], int)
        assert isinstance(rows[0]["temp"], float)

    def test_null_values(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_null (id INTEGER, v TEXT)")
        db.exec("DELETE FROM t_null")
        db.exec("INSERT INTO t_null VALUES (?, ?)", 1, None)
        assert db.query("SELECT v FROM t_null")[0]["v"] is None

    def test_batch_executes_atomically(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_batch (id INTEGER)")
        db.exec("DELETE FROM t_batch")
        db.new_batch("b1")
        db.batch_query("b1", "INSERT INTO t_batch VALUES (?)", 1)
        db.batch_query("b1", "INSERT INTO t_batch VALUES (?)", 2)
        db.execute_batch("b1")
        assert len(db.query("SELECT * FROM t_batch")) == 2
        # a failing statement rolls the whole batch back
        db.new_batch("b2")
        db.batch_query("b2", "INSERT INTO t_batch VALUES (?)", 3)
        db.batch_query("b2", "INSERT INTO no_such_table VALUES (1)")
        with pytest.raises(m.CassandraWireError):
            db.execute_batch("b2")
        assert len(db.query("SELECT * FROM t_batch")) == 2

    def test_error_frame_carries_code_and_message(self, m, db):
        with pytest.raises(m.CassandraWireError) as exc:
            db.query("SELECT * FROM missing_table")
        assert "missing_table" in str(exc.value) or "no such table" \
            in str(exc.value)
        assert exc.value.code != 0
        # connection survives the error
        db.exec("CREATE TABLE IF NOT EXISTS t_ok (id INTEGER)")
        assert db.health_check()["status"] == "UP"

    def test_wrong_password_rejected(self, m, server):
        bad = m.CassandraWire(host="127.0.0.1", port=server.port,
                              username="cassandra", password="WRONG")
        with pytest.raises(m.CassandraWireError, match="credentials"):
            bad.connect()

    def test_no_auth_server_sends_ready(self, m):
        with started(m.MiniCassandraServer()) as srv:
            c = m.CassandraWire(host="127.0.0.1", port=srv.port)
            c.connect()
            assert c.health_check()["status"] == "UP"
            c.close()

    def test_literals_and_qmark_expansion(self, m):
        for lit in (m.cql_literal, m.srv("cql_literal")):
            assert lit(None) == "NULL"
            assert lit(True) == "true"
            assert lit(b"\xbe\xef") == "0xbeef"
            assert lit("o'brien") == "'o''brien'"
        for expand in (m.expand_qmarks, m.srv("expand_qmarks")):
            assert expand("SELECT 'a?b' WHERE x = ?", (1,)) \
                == "SELECT 'a?b' WHERE x = 1"
        with pytest.raises(m.CassandraWireError):
            m.expand_qmarks("SELECT ?", ())

    def test_health_down_when_unreachable(self, m):
        c = m.CassandraWire(host="127.0.0.1", port=1)
        assert c.health_check()["status"] == "DOWN"

    def test_scylla_speaks_cql(self, m):
        with started(m.MiniCassandraServer()) as srv:
            db = m.ScyllaWire(host="127.0.0.1", port=srv.port)
            db.connect()
            db.exec("CREATE TABLE heat (id INTEGER, c REAL)")
            db.exec("INSERT INTO heat VALUES (?, ?)", 1, 42.0)
            assert db.query("SELECT c FROM heat")[0]["c"] == 42.0
            assert db.metric == "app_scylladb_stats"
            db.close()


# -------------------------------------------------------------- ClickHouse
class TestClickhouse:
    """``clickhouse_wire``: the HTTP interface, JSONEachRow."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("clickhouse", request.param)

    @pytest.fixture(scope="class")
    def ch(self, m):
        srv = m.MiniClickhouseServer()
        srv.start()
        client = m.ClickhouseWire(endpoint=f"127.0.0.1:{srv.port}")
        client.connect()
        yield client
        srv.close()

    def test_ch_roundtrip_jsoneachrow(self, m, ch):
        ch.exec("CREATE TABLE events (id INTEGER, kind TEXT, val REAL)")
        ch.exec("INSERT INTO events VALUES (?, ?, ?)", 1, "click", 0.5)
        ch.async_insert("INSERT INTO events VALUES (?, ?, ?)", 2, "view",
                        1.5)
        rows = ch.select("SELECT id, kind, val FROM events ORDER BY id")
        assert rows == [{"id": 1, "kind": "click", "val": 0.5},
                        {"id": 2, "kind": "view", "val": 1.5}]

    def test_ch_placeholder_escaping(self, m, ch):
        ch.exec("CREATE TABLE quotes (s TEXT)")
        tricky = "O'Brien said \\ 'hi'"
        ch.exec("INSERT INTO quotes VALUES (?)", tricky)
        assert ch.select("SELECT s FROM quotes")[0]["s"] == tricky

    def test_ch_placeholder_inside_literal_not_expanded(self, m):
        for expand in (m.expand_placeholders, m.srv("expand_placeholders")):
            assert expand("SELECT 'a?b', ?", (1,)) == "SELECT 'a?b', 1"
        with pytest.raises(m.ClickhouseWireError):
            m.expand_placeholders("SELECT ?", ())
        with pytest.raises(m.ClickhouseWireError):
            m.expand_placeholders("SELECT 1", (5,))

    def test_ch_null_and_bool_literals(self, m, ch):
        ch.exec("CREATE TABLE flags (a INTEGER, b INTEGER)")
        ch.exec("INSERT INTO flags VALUES (?, ?)", None, True)
        row = ch.select("SELECT a, b FROM flags")[0]
        assert row["a"] is None and row["b"] == 1

    def test_ch_format_word_in_identifier_still_gets_json(self, m, ch):
        ch.exec("CREATE TABLE fmt (format_version INTEGER)")
        ch.exec("INSERT INTO fmt VALUES (?)", 3)
        # 'format' inside an identifier must not suppress the FORMAT clause
        assert ch.select("SELECT format_version FROM fmt") \
            == [{"format_version": 3}]

    def test_ch_error_surfaces(self, m, ch):
        with pytest.raises(m.ClickhouseWireError, match="DB::Exception"):
            ch.select("SELECT * FROM nonexistent_table")

    def test_ch_health(self, m, ch):
        assert ch.health_check()["status"] == "UP"
        assert m.ClickhouseWire(
            endpoint="127.0.0.1:1").health_check()["status"] == "DOWN"


# --------------------------------------------------------------- OpenTSDB
class TestOpenTSDB:
    """``opentsdb_wire``: the HTTP API."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("opentsdb", request.param)

    @pytest.fixture(scope="class")
    def tsdb(self, m):
        srv = m.MiniOpenTSDBServer()
        srv.start()
        client = m.OpenTSDBWire(endpoint=f"127.0.0.1:{srv.port}")
        client.connect()
        yield client
        srv.close()

    def test_tsdb_put_and_query(self, m, tsdb):
        n = tsdb.put_data_points([
            {"metric": "sys.cpu", "timestamp": 100, "value": 1.0,
             "tags": {"host": "a"}},
            {"metric": "sys.cpu", "timestamp": 160, "value": 3.0,
             "tags": {"host": "b"}},
        ])
        assert n == 2
        result = tsdb.query("sys.cpu", aggregator="sum")
        assert result["dps"] == {"100": 1.0, "160": 3.0}
        assert result["value"] == 4.0

    def test_tsdb_query_with_tags_and_range(self, m, tsdb):
        tsdb.put_data_points([
            {"metric": "sys.mem", "timestamp": 10, "value": 5.0,
             "tags": {"host": "a"}},
            {"metric": "sys.mem", "timestamp": 20, "value": 7.0,
             "tags": {"host": "b"}},
        ])
        only_a = tsdb.query("sys.mem", aggregator="max", tags={"host": "a"})
        assert only_a["dps"] == {"10": 5.0}
        ranged = tsdb.query("sys.mem", start=15, end=25)
        assert ranged["dps"] == {"20": 7.0}

    def test_tsdb_annotations(self, m, tsdb):
        tsdb.put_annotation({"startTime": 50, "description": "deploy v2"})
        tsdb.put_annotation({"startTime": 500, "description": "deploy v3"})
        found = tsdb.query_annotations(0, 100)
        assert [a["description"] for a in found] == ["deploy v2"]

    def test_tsdb_bad_point_is_an_error(self, m, tsdb):
        with pytest.raises(m.OpenTSDBWireError):
            tsdb.put_data_points([{"metric": "x"}])  # no timestamp/value

    def test_tsdb_health(self, m, tsdb):
        health = tsdb.health_check()
        assert health["status"] == "UP"
        assert health["details"]["version"].startswith("2.4")
        assert m.OpenTSDBWire(
            endpoint="127.0.0.1:1").health_check()["status"] == "DOWN"


# -------------------------------------------------------------- Couchbase
class TestCouchbase:
    """``couchbase_wire``: memcached binary KV (SASL PLAIN) + N1QL."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("couchbase", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniCouchbaseServer(username="app", password="pw")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def cb(self, m, server):
        client = m.CouchbaseWire(
            host="127.0.0.1", kv_port=server.kv_port,
            query_endpoint=f"127.0.0.1:{server.query_port}",
            username="app", password="pw")
        client.connect()
        yield client
        client.close()

    def test_kv_roundtrip_over_binary_protocol(self, m, cb):
        not_found = m.side("datasource.document").DocumentNotFound
        cb.upsert("profiles", "u1", {"name": "ada", "score": 9})
        assert cb.get("profiles", "u1") == {"name": "ada", "score": 9}
        cb.upsert("profiles", "u1", {"name": "ada", "score": 10})
        assert cb.get("profiles", "u1")["score"] == 10
        cb.remove("profiles", "u1")
        with pytest.raises(not_found):
            cb.get("profiles", "u1")
        with pytest.raises(not_found):
            cb.remove("profiles", "u1")

    def test_insert_conflicts_on_existing_key(self, m, cb):
        cb.upsert("tickets", "t1", {"state": "open"})
        with pytest.raises(m.side("datasource.document").DocumentError,
                           match="duplicate"):
            cb.insert("tickets", "t1", {"state": "new"})
        cb.insert("tickets", "t2", {"state": "new"})
        assert cb.get("tickets", "t2")["state"] == "new"

    def test_n1ql_query_with_named_args(self, m, cb):
        cb.upsert("fleet", "a", {"kind": "v5e", "up": True})
        cb.upsert("fleet", "b", {"kind": "v5p", "up": True})
        cb.upsert("fleet", "c", {"kind": "v5e", "up": False})
        rows = cb.query("fleet", {"kind": "v5e", "up": True})
        assert len(rows) == 1 and rows[0]["up"] is True
        assert len(cb.query("fleet")) == 3

    def test_injection_shaped_identifiers_rejected(self, m, cb):
        with pytest.raises(m.CouchbaseWireError, match="invalid field"):
            cb.query("fleet", {'x` = "" OR 1=1 OR `y': "v"})
        with pytest.raises(m.CouchbaseWireError, match="invalid bucket"):
            cb.query("b` d; DROP `x", {})

    def test_wrong_password_rejected(self, m, server):
        bad = m.CouchbaseWire(host="127.0.0.1", kv_port=server.kv_port,
                              username="app", password="WRONG")
        with pytest.raises(m.CouchbaseWireError, match="SASL"):
            bad.connect()

    def test_health(self, m, cb):
        health = cb.health_check()
        assert health["status"] == "UP"
        assert "PLAIN" in health["details"]["mechs"]


# ------------------------------------------------------------------- ES
class TestElasticsearch:
    """``es_wire``: the REST API."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("es", request.param)

    @pytest.fixture(scope="class")
    def es(self, m):
        srv = m.MiniESServer()
        srv.start()
        client = m.ElasticsearchWire(endpoint=f"127.0.0.1:{srv.port}")
        client.connect()
        yield client
        srv.close()

    def test_es_index_get_delete(self, m, es):
        not_found = m.side("datasource.document").DocumentNotFound
        es.index("articles", "a1", {"title": "Ring attention on TPU"})
        doc = es.get("articles", "a1")
        assert doc["title"] == "Ring attention on TPU"
        assert doc["_id"] == "a1"
        es.delete("articles", "a1")
        with pytest.raises(not_found):
            es.get("articles", "a1")
        with pytest.raises(not_found):
            es.delete("articles", "a1")

    def test_es_match_search_ranks_by_overlap(self, m, es):
        es.index("posts", "1", {"body": "sharding large language models"})
        es.index("posts", "2", {"body": "sharding models over device mesh"})
        es.index("posts", "3", {"body": "cooking pasta"})
        result = es.search("posts", {"match": {"body": "sharding models"}})
        hits = result["hits"]["hits"]
        assert [h["_id"] for h in hits[:2]] in (["1", "2"], ["2", "1"])
        assert all(h["_id"] != "3" for h in hits)
        assert result["hits"]["total"]["value"] == 2

    def test_es_term_and_match_all(self, m, es):
        es.index("users", "u1", {"role": "admin"})
        es.index("users", "u2", {"role": "dev"})
        term = es.search("users", {"term": {"role": "admin"}})
        assert [h["_id"] for h in term["hits"]["hits"]] == ["u1"]
        everything = es.search("users", {"match_all": {}})
        assert everything["hits"]["total"]["value"] == 2

    def test_es_bulk(self, m, es):
        n = es.bulk("logs", [(str(i), {"n": i}) for i in range(5)])
        assert n == 5
        assert es.get("logs", "3")["n"] == 3

    def test_es_unsupported_query_is_an_error(self, m, es):
        with pytest.raises(m.ESWireError):
            es.search("posts", {"fuzzy": {"body": "x"}})

    def test_es_health(self, m, es):
        assert es.health_check()["status"] == "UP"
        down = m.ElasticsearchWire(endpoint="127.0.0.1:1")
        assert down.health_check()["status"] == "DOWN"


# ------------------------------------------------------------------ Solr
class TestSolr:
    """``solr_wire``: the HTTP API."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("solr", request.param)

    @pytest.fixture(scope="class")
    def solr(self, m):
        srv = m.MiniSolrServer()
        srv.start()
        client = m.SolrWire(endpoint=f"127.0.0.1:{srv.port}")
        client.connect()
        yield client
        srv.close()

    def test_solr_add_and_select(self, m, solr):
        solr.add("books", [{"id": "b1", "title": "Systems on TPU"},
                           {"id": "b2", "title": "Cooking for devs"}])
        result = solr.search("books", "title:Systems on TPU")
        assert result["response"]["numFound"] == 1
        everything = solr.search("books", "*:*")
        assert everything["response"]["numFound"] == 2

    def test_solr_bare_text_search(self, m, solr):
        solr.add("notes", [{"id": "n1", "text": "mesh sharding plan"},
                           {"id": "n2", "text": "grocery list"}])
        result = solr.search("notes", "sharding")
        assert [d["id"] for d in result["response"]["docs"]] == ["n1"]

    def test_solr_delete(self, m, solr):
        solr.add("tmp", [{"id": "t1", "v": 1}])
        assert solr.search("tmp", "*:*")["response"]["numFound"] == 1
        solr.delete("tmp", "t1")
        assert solr.search("tmp", "*:*")["response"]["numFound"] == 0

    def test_solr_health(self, m, solr):
        health = solr.health_check()
        assert health["status"] == "UP"
        assert health["details"]["solr_version"].startswith("9")
        down = m.SolrWire(endpoint="127.0.0.1:1")
        assert down.health_check()["status"] == "DOWN"


# -------------------------------------------------------------------- S3
class TestS3:
    """``s3_wire``: SigV4-signed REST, re-derived by the Mini server."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("s3", request.param)

    @pytest.fixture()
    def server(self, m):
        srv = m.MiniS3Server(access_key="AKID", secret_key="s3cr3t")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def client(self, m, server):
        c = m.S3Wire(endpoint=f"127.0.0.1:{server.port}", bucket="data",
                     access_key="AKID", secret_key="s3cr3t")
        c.connect()
        c.create_bucket()
        return c

    def test_put_get_delete_roundtrip(self, m, client):
        client.put_object("reports/q1.txt", b"hello s3")
        assert client.get_object("reports/q1.txt") == b"hello s3"
        assert client.exists("reports/q1.txt")
        client.delete_object("reports/q1.txt")
        assert not client.exists("reports/q1.txt")
        with pytest.raises(m.side("datasource.object_store").ObjectNotFound):
            client.get_object("reports/q1.txt")

    def test_list_objects_with_prefix(self, m, client):
        client.put_object("a/1", b"x")
        client.put_object("a/2", b"yy")
        client.put_object("b/3", b"zzz")
        keys = {o["Key"] for o in client.list_objects()}
        assert keys == {"a/1", "a/2", "b/3"}
        under_a = client.list_objects(prefix="a/")
        assert {o["Key"] for o in under_a} == {"a/1", "a/2"}
        assert {o["Size"] for o in under_a} == {1, 2}

    def test_list_objects_follows_pagination(self, m, server, client):
        """The client walks IsTruncated/NextContinuationToken to the end
        (real S3 truncates at max-keys, default 1000)."""
        for i in range(7):
            client.put_object(f"p/{i:02d}", b"v")
        pages = []
        orig = client._call

        def spy(method, path, query=None, body=b""):
            if query and query.get("list-type") == "2":
                # shrink the page size so truncation actually happens
                query = dict(query, **{"max-keys": "3"})
                pages.append(query.get("continuation-token", ""))
            return orig(method, path, query, body)

        client._call = spy
        try:
            keys = [o["Key"] for o in client.list_objects(prefix="p/")]
        finally:
            client._call = orig
        assert keys == [f"p/{i:02d}" for i in range(7)]
        assert len(pages) == 3  # 3+3+1 across three requests

    def test_exists_true_false_and_error(self, m, server, client):
        client.put_object("here", b"x")
        assert client.exists("here") is True
        assert client.exists("absent") is False
        bad = m.S3Wire(endpoint=f"127.0.0.1:{server.port}", bucket="data",
                       access_key="AKID", secret_key="WRONG")
        with pytest.raises(m.S3Error, match="403"):
            bad.exists("here")  # auth trouble must not read as "absent"

    def test_wrong_secret_is_rejected(self, m, server):
        bad = m.S3Wire(endpoint=f"127.0.0.1:{server.port}", bucket="data",
                       access_key="AKID", secret_key="WRONG")
        with pytest.raises(m.S3Error, match="403"):
            bad.put_object("k", b"v")

    def test_wrong_access_key_is_rejected(self, m, server):
        bad = m.S3Wire(endpoint=f"127.0.0.1:{server.port}", bucket="data",
                       access_key="NOPE", secret_key="s3cr3t")
        with pytest.raises(m.S3Error, match="403"):
            bad.put_object("k", b"v")

    def test_tampered_body_breaks_signature(self, m, server, client):
        """The payload hash is part of the signature: the server rejects
        a body that doesn't match the signed hash."""
        import urllib.request

        headers = m.sign_v4("PUT", "/data/k", {},
                            {"host": f"127.0.0.1:{server.port}"},
                            b"original", access_key="AKID",
                            secret_key="s3cr3t", region="us-east-1")
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/data/k", data=b"TAMPERED",
            method="PUT", headers=headers)
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(req, timeout=10)
        assert exc_info.value.code == 403

    def test_signatures_equal_across_packages(self, m):
        """SigV4 of the same request at the same instant: the same
        headers, signature included, on both sides."""
        args = ("PUT", "/data/a b/k", {"x-id": "1", "b": "two words"},
                {"host": "127.0.0.1:9"}, b"payload")
        keys = {"access_key": "AKID", "secret_key": "s3cr3t",
                "region": "eu-west-1",
                "when": datetime.datetime(2026, 7, 30, 12, 0, 5,
                                          tzinfo=datetime.timezone.utc)}
        signed = m.sign_v4(*args, **keys)
        assert signed == m.srv("sign_v4")(*args, **keys)
        assert signed["authorization"].startswith(
            "AWS4-HMAC-SHA256 Credential=AKID/20260730/eu-west-1/s3/")

    def test_health_check(self, m, client, server):
        assert client.health_check()["status"] == "UP"
        server.close()
        assert client.health_check()["status"] == "DOWN"


# ---------------------------------------------------------------- Dynamo
class TestDynamo:
    """``dynamo_wire``: the JSON 1.0 API with SigV4."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("dynamo", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniDynamoServer(access_key="AKID", secret_key="s3cr3t")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def kv(self, m, server):
        client = m.DynamoKV(endpoint=f"127.0.0.1:{server.port}", table="t",
                            access_key="AKID", secret_key="s3cr3t")
        client.connect()
        return client

    def test_kv_roundtrip(self, m, kv):
        kv.set("alpha", "1")
        kv.set("beta", "two")
        assert kv.get("alpha") == "1"
        kv.set("alpha", "updated")
        assert kv.get("alpha") == "updated"
        kv.delete("alpha")
        with pytest.raises(m.side("datasource.kv").KeyNotFound):
            kv.get("alpha")
        kv.delete("alpha")  # idempotent, like the other KV backends
        kv.delete("beta")

    def test_keys_follow_scan_pagination(self, m, kv, monkeypatch):
        for i in range(7):
            kv.set(f"p{i}", "x")
        monkeypatch.setattr(m.side("datasource.dynamo_wire"), "_SCAN_PAGE",
                            3)
        assert kv.keys() == [f"p{i}" for i in range(7)]
        for i in range(7):
            kv.delete(f"p{i}")

    def test_wrong_secret_rejected(self, m, server):
        bad = m.DynamoKV(endpoint=f"127.0.0.1:{server.port}", table="t",
                         access_key="AKID", secret_key="WRONG")
        with pytest.raises(m.DynamoError, match="403"):
            bad.set("k", "v")
        assert bad.health_check()["status"] == "DOWN"

    def test_unicode_values(self, m, kv):
        kv.set("uni", "héllo ∆ 中文")
        assert kv.get("uni") == "héllo ∆ 中文"
        kv.delete("uni")

    def test_health(self, m, kv):
        assert kv.health_check()["status"] == "UP"
        assert m.DynamoKV(endpoint="127.0.0.1:1",
                          table="t").health_check()["status"] == "DOWN"


# ------------------------------------------------------------------- GCS
class TestGCS:
    """``gcs_wire``: the JSON API, Bearer auth."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("gcs", request.param)

    @pytest.fixture(scope="class")
    def gcs_server(self, m):
        srv = m.MiniGCSServer(token="tok-123")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def gcs(self, m, gcs_server):
        client = m.GCSWire(endpoint=f"127.0.0.1:{gcs_server.port}",
                           bucket="models", token="tok-123")
        client.connect()
        return client

    def test_gcs_upload_download_delete(self, m, gcs):
        not_found = m.side("datasource.object_store").ObjectNotFound
        gcs.upload("ckpt/weights.bin", b"\x00\x01payload")
        assert gcs.download("ckpt/weights.bin") == b"\x00\x01payload"
        assert gcs.exists("ckpt/weights.bin") is True
        gcs.delete("ckpt/weights.bin")
        assert gcs.exists("ckpt/weights.bin") is False
        with pytest.raises(not_found):
            gcs.download("ckpt/weights.bin")
        with pytest.raises(not_found):
            gcs.delete("ckpt/weights.bin")

    def test_gcs_list_with_prefix_and_pagination(self, m, gcs, monkeypatch):
        for i in range(7):
            gcs.upload(f"logs/{i:02d}", b"x")
        gcs.upload("other/1", b"y")
        want = [f"logs/{i:02d}" for i in range(7)]
        assert gcs.list_blobs(prefix="logs/") == want
        # force tiny pages so the nextPageToken loop actually runs
        monkeypatch.setattr(m.side("datasource.gcs_wire"), "_PAGE_SIZE", 3)
        assert gcs.list_blobs(prefix="logs/") == want

    def test_gcs_wrong_token_is_401(self, m, gcs_server):
        bad = m.GCSWire(endpoint=f"127.0.0.1:{gcs_server.port}",
                        bucket="models", token="WRONG")
        with pytest.raises(m.GCSError, match="401"):
            bad.upload("x", b"y")
        assert bad.health_check()["status"] == "DOWN"

    def test_gcs_health(self, m, gcs):
        assert gcs.health_check()["status"] == "UP"


# ------------------------------------------------------------ Azure Blob
class TestAzureBlob:
    """``azure_blob_wire``: the Blob REST API, SharedKey auth."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("azure_blob", request.param)

    @pytest.fixture(scope="class")
    def az_server(self, m):
        srv = m.MiniAzureBlobServer(account="acct", key_b64=AZ_KEY)
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def az(self, m, az_server):
        client = m.AzureBlobWire(endpoint=f"127.0.0.1:{az_server.port}",
                                 account="acct", key_b64=AZ_KEY,
                                 container="artifacts")
        client.connect()
        return client

    def test_azure_upload_download_delete(self, m, az):
        not_found = m.side("datasource.object_store").ObjectNotFound
        az.upload_blob("run1/trace.json", b'{"spans": []}')
        assert az.download_blob("run1/trace.json") == b'{"spans": []}'
        az.delete_blob("run1/trace.json")
        with pytest.raises(not_found):
            az.download_blob("run1/trace.json")
        with pytest.raises(not_found):
            az.delete_blob("run1/trace.json")

    def test_azure_no_overwrite_conflict(self, m, az):
        az.upload_blob("once", b"a")
        with pytest.raises(m.AzureBlobError, match="exists"):
            az.upload_blob("once", b"b", overwrite=False)
        az.upload_blob("once", b"c")  # overwrite=True wins
        assert az.download_blob("once") == b"c"

    def test_azure_list_with_pagination(self, m, az, monkeypatch):
        for i in range(6):
            az.upload_blob(f"shard/{i}", b"x")
        want = [f"shard/{i}" for i in range(6)]
        assert az.list_blob_names(prefix="shard/") == want
        monkeypatch.setattr(m.side("datasource.azure_blob_wire"),
                            "_PAGE_SIZE", 2)
        assert az.list_blob_names(prefix="shard/") == want

    def test_azure_wrong_key_is_403(self, m, az_server):
        bad = m.AzureBlobWire(endpoint=f"127.0.0.1:{az_server.port}",
                              account="acct",
                              key_b64=base64.b64encode(b"wrong").decode(),
                              container="artifacts")
        with pytest.raises(m.AzureBlobError, match="403"):
            bad.upload_blob("x", b"y")

    def test_azure_health(self, m, az):
        assert az.health_check()["status"] == "UP"
        assert m.AzureBlobWire(endpoint="127.0.0.1:1", account="a",
                               key_b64=AZ_KEY).health_check()["status"] \
            == "DOWN"


# ---------------------------------------------------------------- Influx
class TestInflux:
    """``influx_wire``: the 1.x HTTP API, line protocol and InfluxQL."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("influx", request.param)

    @pytest.fixture()
    def server(self, m):
        srv = m.MiniInfluxServer()
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def client(self, m, server):
        c = m.InfluxWire(url=f"127.0.0.1:{server.port}")
        c.connect()
        yield c
        c.close()

    def test_line_protocol_roundtrip(self, m):
        line = m.encode_line("cpu", {"usage": 42.5},
                             {"host": "a b", "dc": "eu"}, ts=1700000000.123)
        measurement, tags, fields, ts = m.srv("decode_line")(line)
        assert measurement == "cpu"
        assert tags == {"host": "a b", "dc": "eu"}
        assert fields == {"usage": 42.5}
        assert ts == pytest.approx(1700000000.123, abs=1e-6)

    def test_line_protocol_escaping(self, m):
        line = m.encode_line("my measure", {"v": 1.0}, {"k=1": "x,y"})
        measurement, tags, fields, _ = m.srv("decode_line")(line)
        assert measurement == "my measure"
        assert tags == {"k=1": "x,y"}

    def test_line_requires_fields(self, m):
        with pytest.raises(m.side("datasource.timeseries").TimeseriesError):
            m.encode_line("m", {})

    def test_write_query_roundtrip(self, m, client):
        client.create_bucket("metrics")
        client.write_point("metrics", "cpu", 100.0, {"usage": 0.5},
                           {"host": "a"})
        client.write_point("metrics", "cpu", 200.0, {"usage": 0.9},
                           {"host": "b"})
        points = client.query("metrics", "cpu", "usage")
        assert points == [(100.0, 0.5), (200.0, 0.9)]
        # range + tag filters ride the InfluxQL WHERE clause
        assert client.query("metrics", "cpu", "usage", start=150.0) == \
            [(200.0, 0.9)]
        assert client.query("metrics", "cpu", "usage",
                            tags={"host": "a"}) == [(100.0, 0.5)]

    def test_aggregates(self, m, client):
        client.create_bucket("m")
        for i, v in enumerate([1.0, 2.0, 3.0]):
            client.write_point("m", "t", float(i), {"v": v})
        assert client.aggregate("m", "t", "v", "sum") == 6.0
        assert client.aggregate("m", "t", "v", "avg") == 2.0
        assert client.aggregate("m", "t", "v", "max") == 3.0
        assert client.aggregate("m", "t", "v", "count") == 3
        assert client.aggregate("m", "t", "v", "avg", start=1.0) == 2.5
        assert client.aggregate("m", "nothing", "v", "avg") is None

    def test_bucket_admin(self, m, client):
        client.create_bucket("a")
        client.create_bucket("b")
        assert client.list_buckets() == ["a", "b"]
        client.delete_bucket("a")
        assert client.list_buckets() == ["b"]

    def test_health_check(self, m, client, server):
        assert client.health_check()["status"] == "UP"
        server.close()
        assert client.health_check()["status"] == "DOWN"

    def test_quoted_tag_values_roundtrip(self, m, client):
        client.create_bucket("q")
        client.write_point("q", "t", 1.0, {"v": 5.0}, {"host": "o'brien"})
        assert client.query("q", "t", "v", tags={"host": "o'brien"}) == \
            [(1.0, 5.0)]

    def test_invalid_identifier_rejected(self, m, client):
        with pytest.raises(m.side("datasource.timeseries").TimeseriesError,
                           match="invalid identifier"):
            client.query("b", 'x" OR 1=1', "v")


# ---------------------------------------------------------------- Dgraph
class TestDgraph:
    """``dgraph_wire``: generated DQL over HTTP."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("dgraph", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniDgraphServer()
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def db(self, m, server):
        client = m.DgraphWire(endpoint=f"127.0.0.1:{server.port}")
        client.connect()
        return client

    def test_dql_generation(self, m):
        for build in (m.build_query_dql, m.srv("build_query_dql")):
            assert build({}) \
                == "{ q(func: has(dgraph.type)) { uid expand(_all_) } }"
            assert build({"name": "ada"}) \
                == '{ q(func: eq(name, "ada")) { uid expand(_all_) } }'
            dql = build({"name": 'a"b', "age": 36}, expand="friend")
            assert dql == ('{ q(func: eq(age, 36)) @filter(eq(name, '
                           '"a\\"b")) { uid expand(_all_) friend '
                           '{ uid expand(_all_) } } }')

    def test_mutate_and_query(self, m, db):
        uids = db.mutate([{"uid": "_:a", "name": "ada", "age": 36},
                          {"uid": "_:g", "name": "grace", "age": 30}])
        assert set(uids) == {"a", "g"}
        rows = db.query({"name": "ada"})
        assert len(rows) == 1 and rows[0]["age"] == 36
        assert rows[0]["uid"]

    def test_query_with_filter_and_expand(self, m, db):
        db.mutate({"name": "linus", "knows": [{"name": "andrew"}]})
        rows = db.query({"name": "linus"}, expand="knows")
        assert rows and rows[0]["knows"][0]["name"] == "andrew"

    def test_numeric_and_bool_predicates(self, m, db):
        db.mutate({"name": "flagged", "active": True, "rank": 2.5})
        rows = db.query({"active": True, "rank": 2.5})
        assert any(r["name"] == "flagged" for r in rows)

    def test_alter_and_errors(self, m, db):
        db.alter("name: string @index(term) .")
        # by-hand DQL outside the supported subset: an in-body error
        status, data = db._call(
            "/query", b"{ q(func: regexp(name, /a/)) { uid } }",
            "application/dql")
        assert status == 200 and data.get("errors")
        with pytest.raises(m.DgraphWireError):
            m.DgraphWire._check(status, data, "query")

    def test_values_containing_and_or_parens(self, m, db):
        """Quoted values with \" AND \" or \")\" survive generation and
        the Mini server's parsing."""
        db.mutate({"name": "rock AND roll (live)", "n": 1})
        rows = db.query({"name": "rock AND roll (live)", "n": 1})
        assert rows and rows[0]["n"] == 1

    def test_injection_shaped_predicate_rejected(self, m, db):
        with pytest.raises(m.DgraphWireError, match="invalid predicate"):
            db.query({'name) { uid } } { q2(func: has(x)': "v"})

    def test_health(self, m, db):
        assert db.health_check()["status"] == "UP"
        assert m.DgraphWire(endpoint="127.0.0.1:1").health_check()[
            "status"] == "DOWN"


# ---------------------------------------------------------------- Arango
class TestArango:
    """``arango_wire``: the HTTP document API, basic auth."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("arango", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniArangoServer(username="root", password="pw")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def db(self, m, server):
        client = m.ArangoWire(endpoint=f"127.0.0.1:{server.port}",
                              username="root", password="pw")
        client.connect()
        return client

    def test_document_crud(self, m, db):
        not_found = m.side("datasource.graph").NodeNotFound
        key = db.create_document("people", {"name": "ada", "age": 36})
        assert key
        assert db.get_document("people", key) == {"name": "ada", "age": 36}
        db.update_document("people", key, {"name": "ada", "age": 37})
        assert db.get_document("people", key)["age"] == 37
        db.delete_document("people", key)
        with pytest.raises(not_found):
            db.get_document("people", key)
        with pytest.raises(not_found):
            db.delete_document("people", key)

    def test_query_by_example(self, m, db):
        db.create_document("cities", {"name": "pisa", "country": "it"})
        db.create_document("cities", {"name": "rome", "country": "it"})
        db.create_document("cities", {"name": "lyon", "country": "fr"})
        rows = db.query("cities", {"country": "it"})
        assert {r["name"] for r in rows} == {"pisa", "rome"}
        assert all("_id" in r for r in rows)
        assert len(db.query("cities")) == 3

    def test_edges_and_traversal(self, m, db):
        a = db.create_document("nodes", {"label": "a"})
        b = db.create_document("nodes", {"label": "b"})
        c = db.create_document("nodes", {"label": "c"})
        db.create_edge_document("links", f"nodes/{a}", f"nodes/{b}")
        db.create_edge_document("links", b, c)  # bare keys also accepted
        # traversal lists visited neighbors, excluding the start vertex
        assert [d["label"] for d in db.traversal(a, "links", depth=1)] \
            == ["b"]
        assert [d["label"] for d in db.traversal(a, "links", depth=2)] \
            == ["b", "c"]

    def test_bad_credentials_are_401(self, m, server):
        bad = m.ArangoWire(endpoint=f"127.0.0.1:{server.port}",
                           username="root", password="WRONG")
        with pytest.raises(m.ArangoWireError, match="401"):
            bad.create_document("x", {})
        assert bad.health_check()["status"] == "DOWN"

    def test_health(self, m, db):
        health = db.health_check()
        assert health["status"] == "UP"
        assert health["details"]["version"].startswith("3.11")
        assert m.ArangoWire(endpoint="127.0.0.1:1").health_check()[
            "status"] == "DOWN"


# --------------------------------------------------------------- Surreal
class TestSurreal:
    """``surreal_wire``: WebSocket JSON-RPC; the Mini server is an app of
    the server side's package serving ``/rpc``."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("surreal", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniSurrealServer(username="root", password="pw")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def db(self, m, server):
        client = m.SurrealWire(endpoint=f"ws://127.0.0.1:{server.port}/rpc",
                               username="root", password="pw")
        client.connect()
        yield client
        client.close()

    def test_create_select_update_delete(self, m, db):
        doc = db.create("person:ada", {"name": "ada", "year": 1815})
        assert doc["id"] == "person:ada"
        assert doc["name"] == "ada"
        assert db.select("person:ada")[0]["year"] == 1815
        updated = db.update("person:ada", {"name": "ada", "year": 1816})
        assert updated["year"] == 1816
        db.delete("person:ada")
        with pytest.raises(m.SurrealWireError):
            db.select("person:ada")

    def test_create_without_id_assigns_one(self, m, db):
        doc = db.create("event", {"kind": "deploy"})
        assert doc["id"].startswith("event:")
        db.delete(doc["id"])

    def test_query_generates_surrealql_with_vars(self, m, db):
        db.create("city:pisa", {"name": "pisa", "country": "it"})
        db.create("city:rome", {"name": "rome", "country": "it"})
        db.create("city:lyon", {"name": "lyon", "country": "fr"})
        rows = db.query("city", {"country": "it"})
        assert {r["name"] for r in rows} == {"pisa", "rome"}
        assert len(db.query("city")) == 3
        for c in ("pisa", "rome", "lyon"):
            db.delete(f"city:{c}")

    def test_signin_required(self, m, server):
        anon = m.SurrealWire(endpoint=f"ws://127.0.0.1:{server.port}/rpc",
                             username="", password="")
        anon.connect()  # no signin attempted
        try:
            with pytest.raises(m.SurrealWireError, match="not signed in"):
                anon.create("x:1", {"a": 1})
        finally:
            anon.close()

    def test_bad_credentials_rejected(self, m, server):
        bad = m.SurrealWire(endpoint=f"ws://127.0.0.1:{server.port}/rpc",
                            username="root", password="WRONG")
        with pytest.raises(m.SurrealWireError, match="credentials"):
            bad.connect()
        bad.close()

    def test_malformed_rpc_params_get_immediate_error(self, m, db):
        # one param where two are required: a JSON-RPC error, not a stall
        with pytest.raises(m.SurrealWireError, match="invalid params"):
            db._rpc("create", ["only-thing"])

    def test_injection_shaped_field_name_rejected(self, m, db):
        with pytest.raises(m.SurrealWireError, match="invalid field"):
            db.query("t", {"x = 1 OR true; DROP": "v"})

    def test_health(self, m, db):
        assert db.health_check()["status"] == "UP"
        loose = m.SurrealWire(endpoint="ws://127.0.0.1:1/rpc")
        assert loose.health_check()["status"] == "DOWN"


# ------------------------------------------------------ scripted sessions
def _outcome(fn, ports=()):
    """What ``fn()`` gave, as plain values (ObjectIds as raw bytes), or
    its typed error: class name and message, with the session's ports
    written as PORT."""
    try:
        return ("ok", _plain(fn()))
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        text = str(exc)
        for port in ports:
            text = text.replace(str(port), "PORT")
        return ("error", type(exc).__name__, text)


def _mongo_session(m) -> list:
    with started(m.MiniMongoServer()) as srv:
        c = m.MongoWire(host="127.0.0.1", port=srv.port, database="s")
        c.connect()
        steps = [
            lambda: c.insert_many("a", [{"_id": f"id{i}", "v": i,
                                         "tag": "odd" if i % 2 else "even"}
                                        for i in range(6)]),
            lambda: c.find("a", {"v": {"$gte": 2, "$lt": 5}}),
            lambda: c.find("a", {"tag": {"$in": ["odd"]}}),
            lambda: c.update_many("a", {"tag": "even"}, {"$set": {"x": 1}}),
            lambda: c.find_one("a", {"_id": "id2"}),
            lambda: c.delete_many("a", {"v": {"$gt": 3}}),
            lambda: c.count_documents("a"),
            lambda: c.command({"insert": "a",
                               "documents": [{"_id": "id0", "v": 9}]}),
            lambda: c.find_one("a", {"_id": "nope"}),
            lambda: c.command({"no_such_command": 1}),
            lambda: c.health_check()["status"]]
        out = [_outcome(step, [srv.port]) for step in steps]
        c.close()
    return out


def _cassandra_session(m) -> list:
    with started(m.MiniCassandraServer(keyspace="ks", user="u",
                                       password="p")) as srv:
        db = m.CassandraWire(host="127.0.0.1", port=srv.port, keyspace="ks",
                             username="u", password="p")
        db.connect()
        scylla = m.ScyllaWire(host="127.0.0.1", port=srv.port, keyspace="ks",
                              username="u", password="p")
        scylla.connect()

        def batch():
            db.new_batch("b")
            db.batch_query("b", "INSERT INTO t VALUES (?, ?, ?)", 9, "x", 0.0)
            db.batch_query("b", "INSERT INTO missing VALUES (1)")
            db.execute_batch("b")
        steps = [
            lambda: db.exec("CREATE TABLE t (id INTEGER, name TEXT, "
                            "score REAL)"),
            lambda: db.exec("INSERT INTO t VALUES (?, ?, ?)", 1, "ada", 2.5),
            lambda: db.exec("INSERT INTO t VALUES (?, ?, ?)", 2, None, None),
            lambda: db.exec("INSERT INTO t VALUES (?, ?, ?)", 3, "o'b",
                            -1.25),
            lambda: db.query("SELECT id, name, score FROM t ORDER BY id"),
            batch,
            lambda: scylla.query("SELECT COUNT(*) AS n FROM t"),
            lambda: db.query("SELECT * FROM missing"),
            lambda: db.batch_query("never", "SELECT 1"),
            lambda: m.CassandraWire(host="127.0.0.1", port=srv.port,
                                    username="u", password="bad").connect()]
        out = [_outcome(step, [srv.port]) for step in steps]
        db.close()
        scylla.close()
    return out


def _clickhouse_session(m) -> list:
    with started(m.MiniClickhouseServer()) as srv:
        ch = m.ClickhouseWire(endpoint=f"127.0.0.1:{srv.port}")
        ch.connect()
        steps = [
            lambda: ch.exec("CREATE TABLE e (id INTEGER, kind TEXT, "
                            "v REAL)"),
            lambda: ch.exec("INSERT INTO e VALUES (?, ?, ?)", 1, "a'b",
                            0.5),
            lambda: ch.async_insert("INSERT INTO e VALUES (?, ?, ?)", 2,
                                    None, 1.5),
            lambda: ch.select("SELECT id, kind, v FROM e ORDER BY id"),
            lambda: ch.select("SELECT COUNT(*) AS n FROM e"),
            lambda: ch.select("SELECT * FROM missing"),
            lambda: ch.exec("INSERT INTO e VALUES (?)"),
            lambda: ch.health_check()["status"]]
        return [_outcome(step, [srv.port]) for step in steps]


def _es_session(m) -> list:
    with started(m.MiniESServer()) as srv:
        es = m.ElasticsearchWire(endpoint=f"127.0.0.1:{srv.port}")
        es.connect()
        steps = [
            lambda: es.index("p", "1", {"body": "paged cache keeps tokens"}),
            lambda: es.index("p", "2", {"body": "tokens stream out"}),
            lambda: es.bulk("p", [("3", {"body": "cooking"}),
                                  ("4", {"body": "cache misses"})]),
            lambda: es.get("p", "2"),
            lambda: es.search("p", {"match": {"body": "cache tokens"}}),
            lambda: es.search("p", {"term": {"body": "cooking"}}),
            lambda: es.search("p", {"match_all": {}})["hits"]["total"],
            lambda: es.delete("p", "3"),
            lambda: es.get("p", "3"),
            lambda: es.search("p", {"fuzzy": {"body": "x"}})]
        return [_outcome(step, [srv.port]) for step in steps]


def _solr_session(m) -> list:
    with started(m.MiniSolrServer()) as srv:
        solr = m.SolrWire(endpoint=f"127.0.0.1:{srv.port}")
        solr.connect()
        steps = [
            lambda: solr.add("c", [{"id": "a", "text": "one answer kept"},
                                   {"id": "b", "text": "another kept"}]),
            lambda: solr.search("c", "answer"),
            lambda: solr.search("c", "*:*"),
            lambda: solr.search("c", "text:another kept"),
            lambda: solr.delete("c", "a"),
            lambda: solr.search("c", "*:*")["response"]["numFound"],
            lambda: solr.health_check()["status"],
            lambda: m.SolrWire(endpoint="127.0.0.1:1").search("c", "*:*")]
        return [_outcome(step, [srv.port]) for step in steps]


def _couchbase_session(m) -> list:
    with started(m.MiniCouchbaseServer(username="u", password="p")) as srv:
        cb = m.CouchbaseWire(host="127.0.0.1", kv_port=srv.kv_port,
                             query_endpoint=f"127.0.0.1:{srv.query_port}",
                             username="u", password="p")
        cb.connect()
        steps = [
            lambda: cb.upsert("b", "k1", {"n": 1, "s": "x"}),
            lambda: cb.insert("b", "k2", {"n": 2, "s": "y"}),
            lambda: cb.insert("b", "k1", {"n": 3}),
            lambda: cb.get("b", "k1"),
            lambda: cb.query("b", {"s": "y"}),
            lambda: sorted(r["n"] for r in cb.query("b")),
            lambda: cb.remove("b", "k1"),
            lambda: cb.get("b", "k1"),
            lambda: cb.query("b", {"bad`field": 1}),
            lambda: m.CouchbaseWire(host="127.0.0.1", kv_port=srv.kv_port,
                                    username="u", password="no").connect()]
        out = [_outcome(step, [srv.kv_port, srv.query_port])
               for step in steps]
        cb.close()
    return out


def _s3_session(m) -> list:
    with started(m.MiniS3Server(access_key="AK", secret_key="sk")) as srv:
        s3 = m.S3Wire(endpoint=f"127.0.0.1:{srv.port}", bucket="b",
                      access_key="AK", secret_key="sk")
        s3.connect()
        steps = [
            lambda: s3.create_bucket(),
            lambda: s3.put_object("d/1.txt", b"one"),
            lambda: s3.put_object("d/2.bin", bytes(range(256))),
            lambda: s3.get_object("d/2.bin"),
            lambda: [(o["Key"], o["Size"]) for o in s3.list_objects("d/")],
            lambda: s3.exists("d/1.txt"),
            lambda: s3.delete_object("d/1.txt"),
            lambda: s3.exists("d/1.txt"),
            lambda: s3.get_object("d/1.txt"),
            lambda: m.S3Wire(endpoint=f"127.0.0.1:{srv.port}", bucket="b",
                             access_key="AK", secret_key="bad").put_object(
                "k", b"v")]
        return [_outcome(step, [srv.port]) for step in steps]


def _dynamo_session(m) -> list:
    with started(m.MiniDynamoServer(access_key="AK",
                                    secret_key="sk")) as srv:
        kv = m.DynamoKV(endpoint=f"127.0.0.1:{srv.port}", table="t",
                        access_key="AK", secret_key="sk")
        kv.connect()
        steps = [
            lambda: kv.set("a", "1"), lambda: kv.set("b", "héllo"),
            lambda: kv.get("b"), lambda: kv.keys(), lambda: kv.delete("a"),
            lambda: kv.get("a"),
            lambda: m.DynamoKV(endpoint=f"127.0.0.1:{srv.port}", table="t",
                               access_key="AK", secret_key="bad").set(
                "k", "v")]
        return [_outcome(step, [srv.port]) for step in steps]


def _gcs_session(m) -> list:
    with started(m.MiniGCSServer(token="t")) as srv:
        gcs = m.GCSWire(endpoint=f"127.0.0.1:{srv.port}", bucket="b",
                        token="t")
        gcs.connect()
        steps = [
            lambda: gcs.upload("x/1", b"\x00\x01"),
            lambda: gcs.upload("x/2", b"two"),
            lambda: gcs.download("x/1"), lambda: gcs.list_blobs("x/"),
            lambda: gcs.exists("x/2"), lambda: gcs.delete("x/2"),
            lambda: gcs.download("x/2"),
            lambda: m.GCSWire(endpoint=f"127.0.0.1:{srv.port}", bucket="b",
                              token="bad").upload("y", b"z")]
        return [_outcome(step, [srv.port]) for step in steps]


def _azure_session(m) -> list:
    with started(m.MiniAzureBlobServer(account="acct",
                                       key_b64=AZ_KEY)) as srv:
        az = m.AzureBlobWire(endpoint=f"127.0.0.1:{srv.port}",
                             account="acct", key_b64=AZ_KEY, container="c")
        az.connect()
        steps = [
            lambda: az.upload_blob("r/1", b"one"),
            lambda: az.upload_blob("r/1", b"again", overwrite=False),
            lambda: az.download_blob("r/1"),
            lambda: az.list_blob_names("r/"),
            lambda: az.delete_blob("r/1"), lambda: az.download_blob("r/1"),
            lambda: m.AzureBlobWire(
                endpoint=f"127.0.0.1:{srv.port}", account="acct",
                key_b64=base64.b64encode(b"bad").decode(),
                container="c").upload_blob("x", b"y")]
        return [_outcome(step, [srv.port]) for step in steps]


def _influx_session(m) -> list:
    with started(m.MiniInfluxServer()) as srv:
        db = m.InfluxWire(url=f"127.0.0.1:{srv.port}")
        db.connect()
        steps = [
            lambda: db.create_bucket("tok"),
            lambda: [db.write_point("tok", "gen", float(t), {"n": float(n)},
                                    {"host": h})
                     for t, n, h in ((1, 64, "a"), (2, 30, "b"),
                                     (3, 7, "a"))],
            lambda: db.query("tok", "gen", "n"),
            lambda: db.query("tok", "gen", "n", tags={"host": "a"}),
            lambda: db.aggregate("tok", "gen", "n", "sum"),
            lambda: db.aggregate("tok", "gen", "n", "count", start=2.0),
            lambda: db.list_buckets(),
            lambda: db.query("tok", 'x" OR 1=1', "n")]
        out = [_outcome(step, [srv.port]) for step in steps]
        db.close()
    return out


def _opentsdb_session(m) -> list:
    with started(m.MiniOpenTSDBServer()) as srv:
        db = m.OpenTSDBWire(endpoint=f"127.0.0.1:{srv.port}")
        db.connect()
        steps = [
            lambda: db.put_data_points([
                {"metric": "tok", "timestamp": 10, "value": 64.0,
                 "tags": {"h": "a"}},
                {"metric": "tok", "timestamp": 20, "value": 7.0,
                 "tags": {"h": "b"}}]),
            lambda: db.query("tok", aggregator="sum"),
            lambda: db.query("tok", aggregator="max", tags={"h": "b"}),
            lambda: db.put_annotation({"startTime": 15,
                                       "description": "wave"}),
            lambda: db.query_annotations(0, 30),
            lambda: db.put_data_points([{"metric": "x"}])]
        return [_outcome(step, [srv.port]) for step in steps]


def _dgraph_session(m) -> list:
    with started(m.MiniDgraphServer()) as srv:
        db = m.DgraphWire(endpoint=f"127.0.0.1:{srv.port}")
        db.connect()
        steps = [
            lambda: db.alter("name: string @index(term) ."),
            lambda: db.mutate({"uid": "_:u", "name": "user-1",
                               "asked": [{"name": "conv-1", "n": 64}]}),
            lambda: db.query({"name": "user-1"}, expand="asked"),
            lambda: db.query({"n": 64}),
            lambda: db.query({"name) { uid }": "x"})]
        return [_outcome(step, [srv.port]) for step in steps]


def _arango_session(m) -> list:
    with started(m.MiniArangoServer(username="r", password="p")) as srv:
        db = m.ArangoWire(endpoint=f"127.0.0.1:{srv.port}", username="r",
                          password="p")
        db.connect()
        keys: list = []
        steps = [
            lambda: keys.append(db.create_document("n", {"label": "a"})),
            lambda: keys.append(db.create_document("n", {"label": "b"})),
            lambda: db.create_edge_document("e", keys[0], keys[1]),
            lambda: db.get_document("n", keys[1]),
            lambda: [d["label"] for d in db.traversal(keys[0], "e",
                                                      depth=1)],
            lambda: sorted(r["label"] for r in db.query("n")),
            lambda: db.delete_document("n", keys[1]),
            lambda: db.get_document("n", keys[1]),
            lambda: m.ArangoWire(endpoint=f"127.0.0.1:{srv.port}",
                                 username="r", password="bad"
                                 ).create_document("n", {})]
        return [_outcome(step, [srv.port]) for step in steps]


def _surreal_session(m) -> list:
    with started(m.MiniSurrealServer(username="r", password="p")) as srv:
        db = m.SurrealWire(endpoint=f"ws://127.0.0.1:{srv.port}/rpc",
                           username="r", password="p")
        db.connect()
        steps = [
            lambda: db.create("conv:1", {"user": "u1", "n": 64}),
            lambda: db.create("conv:2", {"user": "u2", "n": 7}),
            lambda: db.update("conv:2", {"user": "u2", "n": 8}),
            lambda: db.select("conv:2"),
            lambda: db.query("conv", {"user": "u1"}),
            lambda: db.delete("conv:1"),
            lambda: db.select("conv:1"),
            lambda: db._rpc("create", ["only"]),
            lambda: m.SurrealWire(endpoint=f"ws://127.0.0.1:{srv.port}/rpc",
                                  username="r", password="bad").connect()]
        out = [_outcome(step, [srv.port]) for step in steps]
        db.close()
    return out


SESSIONS = {"mongo": _mongo_session, "cassandra": _cassandra_session,
            "clickhouse": _clickhouse_session, "es": _es_session,
            "solr": _solr_session, "couchbase": _couchbase_session,
            "s3": _s3_session, "dynamo": _dynamo_session,
            "gcs": _gcs_session, "azure_blob": _azure_session,
            "influx": _influx_session, "opentsdb": _opentsdb_session,
            "dgraph": _dgraph_session, "arango": _arango_session,
            "surreal": _surreal_session}


@pytest.mark.parametrize("direction", PAIRS[1:], ids=PAIR_IDS[1:])
@pytest.mark.parametrize("protocol", list(SESSIONS))
def test_cross_session_matches_jax(protocol, direction):
    """The port's client on JAX's server, and JAX's client on the port's,
    return what JAX's client on JAX's server returns: the same documents,
    rows, hits, points and objects, and the same typed errors."""
    session = SESSIONS[protocol]
    want = session(Pair(protocol, ("jax", "jax")))
    got = session(Pair(protocol, direction))
    assert got == want
    assert any(step[0] == "error" for step in want)


# ------------------------------------------- fragmentation, hostile values
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("protocol", ["cassandra", "couchbase", "mongo"])
def test_survives_byte_dribble(protocol, pair):
    """Auth and statements of the binary protocols over a proxy that
    forwards one byte at a time, both ways."""
    from .test_wire_fragmentation import DribbleProxy

    m = Pair(protocol, pair)
    if protocol == "cassandra":
        srv = m.MiniCassandraServer(user="u", password="p")
    elif protocol == "couchbase":
        srv = m.MiniCouchbaseServer(username="u", password="p")
    else:
        srv = m.MiniMongoServer()
    with started(srv):
        proxy = DribbleProxy("127.0.0.1", getattr(srv, "kv_port", None)
                             or srv.port)
        try:
            if protocol == "cassandra":
                db = m.CassandraWire(host="127.0.0.1", port=proxy.port,
                                     username="u", password="p")
                db.connect()  # SASL over 9-byte frames over fragments
                db.exec("CREATE TABLE t (a INTEGER, b TEXT)")
                db.exec("INSERT INTO t VALUES (?, ?)", 3, "z" * 200)
                row = db.query("SELECT a, b FROM t")[0]
                assert row == {"a": 3, "b": "z" * 200}
            elif protocol == "couchbase":
                db = m.CouchbaseWire(
                    host="127.0.0.1", kv_port=proxy.port,
                    query_endpoint=f"127.0.0.1:{srv.query_port}",
                    username="u", password="p")
                db.connect()  # SASL PLAIN over 24-byte headers
                db.upsert("b", "k", {"payload": "w" * 400})
                assert db.get("b", "k") == {"payload": "w" * 400}
            else:
                db = m.MongoWire(host="127.0.0.1", port=proxy.port)
                db.connect()
                db.insert_one("c", {"_id": "k", "payload": "m" * 300})
                assert db.find_one("c", {"_id": "k"})["payload"] == \
                    "m" * 300
            db.close()
        finally:
            proxy.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("protocol",
                         ["cassandra", "clickhouse", "mongo", "dynamo"])
def test_roundtrip_matrix(protocol, pair):
    """Hostile strings (quotes, backslashes, placeholders, NULL-ish bytes,
    unicode) round-trip byte for byte: as bound values of the statement
    stores, as document fields and as KV values."""
    from .test_wire_roundtrip_matrix import ALL

    m = Pair(protocol, pair)
    if protocol in ("cassandra", "clickhouse"):
        srv = m.MiniCassandraServer() if protocol == "cassandra" \
            else m.MiniClickhouseServer()
        with started(srv):
            db = m.CassandraWire(host="127.0.0.1", port=srv.port) \
                if protocol == "cassandra" \
                else m.ClickhouseWire(endpoint=f"127.0.0.1:{srv.port}")
            db.connect()
            db.exec("CREATE TABLE fuzz (i INTEGER, v TEXT)")
            for i, value in enumerate(ALL):
                db.exec("INSERT INTO fuzz VALUES (?, ?)", i, value)
            read = db.query if protocol == "cassandra" else db.select
            assert [r["v"] for r in read(
                "SELECT i, v FROM fuzz ORDER BY i")] == ALL
            db.close()
    elif protocol == "mongo":
        with started(m.MiniMongoServer()) as srv:
            db = m.MongoWire(host="127.0.0.1", port=srv.port)
            db.connect()
            for i, value in enumerate(ALL):
                db.insert_one("fuzz", {"i": i, "v": value})
            assert [db.find_one("fuzz", {"i": i})["v"]
                    for i in range(len(ALL))] == ALL
            db.close()
    else:
        with started(m.MiniDynamoServer()) as srv:
            kv = m.DynamoKV(endpoint=f"127.0.0.1:{srv.port}", table="t",
                            access_key="test", secret_key="secret")
            for i, value in enumerate(ALL):
                kv.set(f"k{i}", value)
            assert [kv.get(f"k{i}") for i in range(len(ALL))] == ALL


# --------------------------------------------------------------- metrics
def _one_op(protocol: str, m):
    """(a started Mini server, its client, one operation, the client's
    histogram)."""
    if protocol == "mongo":
        srv = m.MiniMongoServer()
        srv.start()
        return (srv, m.MongoWire(host="127.0.0.1", port=srv.port),
                lambda c: c.insert_one("c", {"a": 1}), "app_mongo_stats")
    if protocol in ("cassandra", "scylla"):
        srv = m.MiniCassandraServer()
        srv.start()
        cls = m.CassandraWire if protocol == "cassandra" else m.ScyllaWire
        return (srv, cls(host="127.0.0.1", port=srv.port),
                lambda c: c.query("SELECT 1 AS one"),
                f"app_{protocol}{'db' if protocol == 'scylla' else ''}_stats")
    if protocol == "couchbase":
        srv = m.MiniCouchbaseServer(username="u", password="p")
        srv.start()
        return (srv, m.CouchbaseWire(
            host="127.0.0.1", kv_port=srv.kv_port,
            query_endpoint=f"127.0.0.1:{srv.query_port}", username="u",
            password="p"), lambda c: c.upsert("b", "k", {"a": 1}),
            "app_couchbase_stats")
    if protocol == "surreal":
        srv = m.MiniSurrealServer()
        srv.start()
        return (srv, m.SurrealWire(endpoint=f"ws://127.0.0.1:{srv.port}/rpc",
                                   username="", password=""),
                lambda c: c.query("t", {}), "app_surrealdb_stats")
    made = {
        "clickhouse": lambda: (m.MiniClickhouseServer, lambda e: m.ClickhouseWire(
            endpoint=e), lambda c: c.select("SELECT 1 AS one"),
            "app_clickhouse_stats"),
        "es": lambda: (m.MiniESServer, lambda e: m.ElasticsearchWire(endpoint=e),
               lambda c: c.index("i", "1", {"a": 1}),
               "app_elasticsearch_stats"),
        "solr": lambda: (m.MiniSolrServer, lambda e: m.SolrWire(endpoint=e),
                 lambda c: c.add("c", [{"id": "1"}]), "app_solr_stats"),
        "s3": lambda: (m.MiniS3Server, lambda e: m.S3Wire(
            endpoint=e, access_key="test", secret_key="secret"),
               lambda c: c.create_bucket(), "app_s3_stats"),
        "dynamo": lambda: (m.MiniDynamoServer, lambda e: m.DynamoKV(
            endpoint=e, table="t", access_key="test", secret_key="secret"), lambda c: c.set("k", "v"),
            "app_kv_stats"),
        "gcs": lambda: (m.MiniGCSServer, lambda e: m.GCSWire(endpoint=e),
                lambda c: c.upload("k", b"v"), "app_gcs_stats"),
        "azure_blob": lambda: (lambda: m.MiniAzureBlobServer(key_b64=AZ_KEY),
                       lambda e: m.AzureBlobWire(endpoint=e, key_b64=AZ_KEY),
                       lambda c: c.upload_blob("k", b"v"),
                       "app_azure_blob_stats"),
        "influx": lambda: (m.MiniInfluxServer, lambda e: m.InfluxWire(url=e),
                   lambda c: c.create_bucket("b"), "app_influxdb_stats"),
        "opentsdb": lambda: (m.MiniOpenTSDBServer, lambda e: m.OpenTSDBWire(
            endpoint=e), lambda c: c.put_data_points(
            [{"metric": "m", "timestamp": 1, "value": 1.0}]),
            "app_opentsdb_stats"),
        "dgraph": lambda: (m.MiniDgraphServer, lambda e: m.DgraphWire(endpoint=e),
                   lambda c: c.mutate({"name": "a"}), "app_dgraph_stats"),
        "arango": lambda: (m.MiniArangoServer, lambda e: m.ArangoWire(endpoint=e),
                   lambda c: c.create_document("c", {"a": 1}),
                   "app_arangodb_stats")}
    server_cls, make, op, metric = made[protocol]()
    srv = server_cls()
    srv.start()
    return srv, make(f"127.0.0.1:{srv.port}"), op, metric


@pytest.mark.parametrize("protocol", list(SESSIONS) + ["scylla"])
def test_wire_clients_record_their_histogram(protocol):
    """One operation through each wire client with a container's metrics
    attached lands one sample in the histogram JAX's client writes
    (``app_<store>_stats``; DynamoKV writes the KV stores' ``app_kv_stats``,
    which the framework registers)."""
    import importlib

    scrapes = {}
    for side in ("port", "jax"):
        m = Pair("cassandra" if protocol == "scylla" else protocol,
                 (side, "port"))
        package = "gofr_tpu_torch" if side == "port" else "gofr_tpu"
        container = importlib.import_module(
            f"{package}.container.container").Container.create(
            importlib.import_module(f"{package}.config.env").DictConfig({}))
        srv, client, op, metric = _one_op(protocol, m)
        try:
            client.use_metrics(container.metrics)
            client.connect()
            op(client)
            client.close()
            scrapes[side] = sum(series["count"] for series in
                                container.metrics.get(metric).snapshot()[
                                    "series"])
        finally:
            srv.close()
    assert scrapes == {"port": 1, "jax": 1}


# ------------------------------------------------------------ migrations
def _wire_migrate(pair) -> dict:
    """Versions 1-2 through the client side's ``migrations.run`` with the
    client side's container holding Cassandra, ClickHouse and Mongo wire
    clients on the server side's Mini servers; a second run applies
    nothing; a version 3 that raises leaves no ledger row. -> the applied
    versions and each store's ledger and data."""
    import importlib

    cql, chs, mgo = Pair("cassandra", pair), Pair("clickhouse", pair), \
        Pair("mongo", pair)
    package = "gofr_tpu_torch" if pair[0] == "port" else "gofr_tpu"
    mig = importlib.import_module(f"{package}.migrations")
    container = importlib.import_module(
        f"{package}.container.container").Container(
        config=importlib.import_module(f"{package}.config.env").DictConfig(
            {}))

    def v1(ds):
        ds.cassandra.exec("CREATE TABLE answers (id TEXT PRIMARY KEY, "
                          "n INTEGER)")
        ds.clickhouse.exec("CREATE TABLE tokens (id TEXT, n INTEGER)")
        ds.mongo.insert_one("schema", {"_id": "answers", "v": 1})

    def v2(ds):
        ds.cassandra.exec("INSERT INTO answers (id, n) VALUES (?, ?)",
                          "a", 64)
        ds.clickhouse.exec("INSERT INTO tokens VALUES (?, ?)", "a", 64)

    def v3(ds):
        raise RuntimeError("version 3 fails")

    with started(cql.MiniCassandraServer()) as c_srv, \
            started(chs.MiniClickhouseServer()) as h_srv, \
            started(mgo.MiniMongoServer()) as m_srv:
        container.cassandra = cql.CassandraWire(host="127.0.0.1",
                                                port=c_srv.port)
        container.clickhouse = chs.ClickhouseWire(
            endpoint=f"127.0.0.1:{h_srv.port}")
        container.mongo = mgo.MongoWire(host="127.0.0.1", port=m_srv.port,
                                        database="app")
        for store in (container.cassandra, container.clickhouse,
                      container.mongo):
            store.connect()
        migrations = {1: mig.Migrate(up=v1), 2: mig.Migrate(up=v2)}
        first = mig.run(container, migrations)
        again = mig.run(container, migrations)
        with pytest.raises(RuntimeError):
            mig.run(container, {**migrations, 3: mig.Migrate(up=v3)})
        ledger = "SELECT version FROM gofr_migrations ORDER BY version"
        out = {"first": first, "again": again,
               "cql": [r["version"] for r in
                       container.cassandra.query(ledger)],
               "clickhouse": [r["version"] for r in
                              container.clickhouse.select(ledger)],
               "mongo": sorted(d["version"] for d in
                               container.mongo.find("gofr_migrations")),
               "answers": container.cassandra.query(
                   "SELECT id, n FROM answers"),
               "tokens": container.clickhouse.select(
                   "SELECT id, n FROM tokens"),
               "schema": container.mongo.find("schema")}
        container.cassandra.close()
        container.mongo.close()
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_migrations_over_the_wire(pair):
    """``migrations.run`` keeps a ledger in each of the Cassandra,
    ClickHouse and Mongo wire stores: versions 1-2 once, none the second
    time, a failing version 3 recorded nowhere; the same ledgers and data
    as JAX's runner with JAX's clients on JAX's servers."""
    got = _wire_migrate(pair)
    assert got == _wire_migrate(("jax", "jax"))
    assert (got["first"], got["again"]) == ([1, 2], [])
    assert got["cql"] == got["clickhouse"] == got["mongo"] == [1, 2]
    assert got["answers"] == got["tokens"] == [{"id": "a", "n": 64}]


# ------------------------------------------------------- the handler pool
def _store_race_app(stores: dict):
    """A port app whose plain ``GET /race/{i}`` handler meets 31 others
    at a barrier, then keeps a document through ``ctx.mongo`` and a row
    through ``ctx.cassandra`` and reads both back."""
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig

    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
    app.container.add_mongo(stores["mongo"])
    app.container.add_cassandra(stores["cassandra"])
    app.container.cassandra.exec("CREATE TABLE item (id INTEGER PRIMARY "
                                 "KEY, sq INTEGER, note TEXT)")
    barrier = threading.Barrier(32)

    @app.get("/race/{i}")
    def race(ctx):
        i = int(ctx.path_param("i"))
        barrier.wait(30)
        ctx.mongo.insert_one("docs", {"_id": f"d{i}", "i": i, "sq": i * i})
        ctx.cassandra.exec("INSERT INTO item (id, sq, note) VALUES "
                           "(?, ?, ?)", i, i * i, "n" * i)
        doc = ctx.mongo.find_one("docs", {"_id": f"d{i}"})
        row = ctx.cassandra.query("SELECT id, sq, note FROM item WHERE "
                                  "id = ?", i)[0]
        return {"doc": [doc["_id"], doc["i"], doc["sq"]],
                "row": [row["id"], row["sq"], row["note"]]}
    return app


def _store_race(app) -> tuple:
    import http.client
    import json
    import threading

    from .torch_parity import AppThread

    answers: list = [None] * 32

    def call(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("GET", f"/race/{i}")
            resp = conn.getresponse()
            answers[i] = (resp.status, json.loads(resp.read()))
        finally:
            conn.close()

    with AppThread(app) as t:
        port = t.port
        callers = [threading.Thread(target=call, args=(i,))
                   for i in range(32)]
        for c in callers:
            c.start()
        for c in callers:
            c.join(60)
        counts = (app.container.mongo.count_documents("docs"),
                  app.container.cassandra.query(
                      "SELECT COUNT(*) AS n FROM item")[0]["n"])
    return answers, counts


def test_plain_handlers_share_the_store_wire_clients():
    """32 plain handlers on the app's pool use ``ctx.mongo`` over OP_MSG
    and ``ctx.cassandra`` over CQL at once (a barrier lines them up):
    every answer equals the in-process stores' app's, the sockets stay in
    step (the counts after the race are read on them), and ``App.stop``
    closes both clients: the Mini servers hold no connection after it."""
    from gofr_tpu_torch.datasource.cassandra_wire import (CassandraWire,
                                                          MiniCassandraServer)
    from gofr_tpu_torch.datasource.columnar import Cassandra
    from gofr_tpu_torch.datasource.document import Mongo
    from gofr_tpu_torch.datasource.mongo_wire import (MiniMongoServer,
                                                      MongoWire)

    with started(MiniMongoServer()) as mg, \
            started(MiniCassandraServer()) as cq:
        got, got_counts = _store_race(_store_race_app({
            "mongo": MongoWire(host="127.0.0.1", port=mg.port),
            "cassandra": CassandraWire(host="127.0.0.1", port=cq.port)}))
        assert wait_until(lambda: server_connections(mg) == 0
                          and server_connections(cq) == 0, timeout=5)
    want, want_counts = _store_race(_store_race_app({
        "mongo": Mongo(), "cassandra": Cassandra()}))
    assert got == want
    assert want == [(200, {"data": {"doc": [f"d{i}", i, i * i],
                                    "row": [i, i * i, "n" * i]}})
                    for i in range(32)]
    assert got_counts == want_counts == (32, 32)
