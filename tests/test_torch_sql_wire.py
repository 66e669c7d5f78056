"""The port's SQL wire clients and Mini servers (``datasource/
postgres_wire.py``, ``mysql_wire.py``, ``oracle_wire.py``) against the JAX
package's: every case of the JAX tests of each module runs three ways,
the port's client on the port's server, the port's client on JAX's server
and JAX's client on the port's server (``torch_wire.PAIRS``), with real
protocol bytes over loopback sockets. Then one scripted session per
protocol gives the same rows, counts and typed errors in both cross
directions as JAX's client on JAX's server; the port's AES-CBC equals
``cryptography``'s; and 32 plain handlers of the port's app hit
``ctx.sql`` over the Postgres wire and ``ctx.redis`` over RESP at once,
answering as the sqlite / embedded app does.
"""

from dataclasses import dataclass

import pytest

from .torch_wire import PAIR_IDS, PAIRS, Pair


class TestPostgres:
    """``postgres_wire``: the v3 protocol, MD5 / SCRAM / cleartext auth."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("postgres", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniPostgresServer(user="app", password="s3cr3t", auth="md5")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def db(self, m, server):
        c = m.PostgresWire(host="127.0.0.1", port=server.port,
                           user="app", password="s3cr3t", database="appdb")
        c.connect()
        yield c
        c.close()

    def test_startup_and_parameter_status(self, m, db):
        assert db.server_params["server_version"].startswith("16")


    def test_simple_query_roundtrip(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_simple (id INTEGER, name TEXT)")
        db.exec("DELETE FROM t_simple")
        db.exec("INSERT INTO t_simple VALUES (1, 'ada'), (2, 'grace')")
        rows = db.query("SELECT id, name FROM t_simple ORDER BY id")
        assert [(r["id"], r["name"]) for r in rows] == \
            [(1, "ada"), (2, "grace")]
        assert db.query_row("SELECT name FROM t_simple WHERE id = 2")["name"] \
            == "grace"


    def test_extended_query_with_dollar_params(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_ext "
                "(id INTEGER, score REAL, blob BLOB, note TEXT)")
        db.exec("DELETE FROM t_ext")
        res = db.exec("INSERT INTO t_ext VALUES ($1, $2, $3, $4)",
                      7, 2.5, b"\x00\xff", "hi there")
        assert res.rowcount == 1
        row = db.query_row("SELECT * FROM t_ext WHERE id = $1", 7)
        assert row["score"] == 2.5
        assert row["blob"] == b"\x00\xff"
        assert row["note"] == "hi there"
        # NULL params travel as -1 length
        db.exec("INSERT INTO t_ext VALUES ($1, $2, $3, $4)",
                8, None, None, None)
        row = db.query_row("SELECT score, note FROM t_ext WHERE id = $1", 8)
        assert row["score"] is None and row["note"] is None


    def test_out_of_range_param_is_protocol_error(self, m, db):
        """$N beyond the bound count is an ErrorResponse, not a torn
        connection."""
        with pytest.raises(m.PostgresError):
            db.query("SELECT $2 AS x", 1)
        assert db.query_row("SELECT 3 AS ok")["ok"] == 3  # stream intact


    def test_param_reuse_order(self, m, db):
        """$N placeholders bind by number, not appearance order."""
        row = db.query_row("SELECT $2 AS a, $1 AS b, $2 AS c", 10, 20)
        assert (row["a"], row["b"], row["c"]) == (20, 10, 20)


    def test_exec_rowcount_tags(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_tags (id INTEGER)")
        db.exec("DELETE FROM t_tags")
        assert db.exec("INSERT INTO t_tags VALUES (1), (2), (3)").rowcount == 3
        assert db.exec("UPDATE t_tags SET id = id + 10").rowcount == 3
        assert db.exec("DELETE FROM t_tags WHERE id > 11").rowcount == 2


    def test_transaction_commit_and_rollback(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_tx (id INTEGER)")
        db.exec("DELETE FROM t_tx")
        with db.begin() as tx:
            tx.exec("INSERT INTO t_tx VALUES ($1)", 1)
        assert len(db.query("SELECT * FROM t_tx")) == 1
        with pytest.raises(RuntimeError):
            with db.begin() as tx:
                tx.exec("INSERT INTO t_tx VALUES ($1)", 2)
                raise RuntimeError("boom")
        assert len(db.query("SELECT * FROM t_tx")) == 1  # rolled back


    def test_error_response_and_recovery(self, m, db):
        with pytest.raises(m.PostgresError) as exc:
            db.query("SELECT * FROM no_such_table")
        assert exc.value.sqlstate
        # the connection survives an error cycle
        assert db.query_row("SELECT 1 AS one")["one"] == 1
        # extended-cycle error also recovers (server skips to Sync)
        with pytest.raises(m.PostgresError):
            db.query("SELECT * FROM no_such_table WHERE id = $1", 1)
        assert db.query_row("SELECT 2 AS two")["two"] == 2


    def test_select_orm_lite(self, m, db):
        @dataclass
        class Person:
            id: int
            name: str

        db.exec("CREATE TABLE IF NOT EXISTS people (id INTEGER, name TEXT)")
        db.exec("DELETE FROM people")
        db.exec("INSERT INTO people VALUES ($1, $2)", 1, "ada")
        people = db.select(Person, "SELECT id, name FROM people")
        assert people == [Person(1, "ada")]


    def test_md5_wrong_password_rejected(self, m, server):
        bad = m.PostgresWire(host="127.0.0.1", port=server.port,
                           user="app", password="WRONG")
        with pytest.raises(m.PostgresError, match="authentication"):
            bad.connect()


    def test_unknown_user_rejected(self, m, server):
        bad = m.PostgresWire(host="127.0.0.1", port=server.port,
                           user="nobody", password="s3cr3t")
        with pytest.raises(m.PostgresError):
            bad.connect()


    def test_cleartext_auth(self, m):
        srv = m.MiniPostgresServer(user="u", password="pw", auth="password")
        srv.start()
        try:
            c = m.PostgresWire(host="127.0.0.1", port=srv.port,
                             user="u", password="pw")
            c.connect()
            assert c.query_row("SELECT 1 AS x")["x"] == 1
            c.close()
        finally:
            srv.close()


    def test_scram_sha256_auth_and_mutual_verification(self, m):
        srv = m.MiniPostgresServer(user="u", password="pw",
                                   auth="scram-sha-256")
        srv.start()
        try:
            c = m.PostgresWire(host="127.0.0.1", port=srv.port,
                             user="u", password="pw")
            c.connect()  # raises if the server's signature fails to verify
            assert c.query_row("SELECT 42 AS v")["v"] == 42
            c.close()
            bad = m.PostgresWire(host="127.0.0.1", port=srv.port,
                               user="u", password="nope")
            with pytest.raises(m.PostgresError, match="authentication"):
                bad.connect()
        finally:
            srv.close()


    def test_env_driven_container_swap(self, m, server):
        """DB_DIALECT=postgres + DB_HOST dials the wire client through the
        same new_sql entry the container uses (reference sql.go:74)."""
        DictConfig = m.side("config.env").DictConfig
        new_sql = m.side("datasource.sql").new_sql

        cfg = DictConfig({"DB_DIALECT": "postgres",
                         "DB_HOST": "127.0.0.1",
                         "DB_PORT": str(server.port),
                         "DB_USER": "app", "DB_PASSWORD": "s3cr3t",
                         "DB_NAME": "appdb"})
        db = new_sql(cfg)
        assert isinstance(db, m.PostgresWire)
        assert db.query_row("SELECT 5 AS five")["five"] == 5
        assert db.health_check()["status"] == "UP"
        db.close()


    def test_dollar_inside_string_literal_is_not_a_param(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_lit (note TEXT)")
        db.exec("DELETE FROM t_lit")
        db.exec("INSERT INTO t_lit VALUES ('costs $15')")
        assert db.query_row("SELECT note FROM t_lit")["note"] == "costs $15"


    def test_null_in_first_row_keeps_numeric_oid(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_null (score REAL)")
        db.exec("DELETE FROM t_null")
        db.exec("INSERT INTO t_null VALUES (NULL), (2.5)")
        rows = db.query("SELECT score FROM t_null ORDER BY score")
        assert rows[0]["score"] is None
        assert rows[1]["score"] == 2.5  # float, not the string "2.5"


    def test_transactions_are_per_connection(self, m, server):
        """Client A's open BEGIN must not swallow client B's insert —
        postgres transactions are per-connection."""
        a = m.PostgresWire(host="127.0.0.1", port=server.port,
                         user="app", password="s3cr3t")
        b = m.PostgresWire(host="127.0.0.1", port=server.port,
                         user="app", password="s3cr3t")
        a.connect()
        b.connect()
        try:
            a.exec("CREATE TABLE IF NOT EXISTS t_iso (id INTEGER)")
            a.exec("DELETE FROM t_iso")
            a.exec("BEGIN")
            a.exec("INSERT INTO t_iso VALUES (1)")
            import threading
            done = threading.Event()

            def other():
                b.exec("INSERT INTO t_iso VALUES (2)")  # blocks until A ends
                done.set()

            t = threading.Thread(target=other, daemon=True)
            t.start()
            a.exec("ROLLBACK")  # A's insert is discarded...
            assert done.wait(10)
            t.join(10)
            rows = a.query("SELECT id FROM t_iso")
            # ...while B's, committed after A released, survives
            assert [r["id"] for r in rows] == [2]
        finally:
            a.close()
            b.close()


    def test_health_check(self, m, db):
        assert db.health_check()["status"] == "UP"
        loose = m.PostgresWire(host="127.0.0.1", port=1, user="x")
        assert loose.health_check()["status"] == "DOWN"


class TestMySQL:
    """``mysql_wire``: the v10 handshake, native-password auth, COM_QUERY."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("mysql", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniMySQLServer(user="app", password="s3cr3t")
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def db(self, m, server):
        c = m.MySQLWire(host="127.0.0.1", port=server.port,
                        user="app", password="s3cr3t", database="appdb")
        c.connect()
        yield c
        c.close()

    def test_handshake_and_version(self, m, db):
        assert db.server_version.startswith("8.0")


    def test_query_roundtrip(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_my (id INTEGER, name TEXT)")
        db.exec("DELETE FROM t_my")
        res = db.exec("INSERT INTO t_my VALUES (?, ?), (?, ?)",
                      1, "ada", 2, "grace")
        assert res.rowcount == 2
        rows = db.query("SELECT id, name FROM t_my ORDER BY id")
        # typed decode from the column-definition type bytes
        assert [(r["id"], r["name"]) for r in rows] \
            == [(1, "ada"), (2, "grace")]
        assert db.query_row("SELECT name FROM t_my WHERE id = ?", 2)["name"] \
            == "grace"


    def test_null_and_escaping(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_esc (v TEXT)")
        db.exec("DELETE FROM t_esc")
        tricky = "o'brien\\path\nline2"
        db.exec("INSERT INTO t_esc VALUES (?)", tricky)
        assert db.query("SELECT v FROM t_esc")[0]["v"] == tricky
        db.exec("INSERT INTO t_esc VALUES (?)", None)
        values = [r["v"] for r in db.query("SELECT v FROM t_esc")]
        assert None in values


    def test_qmark_expansion_rules(self, m):
        assert m.expand_qmarks("SELECT 'a?b', ?", (1,)) == "SELECT 'a?b', 1"
        assert m.escape_literal(b"\xbe\xef") == "x'beef'"
        with pytest.raises(m.MySQLError):
            m.expand_qmarks("SELECT ?", ())
        with pytest.raises(m.MySQLError):
            m.expand_qmarks("SELECT 1", (5,))
        # '?' inside comments and backtick identifiers is not a placeholder
        assert m.expand_qmarks("SELECT `a?b`, ? -- ok?\n", (1,)) \
            == "SELECT `a?b`, 1 -- ok?\n"
        assert m.expand_qmarks("SELECT /* hm? */ ?", (2,)) \
            == "SELECT /* hm? */ 2"
        assert m.expand_qmarks("SELECT ? # tail?", (3,)) == "SELECT 3 # tail?"


    def test_transactions(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS t_tx (id INTEGER)")
        db.exec("DELETE FROM t_tx")
        with db.begin() as tx:
            tx.exec("INSERT INTO t_tx VALUES (?)", 1)
        assert len(db.query("SELECT * FROM t_tx")) == 1
        with pytest.raises(RuntimeError):
            with db.begin() as tx:
                tx.exec("INSERT INTO t_tx VALUES (?)", 2)
                raise RuntimeError("boom")
        assert len(db.query("SELECT * FROM t_tx")) == 1


    def test_error_packet_and_recovery(self, m, db):
        with pytest.raises(m.MySQLError) as exc:
            db.query("SELECT * FROM missing_table")
        assert exc.value.code == 1064 and exc.value.sqlstate == "42000"
        assert db.query_row("SELECT 1 AS one")["one"] == 1


    def test_select_orm_lite_coerces(self, m, db):
        @dataclass
        class Person:
            id: int
            name: str

        db.exec("CREATE TABLE IF NOT EXISTS people_my (id INTEGER, name TEXT)")
        db.exec("DELETE FROM people_my")
        db.exec("INSERT INTO people_my VALUES (?, ?)", 1, "ada")
        assert db.select(Person, "SELECT id, name FROM people_my") \
            == [Person(1, "ada")]


    def test_wrong_password_rejected(self, m, server):
        bad = m.MySQLWire(host="127.0.0.1", port=server.port,
                        user="app", password="WRONG")
        with pytest.raises(m.MySQLError) as exc:
            bad.connect()
        assert exc.value.code == 1045


    def test_env_driven_container_swap(self, m, server):
        DictConfig = m.side("config.env").DictConfig
        new_sql = m.side("datasource.sql").new_sql

        cfg = DictConfig({"DB_DIALECT": "mysql", "DB_HOST": "127.0.0.1",
                          "DB_PORT": str(server.port), "DB_USER": "app",
                          "DB_PASSWORD": "s3cr3t", "DB_NAME": "appdb"})
        db = new_sql(cfg)
        assert isinstance(db, m.MySQLWire)
        assert db.health_check()["status"] == "UP"
        db.close()


    def test_health(self, m, db):
        assert db.health_check()["status"] == "UP"
        assert m.MySQLWire(host="127.0.0.1", port=1).health_check()["status"] \
            == "DOWN"


class TestOracle:
    """``oracle_wire``: TNS framing, O5LOGON-style auth (the port's AES
    written in the module), ORA-coded errors."""

    @pytest.fixture(scope="class", params=PAIRS, ids=PAIR_IDS)
    def m(self, request):
        return Pair("oracle", request.param)

    @pytest.fixture(scope="class")
    def server(self, m):
        srv = m.MiniOracleServer(service_name="FREEPDB1",
                                 users={"app": "tiger"})
        srv.start()
        yield srv
        srv.close()

    @pytest.fixture()
    def db(self, m, server):
        wire = m.OracleWire(port=server.port, service_name="FREEPDB1",
                            username="app", password="tiger")
        wire.connect()
        yield wire
        wire.close()

    def test_connect_ping_dual(self, m, db):
        db.ping()
        row = db.query_row("SELECT 1 AS N FROM DUAL")
        assert row["N"] == "1"


    def test_ddl_dml_binds_roundtrip(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS emp (id INTEGER, name TEXT)")
        db.exec("DELETE FROM emp")
        assert db.exec("INSERT INTO emp (id, name) VALUES (:1, :2)",
                       1, "scott") == 1
        db.exec("INSERT INTO emp (id, name) VALUES (:1, :2)", 2, "king")
        rows = db.query("SELECT id, name FROM emp WHERE id > :1 "
                        "ORDER BY id", 0)
        assert [(r["ID"], r["NAME"]) for r in rows] == [("1", "scott"),
                                                        ("2", "king")]


    def test_select_into_dataclass(self, m, db):
        @dataclass
        class Emp:
            id: str
            name: str

        db.exec("CREATE TABLE IF NOT EXISTS emp2 (id INTEGER, name TEXT)")
        db.exec("INSERT INTO emp2 (id, name) VALUES (:1, :2)", 7, "adams")
        got = db.select(Emp, "SELECT id, name FROM emp2 WHERE id = :1", 7)
        assert got == [Emp(id="7", name="adams")]


    def test_transaction_commit_and_rollback(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS acct (id INTEGER, bal INTEGER)")
        db.exec("DELETE FROM acct")
        with db.begin() as tx:
            tx.exec("INSERT INTO acct (id, bal) VALUES (:1, :2)", 1, 100)
        assert db.query_row("SELECT COUNT(*) AS C FROM acct")["C"] == "1"
        with pytest.raises(RuntimeError):
            with db.begin() as tx:
                tx.exec("INSERT INTO acct (id, bal) VALUES (:1, :2)", 2, 200)
                raise RuntimeError("boom")
        assert db.query_row("SELECT COUNT(*) AS C FROM acct")["C"] == "1"


    def test_sql_error_is_ora_coded_after_break_marker(self, m, db):
        with pytest.raises(m.OracleError) as e:
            db.query("SELECT * FROM no_such_table_anywhere")
        assert e.value.code == 900          # ORA-00900 invalid SQL statement
        db.ping()                           # marker/reset left session usable


    def test_wrong_password_ora_01017(self, m, server):
        bad = m.OracleWire(port=server.port, username="app", password="WRONG")
        with pytest.raises(m.OracleError) as e:
            bad.connect()
        assert e.value.code == 1017


    def test_unknown_service_refused(self, m, server):
        lost = m.OracleWire(port=server.port, service_name="NOPE",
                          username="app", password="tiger")
        with pytest.raises(m.OracleError) as e:
            lost.connect()
        assert "12514" in str(e.value)


    def test_null_values(self, m, db):
        db.exec("CREATE TABLE IF NOT EXISTS nt (id INTEGER, v TEXT)")
        db.exec("INSERT INTO nt (id, v) VALUES (:1, :2)", 1, None)
        row = db.query_row("SELECT v FROM nt WHERE id = :1", 1)
        assert row["V"] is None


    def test_health_check(self, m, db, server):
        assert db.health_check()["status"] == "UP"
        assert m.OracleWire(port=1, timeout_s=0.5).health_check()["status"] \
            == "DOWN"


    def test_survives_byte_dribble(self, m, server):
        """Full TNS stack (CONNECT/RESEND/ACCEPT, auth, DATA frames) over
        1-byte fragments."""
        from .test_wire_fragmentation import DribbleProxy

        proxy = DribbleProxy("127.0.0.1", server.port)
        try:
            wire = m.OracleWire(port=proxy.port, username="app",
                              password="tiger", timeout_s=60)
            wire.connect()
            wire.exec("CREATE TABLE IF NOT EXISTS frag (x INTEGER)")
            wire.exec("INSERT INTO frag (x) VALUES (:1)", 42)
            assert wire.query_row("SELECT x FROM frag")["X"] == "42"
            wire.close()
        finally:
            proxy.close()


    def test_env_driven_selection(self, m, server):
        """DB_DIALECT=oracle + DB_HOST dials the TNS wire client through
        the same env path postgres/mysql use (reference sql.go:74)."""
        DictConfig = m.side("config.env").DictConfig
        new_sql = m.side("datasource.sql").new_sql

        db = new_sql(DictConfig({
            "DB_DIALECT": "oracle", "DB_HOST": "127.0.0.1",
            "DB_PORT": str(server.port), "DB_NAME": "FREEPDB1",
            "DB_USER": "app", "DB_PASSWORD": "tiger"}))
        assert isinstance(db, m.OracleWire)
        assert db.query_row("SELECT 1 AS ONE FROM DUAL")["ONE"] == "1"
        db.close()


    def test_env_selection_degrades_gracefully(self, m):
        """Misconfiguration degrades (None + log), never crashes boot."""
        DictConfig = m.side("config.env").DictConfig
        new_sql = m.side("datasource.sql").new_sql

        # oracle without DB_HOST: explicit message, not "unsupported dialect"
        assert new_sql(DictConfig({"DB_DIALECT": "oracle"})) is None
        # malformed port: degrade like the postgres/mysql path
        assert new_sql(DictConfig({"DB_DIALECT": "oracle",
                                   "DB_HOST": "127.0.0.1",
                                   "DB_PORT": "1521x"})) is None


    def test_auto_crud_over_oracle(self, m, server):
        """add_rest_handlers works with the Oracle wire client as the
        container's sql slot of the client side's app: :n placeholders,
        uppercase column mapping."""
        import http.client
        import json as _json

        from .torch_parity import AppThread

        cfg = m.side("config.env").DictConfig({
            "APP_NAME": "crud-ora", "HTTP_PORT": "0", "METRICS_PORT": "0",
            "GOFR_TELEMETRY": "false", "DB_DIALECT": "oracle",
            "DB_HOST": "127.0.0.1", "DB_PORT": str(server.port),
            "DB_NAME": "FREEPDB1", "DB_USER": "app",
            "DB_PASSWORD": "tiger"})

        @dataclass
        class Book:
            id: int
            title: str

        app = m.side("app").App(config=cfg)
        app.container.sql.exec(
            "CREATE TABLE IF NOT EXISTS book (id INTEGER, title TEXT)")
        app.container.sql.exec("DELETE FROM book")
        m.side("crud").add_rest_handlers(app, Book)

        def request(port, method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=20)
            try:
                conn.request(method, path, body=None if body is None
                             else _json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        with AppThread(app) as t:
            status, data = request(t.port, "POST", "/book",
                                   {"id": 1, "title": "TNS"})
            assert status == 201, data
            status, data = request(t.port, "GET", "/book")
            assert status == 200
            rows = _json.loads(data)["data"]
            assert rows == [{"id": "1", "title": "TNS"}] or \
                rows == [{"id": 1, "title": "TNS"}], rows


# ------------------------------------------------------ scripted sessions
def _session_ends(protocol: str, m, password: str):
    """(server, client) of one protocol for a scripted session."""
    if protocol == "postgres":
        server = m.MiniPostgresServer(user="app", password="pw",
                                      auth="scram-sha-256")
        server.start()
        return server, m.PostgresWire(host="127.0.0.1", port=server.port,
                                      user="app", password=password,
                                      database="db")
    if protocol == "mysql":
        server = m.MiniMySQLServer(user="app", password="pw")
        server.start()
        return server, m.MySQLWire(host="127.0.0.1", port=server.port,
                                   user="app", password=password,
                                   database="db")
    server = m.MiniOracleServer(users={"app": "pw"})
    server.start()
    return server, m.OracleWire(port=server.port, username="app",
                                password=password)


def _sql_session(protocol: str, m) -> list:
    """One scripted session: DDL, bound inserts (NULLs among them), a
    select, a rolled-back transaction, a server error and a refused
    password, each step's outcome as plain values (typed errors by class
    name, code and message)."""
    def ph(n):
        return {"postgres": f"${n}", "mysql": "?"}.get(protocol, f":{n}")

    def outcome(fn):
        try:
            value = fn()
        except Exception as exc:  # noqa: BLE001 — the error is the outcome
            return ("error", type(exc).__name__, str(exc),
                    getattr(exc, "sqlstate", None),
                    getattr(exc, "code", None))
        if isinstance(value, list):
            return [dict(row) for row in value]
        return getattr(value, "rowcount", value)

    def rolled_back():
        with db.begin() as tx:
            tx.exec(f"INSERT INTO t (id, name, score) VALUES "
                    f"({ph(1)}, {ph(2)}, {ph(3)})", 3, "tx", 1.0)
            raise RuntimeError("roll back")

    server, db = _session_ends(protocol, m, "pw")
    try:
        db.connect()
        out = [outcome(lambda: db.exec(
            "CREATE TABLE t (id INTEGER, name TEXT, score REAL)"))]
        for row in ((1, "ada", 2.5), (2, None, None), (7, "o'brien", -1.25)):
            out.append(outcome(lambda row=row: db.exec(
                f"INSERT INTO t (id, name, score) VALUES "
                f"({ph(1)}, {ph(2)}, {ph(3)})", *row)))
        out.append(outcome(lambda: db.query(
            f"SELECT id, name, score FROM t WHERE id > {ph(1)} "
            "ORDER BY id", 0)))
        out.append(outcome(rolled_back))
        out.append(outcome(lambda: db.query("SELECT COUNT(*) AS n FROM t")))
        out.append(outcome(lambda: db.query("SELECT * FROM missing")))
        out.append(outcome(lambda: db.query("SELECT 1 AS one")))
        db.close()
        refused = {"postgres": lambda: m.PostgresWire(
                       host="127.0.0.1", port=server.port, user="app",
                       password="wrong", database="db"),
                   "mysql": lambda: m.MySQLWire(
                       host="127.0.0.1", port=server.port, user="app",
                       password="wrong", database="db")}.get(
            protocol, lambda: m.OracleWire(port=server.port, username="app",
                                           password="wrong"))()
        out.append(outcome(refused.connect))
        return out
    finally:
        server.close()


@pytest.mark.parametrize("direction", PAIRS[1:], ids=PAIR_IDS[1:])
@pytest.mark.parametrize("protocol", ["postgres", "mysql", "oracle"])
def test_cross_session_matches_jax(protocol, direction):
    """The port's client on JAX's server, and JAX's client on the port's,
    return what JAX's client on JAX's server returns: the same rows,
    counts and typed errors (a missing table, a refused password)."""
    want = _sql_session(protocol, Pair(protocol, ("jax", "jax")))
    got = _sql_session(protocol, Pair(protocol, direction))
    assert got == want
    assert want[-1][0] == "error" and want[-3][0] == "error"


def test_aes_cbc_equals_cryptography():
    """The port's AES-CBC (written in ``oracle_wire``) is FIPS-197's
    (the AES-192 known answer of its appendix C.2) and gives
    ``cryptography``'s bytes both ways, for every key size."""
    import numpy as np
    from cryptography.hazmat.primitives.ciphers import (Cipher, algorithms,
                                                        modes)
    from gofr_tpu_torch.datasource.oracle_wire import _aes_cbc

    key = bytes(range(24))
    plain = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert _aes_cbc(key, plain, encrypt=True).hex() == \
        "dda97ca4864cdfe06eaf70a0ec0d7191"
    rng = np.random.default_rng(0)
    for size in (16, 24, 32):
        for blocks in (1, 3, 6):
            key = rng.bytes(size)
            data = rng.bytes(16 * blocks)
            enc = Cipher(algorithms.AES(key),
                         modes.CBC(b"\0" * 16)).encryptor()
            want = enc.update(data) + enc.finalize()
            assert _aes_cbc(key, data, encrypt=True) == want
            assert _aes_cbc(key, want, encrypt=False) == data
    with pytest.raises(ValueError):
        _aes_cbc(key, b"short", encrypt=True)


# ------------------------------------------------------- the handler pool
def _race_app(env: dict):
    """A port app whose plain ``GET /race/{i}`` handler meets 31 others at
    a barrier, then writes and reads back a row through ``ctx.sql`` and a
    key through ``ctx.redis``."""
    import threading

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig

    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                                 **env}))
    app.container.sql.exec("CREATE TABLE item (id INTEGER, sq INTEGER, "
                           "note TEXT)")
    barrier = threading.Barrier(32)

    @app.get("/race/{i}")
    def race(ctx):
        i = int(ctx.path_param("i"))
        barrier.wait(30)
        sql, ph = ctx.sql, ctx.sql.ph
        sql.exec(f"INSERT INTO item (id, sq, note) VALUES "
                 f"({ph(1)}, {ph(2)}, {ph(3)})", i, i * i, "n" * i)
        row = sql.query_row(f"SELECT id, sq, note FROM item WHERE id = "
                            f"{ph(1)}", i)
        ctx.redis.set(f"k{i}", "v" * i)
        return {"row": [row["id"], row["sq"], row["note"]],
                "cached": ctx.redis.get(f"k{i}")}
    return app


def _race(app) -> tuple:
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
        count = app.container.sql.query_row(
            "SELECT COUNT(*) AS n FROM item")["n"]
    return answers, count


def test_plain_handlers_share_the_wire_clients(tmp_path):
    """32 plain handlers on the app's pool use ``ctx.sql`` over the
    Postgres wire and ``ctx.redis`` over RESP at once (a barrier lines
    them up): every answer equals the sqlite / embedded app's, and the
    connections stay in step (the row count after the race, and a
    statement after it, are read on the same sockets)."""
    from gofr_tpu_torch.datasource.postgres_wire import MiniPostgresServer
    from gofr_tpu_torch.datasource.redis_wire import MiniRedisServer

    pg, rd = MiniPostgresServer(user="app", password="pw"), MiniRedisServer()
    pg.start()
    rd.start()
    try:
        wire = _race_app({
            "DB_DIALECT": "postgres", "DB_HOST": "127.0.0.1",
            "DB_PORT": str(pg.port), "DB_USER": "app", "DB_PASSWORD": "pw",
            "DB_NAME": "db", "REDIS_HOST": "127.0.0.1",
            "REDIS_PORT": str(rd.port), "REDIS_MODE": "network"})
        got, got_count = _race(wire)
        embedded = _race_app({"DB_DIALECT": "sqlite",
                              "DB_NAME": str(tmp_path / "race.db"),
                              "REDIS_HOST": "localhost"})
        want, want_count = _race(embedded)
    finally:
        pg.close()
        rd.close()
    assert got == want
    assert want == [(200, {"data": {"row": [i, i * i, "n" * i],
                                    "cached": "v" * i}})
                    for i in range(32)]
    assert got_count == want_count == 32


# ------------------------------------------- fragmentation, hostile values
def _sql_pair_ends(protocol: str, m, port_of=lambda port: port):
    """A started Mini server of ``protocol`` (user ``u``, password ``p``)
    and a client dialling ``port_of(server.port)``."""
    if protocol == "postgres":
        server = m.MiniPostgresServer(user="u", password="p",
                                      auth="scram-sha-256")
        server.start()
        return server, m.PostgresWire(host="127.0.0.1",
                                      port=port_of(server.port),
                                      user="u", password="p")
    server = m.MiniMySQLServer(user="u", password="p")
    server.start()
    return server, m.MySQLWire(host="127.0.0.1", port=port_of(server.port),
                               user="u", password="p")


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("protocol", ["postgres", "mysql"])
def test_survives_byte_dribble(protocol, pair):
    """Auth (SCRAM, native password) and statements over a proxy that
    forwards one byte at a time, both ways."""
    from .test_wire_fragmentation import DribbleProxy

    m = Pair(protocol, pair)
    proxies: list = []

    def via_proxy(port):
        proxies.append(DribbleProxy("127.0.0.1", port))
        return proxies[-1].port
    server, db = _sql_pair_ends(protocol, m, via_proxy)
    ph = {"postgres": "$1, $2"}.get(protocol, "?, ?")
    try:
        db.connect()
        db.exec("CREATE TABLE t (a INTEGER, b TEXT)")
        db.exec(f"INSERT INTO t VALUES ({ph})", 7, "y" * 300)
        row = db.query_row("SELECT a, b FROM t")
        assert row["a"] == 7 and row["b"] == "y" * 300
        db.close()
    finally:
        proxies[0].close()
        server.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("protocol", ["postgres", "mysql"])
def test_roundtrip_matrix(protocol, pair):
    """Hostile strings (quotes, backslashes, placeholders, NULL-ish bytes,
    unicode) round-trip byte for byte as bound values."""
    from .test_wire_roundtrip_matrix import ALL

    server, db = _sql_pair_ends(protocol, Pair(protocol, pair))
    ph = {"postgres": "$1, $2"}.get(protocol, "?, ?")
    try:
        db.connect()
        db.exec("CREATE TABLE fuzz (i INTEGER, v TEXT)")
        for i, value in enumerate(ALL):
            db.exec(f"INSERT INTO fuzz VALUES ({ph})", i, value)
        assert [r["v"] for r in db.query(
            "SELECT v FROM fuzz ORDER BY i")] == ALL
        db.close()
    finally:
        server.close()


def test_migrations_over_oracle():
    """``App.migrate`` over the Oracle wire client applies a version once
    and none the second time: the ledger's ``MAX(version) AS v`` comes
    back as column ``V``, which the port reads case-blind. JAX's
    migrator reads ``row["v"]`` and raises ``KeyError`` (ROADMAP Queue C,
    C3)."""
    from gofr_tpu.container.container import Container as JaxContainer
    from gofr_tpu.config.env import DictConfig as JaxDictConfig
    from gofr_tpu.migrations import Migrate as JaxMigrate
    from gofr_tpu.migrations.runner import run as jax_run
    from gofr_tpu_torch.config.env import DictConfig
    from gofr_tpu_torch.container.container import Container
    from gofr_tpu_torch.datasource.oracle_wire import MiniOracleServer
    from gofr_tpu_torch.migrations import Migrate
    from gofr_tpu_torch.migrations.runner import run

    def up(ds):
        ds.sql.exec("CREATE TABLE book (id INTEGER, title TEXT)")

    server = MiniOracleServer(users={"app": "tiger"})
    server.start()
    env = {"DB_DIALECT": "oracle", "DB_HOST": "127.0.0.1",
           "DB_PORT": str(server.port), "DB_USER": "app",
           "DB_PASSWORD": "tiger"}
    try:
        c = Container.create(DictConfig(env))
        assert run(c, {1: Migrate(up=up)}) == [1]
        assert run(c, {1: Migrate(up=up)}) == []
        assert c.sql.query_row("SELECT COUNT(*) AS n FROM book")["N"] == "0"
        j = JaxContainer.create(JaxDictConfig(env))
        with pytest.raises(KeyError):
            jax_run(j, {1: JaxMigrate(up=up)})
    finally:
        server.close()


@pytest.mark.parametrize("protocol,metric", [
    ("postgres", "app_sql_stats"), ("mysql", "app_sql_stats"),
    ("oracle", "app_oracle_stats"), ("redis", "app_redis_stats")])
def test_wire_clients_record_their_histogram(protocol, metric):
    """One statement or command through each wire client with the
    container's metrics attached lands in the same histogram JAX's
    client writes (the framework registers ``app_sql_stats`` and
    ``app_redis_stats``; the Oracle client registers its own)."""
    import importlib

    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container.container import Container

    scrapes = {}
    for side in ("port", "jax"):
        m = Pair(protocol, (side, "port"))
        if protocol == "redis":
            server = m.MiniRedisServer()
            server.start()
            client = m.RedisWire(host="127.0.0.1", port=server.port)
        else:
            server, client = _session_ends(protocol, m, "pw")
        package = "gofr_tpu_torch" if side == "port" else "gofr_tpu"
        container = (Container if side == "port" else importlib.import_module(
            f"{package}.container.container").Container).create(
            (DictConfig if side == "port" else importlib.import_module(
                f"{package}.config.env").DictConfig)({}))
        try:
            client.use_metrics(container.metrics)
            client.connect()
            if protocol == "redis":
                client.set("k", "v")
            else:
                client.query("SELECT 1 AS one")
            client.close()
            scrapes[side] = sum(series["count"] for series in
                                container.metrics.get(metric).snapshot()[
                                    "series"])
        finally:
            server.close()
    assert scrapes == {"port": 1, "jax": 1}


@pytest.mark.parametrize("protocol", ["postgres", "mysql"])
def test_mini_servers_answer_without_a_delayed_ack_stall(protocol):
    """A reply of several small messages (row description, rows, command
    complete, ready) leaves the port's Mini server at once: it sets
    TCP_NODELAY, so Nagle does not hold the second message until the
    client's delayed ACK (~40 ms on Linux; JAX's Mini servers answer each
    statement that late on loopback, ROADMAP Queue C, C4). The median of
    21 statements stays under 10 ms."""
    import statistics
    import time

    server, db = _sql_pair_ends(protocol, Pair(protocol, ("port", "port")))
    ph = {"postgres": "$1"}.get(protocol, "?")
    try:
        db.connect()
        times = []
        for i in range(21):
            t0 = time.perf_counter()
            assert db.query_row(f"SELECT {ph} AS one", i)["one"] == i
            times.append(time.perf_counter() - t0)
        db.close()
    finally:
        server.close()
    assert statistics.median(times) < 0.010
