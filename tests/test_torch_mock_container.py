"""The port's mock container (``gofr_tpu_torch/container/mock.py``) against
the JAX package's: every case of ``tests/test_mock_container.py`` and the
three mock-container cases of ``tests/test_datasource_breadth.py`` run on
both packages (``S``), with the same results and typed errors; then the
same scripted expectations give the same messages, records and verdicts
on both.
"""

import dataclasses
import re

import pytest

from .torch_wire import Side as _Side

SIDES = ["port", "jax"]
#: the modules a side's names resolve from, in order
_MODULES = ("container.mock", "context", "config.env",
            "datasource.document", "datasource.graph")


def Side(side: str) -> _Side:
    return _Side(side, _MODULES)


@pytest.fixture(params=SIDES)
def S(request):
    return Side(request.param)


class TestCallRecorderExpectations:
    def test_expectation_matches_args_and_returns(self, S):
        rec = S.CallRecorder("redis")
        rec.expect_call("get").with_args("k1").returns("v1")
        rec.expect_call("get").with_args("k2").returns("v2")
        assert rec.get("k2") == "v2"
        assert rec.get("k1") == "v1"
        rec.verify()

    def test_unexpected_args_fail_immediately(self, S):
        rec = S.CallRecorder("redis")
        rec.expect_call("get").with_args("k1").returns("v1")
        with pytest.raises(S.ExpectationError, match="matching no open"):
            rec.get("other")

    def test_times_enforced_at_verify(self, S):
        rec = S.CallRecorder("svc")
        rec.expect_call("ping").times(2)
        rec.ping()
        with pytest.raises(S.ExpectationError, match="exactly 2x"):
            rec.verify()
        rec.ping()
        rec.verify()

    def test_times_cap_rejects_extra_calls(self, S):
        rec = S.CallRecorder("svc")
        rec.expect_call("ping").times(1)
        rec.ping()
        with pytest.raises(S.ExpectationError):
            rec.ping()

    def test_raises_expectation(self, S):
        rec = S.CallRecorder("kv")
        rec.expect_call("set").raises(RuntimeError("down"))
        with pytest.raises(RuntimeError, match="down"):
            rec.set("a", "b")

    def test_loose_mode_still_works_without_declarations(self, S):
        rec = S.CallRecorder("legacy")
        rec.expect("keys", ["a"])
        assert rec.keys() == ["a"]
        assert rec.calls_to("keys") == [((), {})]
        rec.verify()

    def test_at_least_once_default(self, S):
        rec = S.CallRecorder("svc")
        rec.expect_call("flush")
        with pytest.raises(S.ExpectationError, match="at least once"):
            rec.verify()


class TestSQLMock:
    def test_query_rows_and_ordering(self, S):
        m = S.SQLMock()
        m.expect_query(r"SELECT \* FROM users").returns(
            [{"id": 1, "name": "ada"}])
        m.expect_exec(r"DELETE FROM users").with_args(1).affects(1)
        assert m.query("SELECT * FROM users") == [{"id": 1, "name": "ada"}]
        cur = m.exec("DELETE FROM users WHERE id = ?", 1)
        assert cur.rowcount == 1
        m.verify()

    def test_affects_zero_drives_not_found_paths(self, S):
        m = S.SQLMock()
        m.expect_exec(r"UPDATE users").affects(0)
        cur = m.exec("UPDATE users SET name = ? WHERE id = ?", "x", 99)
        assert getattr(cur, "rowcount", 1) == 0
        m.verify()

    def test_out_of_order_fails(self, S):
        m = S.SQLMock()
        m.expect_query(r"SELECT a").returns([])
        m.expect_query(r"SELECT b").returns([])
        with pytest.raises(S.ExpectationError, match="unexpected"):
            m.query("SELECT b FROM t")

    def test_unordered_mode(self, S):
        m = S.SQLMock(ordered=False)
        m.expect_query(r"SELECT a").returns([{"a": 1}])
        m.expect_query(r"SELECT b").returns([{"b": 2}])
        assert m.query("SELECT b FROM t") == [{"b": 2}]
        assert m.query("SELECT a FROM t") == [{"a": 1}]
        m.verify()

    def test_arg_mismatch_fails(self, S):
        m = S.SQLMock()
        m.expect_exec(r"UPDATE").with_args("ada", 1).affects(1)
        with pytest.raises(S.ExpectationError):
            m.exec("UPDATE users SET name = ? WHERE id = ?", "lin", 1)

    def test_unmet_statement_fails_verify(self, S):
        m = S.SQLMock()
        m.expect_exec(r"INSERT INTO audit").affects(1)
        with pytest.raises(S.ExpectationError, match="never issued"):
            m.verify()

    def test_canned_error(self, S):
        m = S.SQLMock()
        m.expect_query(r"SELECT").raises(RuntimeError("db on fire"))
        with pytest.raises(RuntimeError, match="on fire"):
            m.query_row("SELECT 1")

    def test_transaction_shares_expectations(self, S):
        m = S.SQLMock()
        m.expect_exec(r"INSERT INTO t").affects(1)
        with m.begin() as tx:
            tx.exec("INSERT INTO t (x) VALUES (?)", 5)
        m.verify()

    def test_select_binds_dataclasses(self, S):
        @dataclasses.dataclass
        class User:
            id: int
            name: str

        m = S.SQLMock()
        m.expect_query(r"SELECT").returns([{"id": 3, "name": "lin"}])
        assert m.select(User, "SELECT * FROM users") == [User(3, "lin")]


class TestMockContainerIntegration:
    def test_mock_sql_installs_and_verifies(self, S):
        c = S.MockContainer()
        sql = c.mock_sql()
        sql.expect_query(r"SELECT 1").returns([{"one": 1}])
        assert c.sql.query("SELECT 1") == [{"one": 1}]
        c.verify()

    def test_container_verify_covers_every_mock(self, S):
        c = S.MockContainer()
        redis = c.mock("redis")
        redis.expect_call("get").with_args("x").returns("y")
        with pytest.raises(S.ExpectationError, match="redis"):
            c.verify()

    def test_context_manager_verifies_on_clean_exit(self, S):
        with pytest.raises(S.ExpectationError):
            with S.MockContainer() as c:
                c.mock_sql().expect_exec(r"INSERT").affects(1)

    def test_context_manager_does_not_mask_test_failure(self, S):
        with pytest.raises(ValueError, match="real failure"):
            with S.MockContainer() as c:
                c.mock_sql().expect_exec(r"INSERT").affects(1)
                raise ValueError("real failure")

    def test_handler_against_sqlmock(self, S):
        def handler(ctx):
            row = ctx.sql.query_row(
                "SELECT name FROM users WHERE id = ?", 7)
            return {"hello": row["name"]}

        c = S.MockContainer()
        sql = c.mock_sql()
        sql.expect_query(r"SELECT name FROM users").with_args(7) \
            .returns([{"name": "ada"}])
        ctx = S.Context(request=None, container=c)
        assert handler(ctx) == {"hello": "ada"}
        c.verify()


# ------------------------------------- test_datasource_breadth.py's three
class TestBreadthWithMockContainer:
    def test_mongo_health_and_metrics(self, S):
        c = S.new_mock_container()
        m = c.add_mongo(S.Mongo())
        m.insert_one("t", {"x": 1})
        assert c.health()["checks"]["mongo"]["status"] == "UP"
        assert c.metrics.get_histogram_count("app_mongo_stats",
                                             type="insert") == 1

    def test_context_resolves_breadth_slots(self, S):
        c = S.new_mock_container()
        c.add_dgraph(S.Dgraph())
        ctx = S.Context(request=None, container=c)
        assert ctx.dgraph is c.dgraph
        with pytest.raises(AttributeError):
            ctx.no_such_store

    def test_mock_container_can_mock_breadth_slot(self, S):
        c = S.new_mock_container()
        rec = c.mock("cassandra")
        rec.expect("query", [{"id": 7}])
        assert c.cassandra.query("SELECT ...") == [{"id": 7}]
        assert rec.calls_to("query")


# ---------------------------------------------------------------- parity
def _outcome(fn):
    """(``ok``, value) or (error type name, message) of ``fn()``."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, str(exc))


def _recorder_session(S):
    """A scripted session on a ``CallRecorder``: each step's outcome."""
    rec = S.CallRecorder("svc")
    rec.expect("stats", {"n": 1})
    rec.expect_call("get").with_args("a").returns(1).times(1)
    rec.expect_call("get").with_args("b").returns(2)
    rec.expect_call("put").raises(KeyError("full"))
    return [
        _outcome(lambda: rec.stats()),
        _outcome(lambda: rec.get("b")),
        _outcome(lambda: rec.get("a")),
        _outcome(lambda: rec.get("a")),
        _outcome(lambda: rec.get("z", k=1)),
        _outcome(lambda: rec.put(1)),
        _outcome(lambda: rec.health_check()),
        _outcome(rec.verify),
        rec.calls,
        _outcome(lambda: rec._private),
    ]


def _sqlmock_session(S, ordered):
    m = S.SQLMock(ordered=ordered)
    m.expect_query(r"SELECT \* FROM t").returns([{"a": 1}, {"a": 2}])
    m.expect_exec(r"UPDATE t").with_args(5).affects(3)
    m.expect_query(r"SELECT b").raises(ValueError("boom"))
    m.expect_exec(r"DELETE")
    return [
        _outcome(lambda: m.exec("UPDATE t SET a = ?", 5).rowcount),
        _outcome(lambda: m.query("SELECT * FROM t")),
        _outcome(lambda: m.query_row("SELECT b FROM t")),
        _outcome(lambda: m.exec("UPDATE t SET a = ?", 6)),
        _outcome(m.verify),
        m.statements,
        m.health_check(),
        m.ph(3),
    ]


@pytest.mark.parametrize("ordered", [True, False])
def test_sqlmock_sessions_equal_across_packages(ordered):
    assert _sqlmock_session(Side("port"), ordered) == \
        _sqlmock_session(Side("jax"), ordered)


def test_recorder_sessions_equal_across_packages():
    assert _recorder_session(Side("port")) == _recorder_session(Side("jax"))


def test_mock_container_defaults_equal_across_packages():
    """The same default slots, real backends, logs and traces on both."""
    got = {}
    for side in SIDES:
        S = Side(side)
        c = S.MockContainer()
        c.sql.exec("CREATE TABLE t (x INTEGER)")
        c.sql.exec("INSERT INTO t (x) VALUES (?)", 4)
        c.redis.set("k", "v")
        c.kv.set("a", "b")
        svc = c.mock_service("billing")
        svc.expect("charge", {"ok": True})
        c.logger.info("hello", n=1)
        with c.tracer.start_span("work"):
            pass
        got[side] = {
            "rows": c.sql.query("SELECT x FROM t"),
            "redis": c.redis.get("k"), "kv": c.kv.get("a"),
            "charge": c.services["billing"].charge(9),
            "mocks": sorted(c.mocks),
            # durations dropped: they differ run to run
            "logs": [(line.get("level"),
                      re.sub(r"\s*\d+µs", " <t>", line.get("message")))
                     for line in c.log_lines],
            "spans": [s.name for s in c.trace_exporter.spans],
            "health": sorted(c.health()["checks"]),
        }
    assert got["port"] == got["jax"]
