"""Mock container — the centerpiece of the test strategy (the port's copy of
``gofr_tpu/container/mock.py``).

Mirrors reference ``NewMockContainer`` (container/mock_container.go:93-160):
a full container whose every capability is an in-memory fake with call
recording, so handler tests run hermetically. SQL is backed by
in-memory sqlite, KV by a dict, pub/sub by an in-process broker, and
the TPU slot by a CPU-backed fake runtime — the "miniredis for the
device layer" SURVEY §4 calls for.
"""

from __future__ import annotations

from typing import Any

from ..config.env import DictConfig
from ..logging.logger import DEBUG, MockLogger
from ..tracing.tracer import InMemoryExporter, Tracer
from .container import Container


class ExpectationError(AssertionError):
    """An expectation was violated: unexpected call, argument
    mismatch, or unmet count at verify() (the analog of a gomock
    controller failing the test, reference
    container/mock_container.go:93)."""


_ANY = object()


class Expectation:
    """One expected interaction, gomock-style: chain ``with_args``,
    ``returns``/``raises``, and ``times`` (exact count; default "at
    least once")."""

    def __init__(self, method: str) -> None:
        self.method = method
        self.args: Any = _ANY
        self.kwargs: Any = _ANY
        self.result: Any = None
        self.exc: BaseException | None = None
        self.expected_times: int | None = None
        self.actual = 0

    def with_args(self, *args: Any, **kwargs: Any) -> "Expectation":
        self.args = args
        self.kwargs = kwargs
        return self

    def returns(self, result: Any) -> "Expectation":
        self.result = result
        return self

    def raises(self, exc: BaseException) -> "Expectation":
        self.exc = exc
        return self

    def times(self, n: int) -> "Expectation":
        self.expected_times = n
        return self

    # -- matching
    def matches(self, args: tuple, kwargs: dict) -> bool:
        if self.args is not _ANY and tuple(self.args) != tuple(args):
            return False
        if self.kwargs is not _ANY and self.kwargs != kwargs:
            return False
        return True

    def saturated(self) -> bool:
        return self.expected_times is not None \
            and self.actual >= self.expected_times

    def describe(self) -> str:
        want = "any args" if self.args is _ANY else \
            f"args={self.args!r} kwargs={self.kwargs!r}"
        count = "at least once" if self.expected_times is None \
            else f"exactly {self.expected_times}x"
        return f"{self.method}({want}) {count}, called {self.actual}x"

    def unmet(self) -> bool:
        if self.expected_times is None:
            return self.actual == 0
        return self.actual != self.expected_times


class CallRecorder:
    """Records method calls; configurable canned results/raises.

    Two modes compose:

      * loose (default): any method call succeeds and returns the
        canned result set via :meth:`expect` — handler tests that only
        care about one interaction stay one-liners;
      * strict expectations via :meth:`expect_call`: declared
        interactions are matched (by method, then args) in declaration
        order per method; ``verify()`` fails on unmet counts, and once
        a method has ANY declared expectation, a call that matches
        none of them fails immediately.
    """

    def __init__(self, name: str = "mock") -> None:
        self._name = name
        self.calls: list[tuple[str, tuple, dict]] = []
        # mocked capabilities report healthy unless a test says otherwise,
        # so health assertions stay hermetic
        self._results: dict[str, Any] = {"health_check": {"status": "UP"}}
        self._raises: dict[str, BaseException] = {}
        self._expectations: list[Expectation] = []

    def expect(self, method: str, result: Any = None,
               raises: BaseException | None = None) -> None:
        if raises is not None:
            self._raises[method] = raises
        else:
            self._results[method] = result

    def expect_call(self, method: str) -> Expectation:
        exp = Expectation(method)
        self._expectations.append(exp)
        return exp

    def verify(self) -> None:
        unmet = [e.describe() for e in self._expectations if e.unmet()]
        if unmet:
            raise ExpectationError(
                f"{self._name}: unmet expectations:\n  " +
                "\n  ".join(unmet))

    def calls_to(self, method: str) -> list[tuple[tuple, dict]]:
        return [(a, k) for m, a, k in self.calls if m == method]

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args: Any, **kwargs: Any) -> Any:
            self.calls.append((method, args, kwargs))
            declared = [e for e in self._expectations
                        if e.method == method]
            if declared:
                for exp in declared:
                    if not exp.saturated() and exp.matches(args, kwargs):
                        exp.actual += 1
                        if exp.exc is not None:
                            raise exp.exc
                        return exp.result
                raise ExpectationError(
                    f"{self._name}.{method} called with args={args!r} "
                    f"kwargs={kwargs!r}, matching no open expectation "
                    f"(declared: "
                    f"{[e.describe() for e in declared]})")
            if method in self._raises:
                raise self._raises[method]
            return self._results.get(method)
        return call


class _SQLExpectation:
    """One expected statement: regex-matched SQL, optional exact args,
    canned rows / rowcount / error."""

    def __init__(self, kind: str, pattern: str) -> None:
        import re
        self.kind = kind  # "query" | "exec"
        self.pattern = re.compile(pattern, re.IGNORECASE | re.DOTALL)
        self.args: Any = _ANY
        self.rows: list[dict] = []
        self.rowcount = 0
        self.exc: BaseException | None = None
        self.consumed = False

    def with_args(self, *args: Any) -> "_SQLExpectation":
        self.args = args
        return self

    def returns(self, rows: list[dict]) -> "_SQLExpectation":
        self.rows = rows
        return self

    # (affects() feeds _ExecResult.rowcount — crud's not-found checks
    # read it exactly as they read a real cursor's)

    def affects(self, rowcount: int) -> "_SQLExpectation":
        self.rowcount = rowcount
        return self

    def raises(self, exc: BaseException) -> "_SQLExpectation":
        self.exc = exc
        return self

    def describe(self) -> str:
        want = "" if self.args is _ANY else f" args={self.args!r}"
        return f"{self.kind} /{self.pattern.pattern}/{want}"


class _ExecResult:
    """What SQLMock.exec returns: the cursor attributes statement-
    issuing code actually reads."""

    def __init__(self, rowcount: int) -> None:
        self.rowcount = rowcount
        self.lastrowid = 0


class SQLMock:
    """sqlmock-style SQL double (reference container/sql_mock.go:12):
    every statement the code under test issues must match the next
    declared expectation of its kind in order; rows/rowcounts are
    canned; ``verify()`` fails the test on statements never issued.

    Presents the same surface as ``datasource.sql.SQL`` (query /
    query_row / exec / select / begin / ph), so it drops into
    ``container.sql``. ``begin()`` yields the mock itself — declared
    expectations span transactions, exactly like sqlmock."""

    dialect = "sqlite"

    def __init__(self, *, ordered: bool = True) -> None:
        self.ordered = ordered
        self._expectations: list[_SQLExpectation] = []
        self.statements: list[tuple[str, str, tuple]] = []

    # ---- declaration
    def expect_query(self, pattern: str) -> _SQLExpectation:
        exp = _SQLExpectation("query", pattern)
        self._expectations.append(exp)
        return exp

    def expect_exec(self, pattern: str) -> _SQLExpectation:
        exp = _SQLExpectation("exec", pattern)
        self._expectations.append(exp)
        return exp

    def verify(self) -> None:
        unmet = [e.describe() for e in self._expectations
                 if not e.consumed]
        if unmet:
            raise ExpectationError(
                "sqlmock: expected statements never issued:\n  " +
                "\n  ".join(unmet))

    # ---- matching
    def _take(self, kind: str, sql: str, args: tuple) -> _SQLExpectation:
        self.statements.append((kind, sql, args))
        candidates = [e for e in self._expectations if not e.consumed]
        if self.ordered:
            candidates = candidates[:1]
        for exp in candidates:
            if exp.kind != kind or not exp.pattern.search(sql):
                continue
            if exp.args is not _ANY and tuple(exp.args) != tuple(args):
                continue
            exp.consumed = True
            if exp.exc is not None:
                raise exp.exc
            return exp
        nxt = next((e.describe() for e in self._expectations
                    if not e.consumed), "nothing")
        raise ExpectationError(
            f"sqlmock: unexpected {kind} {sql!r} args={args!r} "
            f"(next expected: {nxt})")

    # ---- the SQL surface
    def ph(self, n: int) -> str:
        return "?"

    def query(self, sql: str, *args: Any) -> list[dict]:
        return self._take("query", sql, args).rows

    def query_row(self, sql: str, *args: Any) -> dict | None:
        rows = self._take("query", sql, args).rows
        return rows[0] if rows else None

    def exec(self, sql: str, *args: Any) -> Any:
        # cursor-shaped result: handlers and auto-CRUD read .rowcount
        # off the real store's cursor (e.g. the 404-on-zero-rows path)
        return _ExecResult(self._take("exec", sql, args).rowcount)

    def select(self, entity_type: type, sql: str, *args: Any) -> list[Any]:
        rows = self._take("query", sql, args).rows
        import dataclasses
        if dataclasses.is_dataclass(entity_type):
            names = {f.name for f in dataclasses.fields(entity_type)}
            return [entity_type(**{k: v for k, v in r.items()
                                   if k in names}) for r in rows]
        return list(rows)

    def begin(self):
        from contextlib import contextmanager

        @contextmanager
        def tx():
            yield self
        return tx()

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "details": {"dialect": "mock"}}

    def close(self) -> None:
        pass


class MockContainer(Container):
    def __init__(self, config: DictConfig | None = None) -> None:
        super().__init__(config=config or DictConfig(),
                         logger=MockLogger(level=DEBUG))
        self.register_framework_metrics()
        self.trace_exporter = InMemoryExporter()
        self.tracer = Tracer(service_name="mock-app", exporter=self.trace_exporter)
        self.mocks: dict[str, CallRecorder] = {}
        # real in-memory backends by default (sqlite SQL, dict KV,
        # in-process redis) so handler tests exercise actual query paths;
        # mock(slot) swaps any of them for a CallRecorder
        from ..datasource.kv import InMemoryKV
        from ..datasource.redis import Redis
        from ..datasource.sql import SQL
        self.add_sql(SQL(database=":memory:"))
        self.add_redis(Redis())
        self.add_kv_store(InMemoryKV())

    def mock(self, slot: str) -> CallRecorder:
        """Install a CallRecorder at a container slot and return it."""
        recorder = self.mocks.get(slot)
        if recorder is None:
            recorder = CallRecorder(slot)
            self.mocks[slot] = recorder
            setattr(self, slot, recorder)
        return recorder

    def mock_service(self, name: str) -> CallRecorder:
        recorder = CallRecorder(f"service:{name}")
        self.services[name] = recorder
        self.mocks[f"service:{name}"] = recorder
        return recorder

    def mock_sql(self, *, ordered: bool = True) -> SQLMock:
        """Swap container.sql for a sqlmock-style double (reference
        container/sql_mock.go:12); verify() covers it."""
        mock = SQLMock(ordered=ordered)
        self.sql = mock
        self.mocks["sql"] = mock  # type: ignore[assignment]
        return mock

    def verify(self) -> None:
        """Fail on any unmet expectation across every installed mock —
        the gomock-controller finish step. Call at test teardown (or
        use the container as a context manager)."""
        for recorder in self.mocks.values():
            recorder.verify()

    def __enter__(self) -> "MockContainer":
        return self

    def __exit__(self, exc_type, *_: Any) -> None:
        if exc_type is None:  # don't mask the test's own failure
            self.verify()

    @property
    def log_lines(self) -> list[dict]:
        return self.logger.lines  # type: ignore[attr-defined]


def new_mock_container() -> MockContainer:
    return MockContainer()
