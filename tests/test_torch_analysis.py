"""The port's gofrlint (``gofr_tpu_torch/analysis/``, ``scripts/torch_lint.py``)
against the JAX package's (``gofr_tpu/analysis/``, ``scripts/lint.py``):
every fixture of ``tests/analysis_fixtures/`` gives identical findings from
both analyzers; the cases of ``tests/test_analysis.py`` run on the port's
analyzer (the fixture cases on JAX's fixtures, the live-repo cases on the
port's modules and ``scripts/torch_lint.py``); the torch twins in
``tests/torch_analysis_fixtures/`` are flagged by the same rules at their
JAX twins' lines, and their clean twins are silent; and every
``@hot_path`` / ``@hot_path_boundary`` marker of JAX's serving modules
sits on the port's counterpart with JAX's reason.
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gofr_tpu.analysis import run_analysis as jax_run_analysis
from gofr_tpu_torch.analysis import run_analysis
from gofr_tpu_torch.analysis.callgraph import CallGraph
from gofr_tpu_torch.analysis.core import load_project
from gofr_tpu_torch.analysis.rules import metric_hygiene

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures"
TWINS = REPO / "tests" / "torch_analysis_fixtures"
PORT = REPO / "gofr_tpu_torch"
SERVING = PORT / "serving"


def lint(*names, rules=None, where=FIXTURES):
    findings, _ = run_analysis([where / n for n in names], rules=rules,
                               root=REPO)
    return findings


def violations(findings, rule=None):
    out = [f for f in findings if not f.suppressed]
    if rule is not None:
        out = [f for f in out if f.rule == rule]
    return out


def _closure_modules():
    project = load_project([SERVING], root=REPO)
    return [str(k) for k in CallGraph(project).hot_closure()]


def _boundary(entry) -> str:
    return getattr(entry, "__gofr_hot_path_boundary__", "")


# --------------------------------------------- both analyzers, one answer
def _as_tuples(findings):
    return [(f.rule, f.path, f.line, f.col, f.message, f.suppressed,
             f.allow_reason) for f in findings]


@pytest.mark.parametrize("fixture", sorted(p.name for p in
                                           FIXTURES.glob("*.py")))
def test_each_jax_fixture_gives_identical_findings(fixture):
    port, _ = run_analysis([FIXTURES / fixture], root=REPO)
    jax, _ = jax_run_analysis([FIXTURES / fixture], root=REPO)
    assert _as_tuples(port) == _as_tuples(jax)


def test_all_jax_fixtures_together_give_identical_findings():
    port, _ = run_analysis([FIXTURES], root=REPO)
    jax, _ = jax_run_analysis([FIXTURES], root=REPO)
    assert port and _as_tuples(port) == _as_tuples(jax)


TWIN_RULES = [("hot_path", "hot-path-purity"),
              ("kvquant", "kv-quant-boundary"),
              ("recompile", "recompile-hazard")]


@pytest.mark.parametrize("name,rule", TWIN_RULES)
def test_torch_twin_flags_the_jax_twins_lines(name, rule):
    jax, _ = jax_run_analysis([FIXTURES / f"{name}_bad.py"], root=REPO)
    want = {f.line for f in violations(jax, rule)}
    got = {f.line for f in violations(lint(f"{name}_bad.py", where=TWINS),
                                      rule)}
    assert want and got == want


@pytest.mark.parametrize("name,rule", TWIN_RULES)
def test_torch_clean_twin_is_silent(name, rule):
    assert violations(lint(f"{name}_good.py", where=TWINS), rule) == []


@pytest.mark.parametrize("name,rule", TWIN_RULES)
def test_jax_analyzer_misses_the_torch_spellings(name, rule):
    """The torch spellings are what the port's rules add: JAX's analyzer
    flags fewer of the torch twin's lines (none of the recompile
    twin's)."""
    jax, _ = jax_run_analysis([TWINS / f"{name}_bad.py"], root=REPO)
    port = lint(f"{name}_bad.py", where=TWINS)
    assert len({f.line for f in violations(jax, rule)}) < \
        len({f.line for f in violations(port, rule)})


def test_call_graph_equals_jax_analyzers():
    """The port's call graph (imports indexed once per module) links the
    same calls and gives the same hot closure as JAX's on real modules."""
    from gofr_tpu.analysis.callgraph import CallGraph as JaxCallGraph
    from gofr_tpu.analysis.core import load_project as jax_load_project
    paths = [SERVING / f"{name}.py" for name in
             ("control_plane", "router", "app", "handlers", "observability")]
    port = CallGraph(load_project(paths, root=REPO))
    jax = JaxCallGraph(jax_load_project(paths, root=REPO))

    def links(graph):
        return sorted((str(k), sorted(str(c) for c, _ in info.calls))
                      for k, info in graph.funcs.items())
    assert links(port) == links(jax)
    assert sum(len(info.calls) for info in port.funcs.values()) > 100
    assert sorted(map(str, port.hot_closure())) == \
        sorted(map(str, jax.hot_closure()))


def _snippet(tmp_path, text, rule):
    path = tmp_path / "snippet.py"
    path.write_text(text)
    findings, _ = run_analysis([path], rules=[rule], root=tmp_path)
    return sorted(f.line for f in violations(findings, rule))


def test_compile_decorator_and_immediate_call_are_wrappers(tmp_path):
    text = ("import torch\n"
            "@torch.compile\n"
            "def step(x, n):\n"
            "    return x\n"
            "@torch.compile(mode='max-autotune')\n"
            "def step2(x, n):\n"
            "    return x\n"
            "def serve(req, cfg):\n"
            "    step(req.tokens, len(req.tokens))\n"
            "    step2(req.tokens, req.n > 3)\n"
            "    torch.compile(step)(req.tokens, not req.stream)\n"
            "    step(req.tokens, cfg.width)\n"
            "    step(req.tokens, req.n)\n")
    assert _snippet(tmp_path, text, "recompile-hazard") == [9, 10, 11]


def test_host_copies_and_device_moves(tmp_path):
    text = ("import torch\n"
            "from gofr_tpu_torch.analysis import hot_path\n"
            "@hot_path\n"
            "def step(x, dev):\n"
            "    x.to('cpu')\n"
            "    x.to(device='cpu:0')\n"
            "    x.to(dev)\n"
            "    x.to('cuda', non_blocking=True)\n"
            "    float(torch.max(x))\n"
            "    float(x.shape[0])\n"
            "    torch.cuda.current_stream().synchronize()\n")
    assert _snippet(tmp_path, text, "hot-path-purity") == [5, 6, 9, 11]


# ------------------------------------------------------- markers carried
def _jax_sites():
    """(module, qualname, kind, reason) of every marker in JAX's serving
    modules."""
    out = []
    for name in ("engine", "scheduler", "costmodel", "integrity",
                 "faults", "events"):
        tree = ast.parse((REPO / "gofr_tpu" / "serving" /
                          f"{name}.py").read_text())
        for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                for dec in fn.decorator_list:
                    if isinstance(dec, ast.Name) and dec.id == "hot_path":
                        out.append((name, f"{cls.name}.{fn.name}",
                                    "hot_path", None))
                    elif isinstance(dec, ast.Call) and getattr(
                            dec.func, "id", "") == "hot_path_boundary":
                        out.append((name, f"{cls.name}.{fn.name}",
                                    "boundary",
                                    ast.literal_eval(dec.args[0])))
    return out


#: JAX sites whose work the port does in a function of another name
COUNTERPART = {"Engine._tables_arg": "Engine._sync_tables"}
#: the port's lockstep operations: each carries the marker of the JAX
#: function whose device work it does
LOCKSTEP_OPS = {"Engine._op_prefill": "Engine._prefill_group",
                "Engine._op_chunk": "Engine._walk_chunks",
                "Engine._op_upload": "Engine._sync_decode_state",
                "Engine._op_launch": "Engine._decode_dispatch",
                "Engine._op_collect": "Engine._decode_collect",
                "Engine._op_verify": "Engine._spec_pass"}
JAX_SITES = _jax_sites()


def test_jax_has_thirty_marker_sites():
    assert len(JAX_SITES) == 30
    assert sum(kind == "hot_path" for *_, kind, _ in JAX_SITES) == 9


def _port_attr(module, qualname):
    import importlib
    mod = importlib.import_module(f"gofr_tpu_torch.serving.{module}")
    cls, meth = qualname.split(".")
    return getattr(getattr(mod, cls), meth)


def _reason(text: str) -> str:
    """A boundary's reason without JAX's references to its own history
    (``(PRs 3-5)``), which the port's copy leaves out."""
    return re.sub(r" \(PRs? [0-9-]+\)", "", text)


@pytest.mark.parametrize("site", JAX_SITES, ids=lambda s: s[1])
def test_port_counterpart_carries_the_jax_marker(site):
    module, qualname, kind, reason = site
    fn = _port_attr(module, COUNTERPART.get(qualname, qualname))
    if kind == "hot_path":
        assert getattr(fn, "__gofr_hot_path__", False) is True
    else:
        assert _boundary(fn) and _boundary(fn) == _reason(reason)


@pytest.mark.parametrize("op,source", sorted(LOCKSTEP_OPS.items()))
def test_lockstep_ops_carry_their_sources_marker(op, source):
    port_fn = _port_attr("engine", op)
    jax_site = next(s for s in JAX_SITES if s[1] == source)
    if jax_site[2] == "hot_path":
        assert getattr(port_fn, "__gofr_hot_path__", False) is True
    else:
        assert _boundary(port_fn) == _reason(jax_site[3])


def test_the_port_decode_closure_is_guarded():
    closure = _closure_modules()
    for name in ("_decode_dispatch", "_decode_collect", "_sync_tables",
                 "_op_launch", "_op_collect", "_prefill_group",
                 "_collect_prefills", "_walk_chunks", "_op_prefill"):
        assert any(k.endswith(f"Engine.{name}") for k in closure), name


def test_markers_change_nothing_at_run_time():
    from gofr_tpu_torch.analysis import hot_path, hot_path_boundary

    def f(x):
        return x + 1
    assert hot_path(f) is f and f(1) == 2
    assert hot_path_boundary("why")(f) is f
    with pytest.raises(ValueError):
        hot_path_boundary(" ")


# --------------------------------------- tests/test_analysis.py, on the port
class TestHotPathPurity:
    def test_bad_fixture_flags_every_seeded_violation(self):
        lines = {f.line for f in violations(lint("hot_path_bad.py"),
                                            "hot-path-purity")}
        assert {14, 15, 16, 17, 18, 19, 20, 21, 22} <= lines
        assert 32 in lines

    def test_closure_finding_names_the_root_chain(self):
        got = violations(lint("hot_path_bad.py"), "hot-path-purity")
        via = [f for f in got if f.line == 32]
        assert via and "Engine.step" in via[0].message

    def test_clean_twin_is_silent(self):
        assert violations(lint("hot_path_good.py"), "hot-path-purity") == []

    def test_boundary_stops_traversal_but_cold_code_is_ignored(self):
        assert violations(lint("hot_path_good.py"), "hot-path-purity") == []


class TestSchedulerHotPathContract:
    def test_inline_scheduler_bookkeeping_flags(self):
        lines = {f.line for f in violations(lint("sched_bad.py"),
                                            "hot-path-purity")}
        assert {15, 16, 17} <= lines and {23, 24} <= lines

    def test_boundary_entry_points_are_clean(self):
        assert violations(lint("sched_good.py"), "hot-path-purity") == []

    def test_live_scheduler_entry_points_declare_boundaries(self):
        from gofr_tpu_torch.serving.scheduler import Scheduler
        for entry in (Scheduler.put, Scheduler.note_retire):
            assert _boundary(entry).strip(), entry

    def test_live_repo_hot_closure_excludes_scheduler(self):
        assert not [k for k in _closure_modules()
                    if k.split("::")[0].endswith("scheduler.py")]


class TestFaultInjectionSites:
    def test_inline_chaos_flags(self):
        lines = {f.line for f in violations(lint("faults_bad.py"),
                                            "hot-path-purity")}
        assert {14, 15, 16} <= lines and 22 in lines

    def test_boundary_guarded_sites_are_clean(self):
        assert violations(lint("faults_good.py"), "hot-path-purity") == []

    def test_live_trip_declares_a_boundary(self):
        from gofr_tpu_torch.serving.faults import FaultPlan
        assert _boundary(FaultPlan.trip).strip()


class TestEventLedgerContract:
    def test_inline_event_recording_flags(self):
        lines = {f.line for f in violations(lint("events_bad.py"),
                                            "hot-path-purity")}
        assert {14, 15, 16} <= lines and 21 in lines

    def test_boundary_emission_is_clean(self):
        assert violations(lint("events_good.py"), "hot-path-purity") == []

    def test_live_emit_declares_a_boundary(self):
        from gofr_tpu_torch.serving.events import EventLedger
        assert _boundary(EventLedger.emit).strip()

    def test_live_repo_hot_closure_excludes_events(self):
        assert not [k for k in _closure_modules()
                    if k.split("::")[0].endswith("events.py")]


class TestCostModelContract:
    def test_inline_cost_accounting_flags(self):
        lines = {f.line for f in violations(lint("costmodel_bad.py"),
                                            "hot-path-purity")}
        assert {14, 15, 16} <= lines and 21 in lines

    def test_boundary_fold_is_clean(self):
        assert violations(lint("costmodel_good.py"),
                          "hot-path-purity") == []

    def test_live_folds_declare_boundaries(self):
        from gofr_tpu_torch.serving.costmodel import CostModel
        from gofr_tpu_torch.serving.engine import Engine
        for entry in (CostModel.observe, Engine._note_pass_cost):
            assert _boundary(entry).strip(), entry

    def test_live_repo_hot_closure_excludes_costmodel(self):
        assert not [k for k in _closure_modules()
                    if k.split("::")[0].endswith("costmodel.py")]


class TestIntegrityContract:
    def test_inline_fingerprinting_flags(self):
        lines = {f.line for f in violations(lint("integrity_bad.py"),
                                            "hot-path-purity")}
        assert {14, 18, 19} <= lines and 24 in lines

    def test_boundary_fold_is_clean(self):
        assert violations(lint("integrity_good.py"),
                          "hot-path-purity") == []

    def test_live_folds_declare_boundaries(self):
        from gofr_tpu_torch.serving.engine import Engine
        from gofr_tpu_torch.serving.integrity import IntegrityPlane
        for entry in (IntegrityPlane.fold, Engine._note_integrity):
            assert _boundary(entry).strip(), entry

    def test_live_repo_hot_closure_excludes_integrity(self):
        assert not [k for k in _closure_modules()
                    if k.split("::")[0].endswith("integrity.py")]


class TestSpeculationContract:
    def test_inline_drafting_flags(self):
        lines = {f.line for f in violations(lint("spec_bad.py"),
                                            "hot-path-purity")}
        assert {14, 15, 16} <= lines and {23, 24} <= lines

    def test_boundary_drafting_is_clean(self):
        assert violations(lint("spec_good.py"), "hot-path-purity") == []

    def test_live_spec_entry_points_declare_boundaries(self):
        from gofr_tpu_torch.serving.engine import Engine
        for entry in (Engine._draft_proposals, Engine._spec_pass):
            assert _boundary(entry).strip(), entry

    def test_live_repo_hot_closure_excludes_spec(self):
        assert not [k for k in _closure_modules()
                    if k.split("::")[0].endswith("spec.py")]


class TestRouterContract:
    def test_blocking_proxy_path_flags(self):
        got = violations(lint("router_bad.py"), "blocking-in-async")
        assert {f.line for f in got} == {16, 17, 18}

    def test_inline_digest_assembly_flags(self):
        lines = {f.line for f in violations(lint("router_bad.py"),
                                            "hot-path-purity")}
        assert {29, 30} <= lines and 37 in lines

    def test_clean_twin_is_silent_on_both_rules(self):
        got = lint("router_good.py")
        assert violations(got, "blocking-in-async") == []
        assert violations(got, "hot-path-purity") == []

    def test_live_digest_refresh_declares_a_boundary(self):
        from gofr_tpu_torch.serving.engine import Engine
        assert _boundary(Engine._refresh_prefix_digest).strip()

    def test_live_proxy_path_is_async_clean(self):
        findings, _ = run_analysis([SERVING / "router.py"], root=REPO)
        assert violations(findings, "blocking-in-async") == []


class TestLockDiscipline:
    def test_bad_fixture(self):
        got = violations(lint("locks_bad.py"), "lock-discipline")
        assert {f.line for f in got} == {17, 20, 23}
        assert any("_items" in f.message for f in got)
        assert any("_count" in f.message for f in got)

    def test_clean_twin(self):
        assert violations(lint("locks_good.py"), "lock-discipline") == []

    def test_the_two_port_lock_findings_are_gone(self):
        findings, _ = run_analysis(
            [PORT / "datasource" / "sql.py",
             SERVING / "observability.py"], rules=["lock-discipline"],
            root=REPO)
        assert violations(findings) == []


class TestElectionContract:
    ELECTION_FNS = ("ensure_active", "_fence", "_choose_candidate",
                    "_adopt_epoch")

    def test_bad_fixture_lease_races_are_flagged(self):
        got = violations(lint("election_bad.py"), "lock-discipline")
        assert {f.line for f in got} == {20, 21}
        assert any("active" in f.message for f in got)
        assert any("epoch" in f.message for f in got)

    def test_bad_fixture_election_reads_clock_and_rng(self):
        names = self._referenced_modules(FIXTURES / "election_bad.py",
                                         ("choose",))
        assert {"time", "random"} <= names

    def test_clean_twin_is_silent_and_pure(self):
        assert violations(lint("election_good.py"),
                          "lock-discipline") == []
        names = self._referenced_modules(FIXTURES / "election_good.py",
                                         ("choose",))
        assert not names & {"time", "random"}

    def test_live_election_functions_are_clock_and_rng_free(self):
        names = self._referenced_modules(SERVING / "control_plane.py",
                                         self.ELECTION_FNS)
        assert not names & {"time", "random"}, names

    def test_live_module_lints_clean(self):
        findings, _ = run_analysis([SERVING / "control_plane.py"],
                                   root=REPO)
        assert violations(findings, "lock-discipline") == []

    @staticmethod
    def _referenced_modules(path, fn_names):
        tree = ast.parse(path.read_text())
        out: set = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in fn_names:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Attribute) \
                            and isinstance(sub.value, ast.Name):
                        out.add(sub.value.id)
        return out


class TestBlockingInAsync:
    def test_bad_fixture(self):
        got = violations(lint("async_bad.py"), "blocking-in-async")
        assert {f.line for f in got} == {9, 10, 11, 12, 13}

    def test_clean_twin(self):
        assert violations(lint("async_good.py"), "blocking-in-async") == []


class TestMetricHygiene:
    def test_bad_fixture(self):
        got = violations(lint("metrics_bad.py"), "metric-hygiene")
        msgs = {f.line: f.message for f in got}
        assert "app_orphan_total" in msgs[6]
        assert "app_never_registered" in msgs[13]
        assert "not a string literal" in msgs[14]
        assert len(got) == 3

    def test_clean_twin_including_loop_unroll(self):
        assert violations(lint("metrics_good.py"), "metric-hygiene") == []

    def test_cross_file_resolution(self):
        got = violations(lint("metrics_good.py", "metrics_bad.py"),
                         "metric-hygiene")
        assert all(f.path.endswith("metrics_bad.py") for f in got)

    def test_service_response_histogram_has_a_writer(self):
        """``app_http_service_response`` is registered by the container
        and written by the service client, as in JAX."""
        project = load_project([PORT], root=REPO)
        assert "app_http_service_response" in \
            metric_hygiene.written_names(project)
        assert "app_nats_kv_stats" in metric_hygiene.written_names(project)


class TestRecompileHazard:
    def test_bad_fixture(self):
        got = violations(lint("recompile_bad.py"), "recompile-hazard")
        assert {f.line for f in got} == {17, 18, 19, 29}

    def test_clean_twin(self):
        assert violations(lint("recompile_good.py"),
                          "recompile-hazard") == []

    def test_port_compiles_nothing_and_is_clean(self):
        findings, _ = run_analysis([PORT], rules=["recompile-hazard"],
                                   root=REPO)
        assert violations(findings) == []


class TestKvQuantBoundary:
    def test_bad_fixture_flags_every_seeded_violation(self):
        got = violations(lint("kvquant_bad.py"), "kv-quant-boundary")
        assert {f.line for f in got} == {11, 14, 22, 24, 29, 30, 31}
        assert any("quantizes/casts on write" in f.message for f in got)
        assert any("host-side readback" in f.message for f in got)

    def test_clean_twin_is_silent(self):
        assert violations(lint("kvquant_good.py"),
                          "kv-quant-boundary") == []

    def test_live_serving_and_models_respect_the_boundary(self):
        findings, _ = run_analysis([SERVING, PORT / "models", PORT / "ops"],
                                   root=REPO)
        assert violations(findings, "kv-quant-boundary") == []


class TestSuppressions:
    def test_missing_reason_is_an_error(self):
        bad = violations(lint("suppression_bad.py"), "bad-suppression")
        assert any("missing its mandatory" in f.message and f.line == 9
                   for f in bad)

    def test_reasonless_allow_does_not_suppress(self):
        assert any(f.line == 9 for f in
                   violations(lint("suppression_bad.py"), "hot-path-purity"))

    def test_stale_allow_is_an_error(self):
        assert any(f.line == 12 and "suppresses nothing" in f.message
                   for f in violations(lint("suppression_bad.py"),
                                       "bad-suppression"))

    def test_typoed_rule_neither_suppresses_nor_passes(self):
        got = lint("suppression_bad.py")
        assert any(f.line == 17 for f in violations(got, "hot-path-purity"))
        assert any(f.line == 17 for f in violations(got, "bad-suppression"))

    def test_valid_allow_suppresses_and_keeps_reason(self):
        got = lint("suppression_good.py")
        assert violations(got) == []
        sup = [f for f in got if f.suppressed]
        assert sup and all(f.allow_reason for f in sup)

    def test_one_allow_may_cover_multiple_rules(self):
        rules = {f.rule for f in lint("suppression_good.py")
                 if f.suppressed and f.line == 14}
        assert "hot-path-purity" in rules


class TestCLI:
    def run_cli(self, *args):
        return subprocess.run(
            [sys.executable, str(REPO / "scripts" / "torch_lint.py"), *args],
            capture_output=True, text=True, cwd=REPO)

    def test_bad_fixture_exits_nonzero_with_file_line(self):
        r = self.run_cli(str(FIXTURES / "async_bad.py"))
        assert r.returncode == 1
        assert re.search(r"async_bad\.py:9:\d+: \[blocking-in-async\]",
                         r.stdout)

    def test_json_format_is_machine_readable(self):
        r = self.run_cli("--format=json", str(TWINS / "hot_path_bad.py"))
        assert r.returncode == 1
        doc = json.loads(r.stdout)
        assert doc["counts"]["hot-path-purity"] == 12
        assert all({"rule", "path", "line", "col", "message"}
                   <= set(v) for v in doc["violations"])

    def test_clean_fixture_exits_zero(self):
        r = self.run_cli(str(TWINS / "kvquant_good.py"))
        assert r.returncode == 0, r.stdout + r.stderr

    def test_self_test_passes(self):
        r = self.run_cli("--self-test")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "across 7 rules" in r.stdout

    def test_unknown_rule_is_usage_error(self):
        r = self.run_cli("--rule", "no-such-rule", ".")
        assert r.returncode == 2

    def test_repo_lints_clean(self):
        scripts = sorted(str(p.relative_to(REPO))
                         for p in (REPO / "scripts").glob("torch_*.py"))
        r = self.run_cli("gofr_tpu_torch/", "examples_torch/", *scripts)
        assert r.returncode == 0, r.stdout + r.stderr

    def test_allows_carry_reasons(self):
        r = self.run_cli("--format=json", "gofr_tpu_torch/")
        doc = json.loads(r.stdout)
        assert doc["violations"] == []
        assert doc["suppressed"] and all(
            f["allow_reason"] for f in doc["suppressed"])


class TestStaticDynamicAgreement:
    def test_static_extraction_covers_the_dynamic_scan(self):
        from .test_observability import _WRITE_RE
        regex_names = set()
        for path in SERVING.glob("*.py"):
            regex_names.update(_WRITE_RE.findall(path.read_text()))
        static_names = metric_hygiene.written_names(
            load_project([SERVING], root=REPO))
        assert regex_names <= static_names, sorted(regex_names -
                                                   static_names)
        registered = metric_hygiene.registered_names(
            load_project([PORT], root=REPO))
        extra = static_names - regex_names
        assert extra <= registered, sorted(extra - registered)

    def test_every_serving_write_is_statically_registered(self):
        written = metric_hygiene.written_names(
            load_project([SERVING], root=REPO))
        registered = metric_hygiene.registered_names(
            load_project([PORT], root=REPO))
        assert written
        assert not sorted(n for n in written if n not in registered)
