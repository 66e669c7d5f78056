"""Rule ``metric-hygiene`` (the port's copy of
``gofr_tpu/analysis/rules/metric_hygiene.py``).

Statically extract every metric-name string literal and cross-check
write sites against registration sites, both ways:

- a **write** (``increment_counter``/``add_counter``/
  ``delta_up_down_counter``/``record_histogram``/``set_gauge``) whose
  name is registered nowhere in the linted tree is a silent
  log-and-drop — flagged at the write;
- a **registration** (``new_counter``/``new_up_down_counter``/
  ``new_histogram``/``new_gauge``) whose name is written nowhere is an
  orphan — dead exposition surface — flagged at the registration;
- a write or registration whose name is **not a string literal** is
  invisible to static checking — flagged so it either becomes a
  literal or carries an allow() explaining the dynamism.

This supersedes the breadth half of the dynamic registry-coverage test
(tests/test_observability.py) and catches what that test cannot:
metrics only written on error paths a test never drives.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from ..core import Finding, Project

RULE_ID = "metric-hygiene"

WRITE_METHODS = {"increment_counter", "add_counter",
                 "delta_up_down_counter", "record_histogram", "set_gauge"}
REG_METHODS = {"new_counter", "new_up_down_counter", "new_histogram",
               "new_gauge"}


@dataclass
class _Site:
    names: tuple[str, ...] | None   # None: dynamic (non-literal) name
    method: str
    rel: str
    line: int
    col: int


def _loop_bindings(tree: ast.Module) -> dict[str, tuple[str, ...]]:
    """Unroll the repo's registration idiom statically:

        for name, desc in (("app_x", "..."), ("app_y", "...")):
            metrics.new_gauge(name, desc)

    (also via a module-level constant: ``for name, desc in _GAUGES:``).
    Maps loop-variable name -> every constant string it binds. A
    module-wide map is an approximation (loop vars could collide across
    functions), biased toward fewer false "dynamic name" findings.
    """
    consts: dict[str, ast.expr] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            consts[node.targets[0].id] = node.value
    out: dict[str, set[str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.For):
            continue
        it = node.iter
        if isinstance(it, ast.Name):
            it = consts.get(it.id)
        if not isinstance(it, (ast.Tuple, ast.List)):
            continue
        if isinstance(node.target, ast.Tuple):
            targets = [(i, t.id) for i, t in enumerate(node.target.elts)
                       if isinstance(t, ast.Name)]
        elif isinstance(node.target, ast.Name):
            targets = [(None, node.target.id)]
        else:
            continue
        for el in it.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                for pos, tname in targets:
                    if pos is None:
                        out.setdefault(tname, set()).add(el.value)
            elif isinstance(el, (ast.Tuple, ast.List)):
                for pos, tname in targets:
                    if pos is not None and pos < len(el.elts):
                        v = el.elts[pos]
                        if isinstance(v, ast.Constant) \
                                and isinstance(v.value, str):
                            out.setdefault(tname, set()).add(v.value)
    return {k: tuple(sorted(v)) for k, v in out.items()}


def _name_arg(call: ast.Call,
              loops: dict[str, tuple[str, ...]]) -> tuple[str, ...] | None:
    arg: ast.expr | None = None
    if call.args:
        arg = call.args[0]
    else:
        for kw in call.keywords:
            if kw.arg == "name":
                arg = kw.value
                break
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return (arg.value,)
    if isinstance(arg, ast.Name) and arg.id in loops:
        return loops[arg.id]
    return None


def collect_sites(project: Project) -> tuple[list[_Site], list[_Site]]:
    """All (writes, registrations) in the linted tree."""
    writes: list[_Site] = []
    regs: list[_Site] = []
    for mod in project.modules:
        loops = _loop_bindings(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            meth = node.func.attr
            if meth not in WRITE_METHODS and meth not in REG_METHODS:
                continue
            site = _Site(_name_arg(node, loops), meth, mod.rel,
                         node.lineno, node.col_offset)
            (writes if meth in WRITE_METHODS else regs).append(site)
    return writes, regs


def written_names(project: Project) -> set[str]:
    """The statically-extracted metric write surface — what the
    meta-test cross-checks against the dynamic registry-coverage scan."""
    writes, _ = collect_sites(project)
    return {n for w in writes if w.names for n in w.names}


def registered_names(project: Project) -> set[str]:
    _, regs = collect_sites(project)
    return {n for r in regs if r.names for n in r.names}


def run(project: Project, graph=None) -> list[Finding]:
    writes, regs = collect_sites(project)
    if not writes and not regs:
        return []
    reg_names = {n for r in regs if r.names for n in r.names}
    write_names = {n for w in writes if w.names for n in w.names}
    findings: list[Finding] = []
    for w in writes:
        if w.names is None:
            findings.append(Finding(
                RULE_ID, w.rel, w.line, w.col,
                f"metric name passed to {w.method}() is not a string "
                f"literal — static hygiene cannot verify it"))
            continue
        for n in w.names:
            if n not in reg_names:
                findings.append(Finding(
                    RULE_ID, w.rel, w.line, w.col,
                    f"metric '{n}' is written ({w.method}) but "
                    f"registered nowhere in the linted tree — a silent "
                    f"log-and-drop at runtime"))
    for r in regs:
        if r.names is None:
            findings.append(Finding(
                RULE_ID, r.rel, r.line, r.col,
                f"metric name passed to {r.method}() is not a string "
                f"literal — static hygiene cannot verify it"))
            continue
        for n in r.names:
            if n not in write_names:
                findings.append(Finding(
                    RULE_ID, r.rel, r.line, r.col,
                    f"metric '{n}' is registered ({r.method}) but "
                    f"written nowhere in the linted tree — orphaned "
                    f"exposition surface"))
    return findings
