"""gofrlint — the repo-native AST invariant analyzer (the port's copy of
``gofr_tpu/analysis/``, whose three JAX-flavoured rules also know the
PyTorch spellings: ``rules/hot_path.py``, ``kv_quant.py``,
``recompile.py``).

The engine's hardest-won properties (zero steady-state h2d transfers,
host-side-only observability assembly, registry-covered metrics, no
per-request recompiles) are enforced dynamically by the transfer-guard
/ bit-identity / registry-coverage tests — which only fire if a test
drives the exact regressed path. gofrlint moves those invariants left:
stdlib-``ast`` static rules that fail CI the moment a diff introduces
the violation, before any test runs.

Rules (each in ``analysis/rules/``):

- ``hot-path-purity``   — ``@hot_path`` closure must not sync/log/meter
- ``lock-discipline``   — lockset approximation over class bodies
- ``blocking-in-async`` — no sync sleep/IO/HTTP inside ``async def``
- ``metric-hygiene``    — writes <-> registrations, both directions
- ``recompile-hazard``  — per-request data into jit static args

Plus the built-in ``bad-suppression`` (an ``allow()`` without a reason,
or one that suppresses nothing) and ``parse-error``.

Usage: ``python scripts/torch_lint.py gofr_tpu_torch/ scripts/torch_*.py`` or
programmatically via :func:`run_analysis`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

from .annotations import hot_path, hot_path_boundary
from .callgraph import CallGraph
from .core import (BAD_SUPPRESSION, PARSE_ERROR, Finding, Project,
                   apply_suppressions, load_project, unused_suppressions)
from .rules import ALL_RULES, RULE_IDS

__all__ = ["hot_path", "hot_path_boundary", "run_analysis", "Finding",
           "RULE_IDS", "BAD_SUPPRESSION", "PARSE_ERROR", "load_project"]


def run_analysis(paths: Iterable[str | Path], *,
                 rules: Iterable[str] | None = None,
                 root: Path | None = None) -> tuple[list[Finding], Project]:
    """Lint ``paths`` and return (findings, project).

    Findings covered by a same-line ``# gofrlint: allow(rule) -- reason``
    come back with ``suppressed=True`` (kept, so ``--format=json`` can
    audit the reason ledger); everything else is a violation. Parse
    errors, reason-less allows, and allows that cover nothing are
    violations under ``parse-error``/``bad-suppression``.
    """
    project = load_project(paths, root=root)
    graph = CallGraph(project)
    wanted = set(rules) if rules is not None else None
    findings: list[Finding] = list(project.errors)
    per_module: dict[str, list[Finding]] = {}
    for rule_mod in ALL_RULES:
        if wanted is not None and rule_mod.RULE_ID not in wanted:
            continue
        for f in rule_mod.run(project, graph):
            per_module.setdefault(f.path, []).append(f)
    for mod in project.modules:
        mod_findings = per_module.get(mod.rel, [])
        apply_suppressions(mod, mod_findings)
        findings.extend(mod_findings)
        if wanted is None:  # stale-allow audit only on full runs
            findings.extend(unused_suppressions(mod, mod_findings))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, project
