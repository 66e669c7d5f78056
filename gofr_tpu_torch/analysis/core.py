"""gofrlint core: project loading, suppressions, findings, rule driver (the
port's copy of ``gofr_tpu/analysis/core.py``).

Stdlib-``ast`` only — the analyzer must run in CI before anything else
is importable, so it never imports the code it lints.

Suppression syntax (reason mandatory, same line as the finding)::

    self.metrics.add_counter("app_engine_h2d_transfers", 7.0)  \
        # gofrlint: allow(hot-path-purity) -- event-driven sync, not steady state

A suppression without a ``-- reason`` is itself an error finding
(rule ``bad-suppression``), so the escape hatch can't silently become
a blanket off-switch.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

SUPPRESS_RE = re.compile(
    r"#\s*gofrlint:\s*allow\(\s*([A-Za-z0-9_,\-\s*]+?)\s*\)"
    r"(?:\s*--\s*(.*\S))?")

BAD_SUPPRESSION = "bad-suppression"
PARSE_ERROR = "parse-error"


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    allow_reason: str | None = None

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "col": self.col, "message": self.message}
        if self.suppressed:
            d["suppressed"] = True
            d["allow_reason"] = self.allow_reason
        return d

    def render(self) -> str:
        tag = " (allowed: %s)" % self.allow_reason if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}{tag}"


@dataclass
class Suppression:
    line: int
    rules: tuple[str, ...]   # ("*",) allows every rule on the line
    reason: str | None

    def covers(self, rule: str) -> bool:
        return self.reason is not None and ("*" in self.rules
                                            or rule in self.rules)


@dataclass
class Module:
    path: Path          # real filesystem path
    rel: str            # display path (relative to lint root)
    source: str
    tree: ast.Module
    suppressions: dict[int, Suppression] = field(default_factory=dict)


def parse_suppressions(source: str) -> tuple[dict[int, Suppression], list[tuple[int, str]]]:
    """Scan raw lines for ``# gofrlint: allow(...)`` comments.

    Returns (line -> Suppression, [(line, problem), ...]); a missing or
    empty reason lands in the problems list and the suppression is
    recorded reason-less, so it covers nothing.
    """
    out: dict[int, Suppression] = {}
    problems: list[tuple[int, str]] = []
    comments: list[tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT and "gofrlint" in tok.string:
                comments.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # load_project already reports unparseable files
    for i, text in comments:
        m = SUPPRESS_RE.search(text)
        if m is None:
            if re.search(r"#\s*gofrlint", text):
                problems.append((i, "unparseable gofrlint comment "
                                    "(expected: # gofrlint: allow(<rule>) -- <reason>)"))
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = m.group(2)
        if not reason:
            problems.append((i, "suppression missing its mandatory "
                                "'-- <reason>' clause"))
            reason = None
        out[i] = Suppression(line=i, rules=rules, reason=reason)
    return out, problems


def iter_py_files(paths: Iterable[str | Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(f for f in p.rglob("*.py")
                                if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            files.append(p)
    # dedupe, stable order
    seen: set[Path] = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


@dataclass
class Project:
    modules: list[Module]
    errors: list[Finding]   # parse errors + bad suppressions

    def module_by_dotted(self) -> dict[str, Module]:
        """Map best-effort dotted module names (``gofr_tpu_torch.serving.engine``)
        to modules, for resolving intra-package ``from x import y``."""
        out: dict[str, Module] = {}
        for mod in self.modules:
            parts = list(Path(mod.rel).with_suffix("").parts)
            if parts and parts[-1] == "__init__":
                parts = parts[:-1]
            if parts:
                out[".".join(parts)] = mod
        return out


def load_project(paths: Iterable[str | Path],
                 root: Path | None = None) -> Project:
    root = (root or Path.cwd()).resolve()
    modules: list[Module] = []
    errors: list[Finding] = []
    for f in iter_py_files(paths):
        try:
            rel = str(f.resolve().relative_to(root))
        except ValueError:
            rel = str(f)
        try:
            source = f.read_text(encoding="utf-8")
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError) as exc:
            line = getattr(exc, "lineno", 1) or 1
            errors.append(Finding(PARSE_ERROR, rel, line, 0,
                                  f"cannot parse: {exc}"))
            continue
        sup, problems = parse_suppressions(source)
        for line, problem in problems:
            errors.append(Finding(BAD_SUPPRESSION, rel, line, 0, problem))
        modules.append(Module(path=f, rel=rel, source=source, tree=tree,
                              suppressions=sup))
    return Project(modules=modules, errors=errors)


def apply_suppressions(mod: Module, findings: list[Finding]) -> None:
    """Mark findings covered by a same-line allow() as suppressed, and
    flag allows that cover nothing (stale suppressions rot the ledger
    of reasons — they must be deleted when the finding goes away)."""
    for f in findings:
        sup = mod.suppressions.get(f.line)
        if sup is not None and sup.covers(f.rule):
            f.suppressed = True
            f.allow_reason = sup.reason


def unused_suppressions(mod: Module, findings: list[Finding]) -> list[Finding]:
    used = {f.line for f in findings if f.suppressed}
    out = []
    for line, sup in sorted(mod.suppressions.items()):
        if sup.reason is not None and line not in used:
            out.append(Finding(
                BAD_SUPPRESSION, mod.rel, line, 0,
                f"allow({','.join(sup.rules)}) suppresses nothing on this "
                f"line — delete it or fix the rule name"))
    return out


# ----------------------------------------------------------- AST helpers

def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def import_aliases(tree: ast.Module) -> dict[str, str]:
    """Local alias -> canonical dotted target, from top-level imports.

    ``import numpy as np`` -> {"np": "numpy"};
    ``from jax import numpy as jnp`` -> {"jnp": "jax.numpy"}.
    """
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    # ``import a.b`` binds ``a`` — a dotted use like
                    # ``a.b.c`` is already canonical
                    head = a.name.split(".")[0]
                    out[head] = head
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def canonical_call(call: ast.Call, aliases: dict[str, str]) -> str | None:
    """Resolve a call's dotted name through import aliases:
    ``np.asarray`` -> ``numpy.asarray`` when np aliases numpy."""
    name = call_name(call)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    target = aliases.get(head)
    if target is None:
        return name
    return target + ("." + rest if rest else "")
