"""Rule ``lock-discipline`` (the port's copy of
``gofr_tpu/analysis/rules/locks.py``).

Lockset approximation over each class body: any attribute that is ever
mutated inside ``with self.<...lock...>:`` anywhere in the class is
treated as lock-protected; a mutation of that attribute outside a lock
context is flagged as a candidate race.

"Mutation" means ``self.x = / += ...``, ``self.x[...] = ...``,
``del self.x[...]``, and calls of container mutators
(``self.x.append(...)``, ``.pop``, ``.update``, ...).

Lock contexts (where mutation is legal):

- lexically inside a ``with`` whose context expression mentions a name
  containing ``lock`` (``self._lock``, ``self._slo_lock``,
  ``cv``/``Condition`` objects named ``*lock*``);
- methods named ``*_locked`` — the repo's convention for helpers that
  document "caller holds the lock" in their name;
- ``__init__``/``__new__``/``__enter__``/``__exit__``/``__del__`` and
  module-level class bodies — construction and teardown predate
  sharing.

This is deliberately a one-lockset-per-class approximation (classes
with several locks are treated as one). It trades soundness for
signal: with ~200 lock sites in the tree it is the strongest race
catcher available without a runtime TSan.
"""

from __future__ import annotations

import ast

from ..core import Finding, Project

RULE_ID = "lock-discipline"

MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
            "add", "remove", "discard", "pop", "popleft", "popitem",
            "clear", "update", "setdefault", "sort", "reverse"}
EXEMPT_METHODS = {"__init__", "__new__", "__enter__", "__exit__",
                  "__del__", "__post_init__"}


def _mentions_lock(node: ast.expr) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and "lock" in n.attr.lower():
            return True
        if isinstance(n, ast.Name) and "lock" in n.id.lower():
            return True
    return False


def _self_attr_target(node: ast.expr) -> str | None:
    """The attribute name when ``node`` mutates ``self.<attr>`` (plain,
    subscripted, or nested-subscript)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _Mutation:
    __slots__ = ("attr", "node", "locked", "establishes", "method", "kind")

    def __init__(self, attr: str, node: ast.AST, locked: bool,
                 establishes: bool, method: str, kind: str) -> None:
        self.attr = attr
        self.node = node
        self.locked = locked          # legal here (lock held or exempt)
        self.establishes = establishes  # proves the attr IS lock-protected
        self.method = method
        self.kind = kind


class _ClassScanner(ast.NodeVisitor):
    def __init__(self, class_name: str) -> None:
        self.class_name = class_name
        self.mutations: list[_Mutation] = []
        self._method: str | None = None
        self._lock_depth = 0
        self._method_exempt = False

    # -- context tracking
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_method(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_method(node)

    def _visit_method(self, node) -> None:
        if self._method is not None:
            # nested function: inherits the enclosing lock context
            self.generic_visit(node)
            return
        self._method = node.name
        self._method_exempt = (node.name in EXEMPT_METHODS
                               or node.name.endswith("_locked"))
        self.generic_visit(node)
        self._method = None
        self._method_exempt = False

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        return  # nested classes get their own scanner

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    def _visit_with(self, node) -> None:
        locked = any(_mentions_lock(item.context_expr)
                     for item in node.items)
        if locked:
            self._lock_depth += 1
        self.generic_visit(node)
        if locked:
            self._lock_depth -= 1

    @property
    def _locked(self) -> bool:
        return self._lock_depth > 0 or self._method_exempt \
            or self._method is None

    # -- mutation collection
    def _note(self, attr: str | None, node: ast.AST, kind: str) -> None:
        if attr is None or self._method is None:
            return
        # an actual `with ...lock:` block, or a helper whose name signs
        # the "caller holds the lock" contract, proves the attribute is
        # lock-protected; __init__-style exemptions prove nothing
        establishes = (self._lock_depth > 0
                       or (self._method or "").endswith("_locked"))
        self.mutations.append(_Mutation(attr, node, self._locked,
                                        establishes, self._method, kind))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                self._note(_self_attr_target(el), node, "assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._note(_self_attr_target(node.target), node, "assignment")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._note(_self_attr_target(node.target), node, "assignment")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._note(_self_attr_target(t), node, "delete")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
            self._note(_self_attr_target(f.value), node,
                       f".{f.attr}() mutation")
        self.generic_visit(node)


def run(project: Project, graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            scanner = _ClassScanner(node.name)
            for stmt in node.body:
                scanner.visit(stmt)
            lockset = {m.attr for m in scanner.mutations if m.establishes}
            for m in scanner.mutations:
                if m.locked or m.attr not in lockset:
                    continue
                findings.append(Finding(
                    RULE_ID, mod.rel, m.node.lineno, m.node.col_offset,
                    f"'{node.name}.{m.attr}' is written under "
                    f"'with ...lock:' elsewhere in this class but this "
                    f"{m.kind} in '{m.method}' is unlocked — a candidate "
                    f"race (hold the lock, or rename the helper "
                    f"'*_locked' if the caller holds it)"))
    return findings
