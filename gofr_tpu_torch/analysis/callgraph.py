"""Static call graph over the linted project — the approximation the
``hot-path-purity`` closure walks (the port's copy of
``gofr_tpu/analysis/callgraph.py``).

Resolution is deliberately conservative and syntactic:

- ``self.X(...)``      -> method ``X`` of the lexically enclosing class
- ``X(...)``           -> nested function in an enclosing scope, else a
                          module-level function in the same module, else
                          a same-project function imported via
                          ``from gofr_tpu_torch.mod import X``
- anything else (``obj.method()``, calls through containers, dynamic
  dispatch) is NOT followed — the forbidden-construct scanner still
  sees the call expression itself, so ``self.metrics.add_counter(...)``
  is caught as a metric write even though we never descend into the
  metrics manager.

Functions marked ``@hot_path_boundary(...)`` terminate traversal: they
are the engine's sanctioned retire/collect exits where host-side
assembly is the point.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from .annotations import BOUNDARY_ATTR, HOT_PATH_ATTR  # noqa: F401  (re-export for docs)
from .core import Module, Project, dotted_name

FuncDef = ast.FunctionDef | ast.AsyncFunctionDef


@dataclass(frozen=True)
class FuncKey:
    module: str          # Module.rel
    qualname: str        # "Engine._decode_step" / "helper" / "outer.<locals>.inner"

    def __str__(self) -> str:
        return f"{self.module}::{self.qualname}"


@dataclass
class FuncInfo:
    key: FuncKey
    node: FuncDef
    module: Module
    class_name: str | None
    hot_root: bool = False
    boundary: bool = False
    boundary_reason: str | None = None
    calls: list[tuple[FuncKey, ast.Call]] = field(default_factory=list)


def _decorator_name(dec: ast.expr) -> str | None:
    if isinstance(dec, ast.Call):
        dec = dec.func
    return dotted_name(dec)


def _is_hot_decorator(dec: ast.expr) -> bool:
    name = _decorator_name(dec)
    return name is not None and name.split(".")[-1] == "hot_path"


def _boundary_reason(dec: ast.expr) -> str | None:
    if not isinstance(dec, ast.Call):
        return None
    name = _decorator_name(dec)
    if name is None or name.split(".")[-1] != "hot_path_boundary":
        return None
    if dec.args and isinstance(dec.args[0], ast.Constant) \
            and isinstance(dec.args[0].value, str):
        return dec.args[0].value
    return ""  # boundary with a non-literal reason: treated as present


class _Collector(ast.NodeVisitor):
    """Index every function definition with its lexical context."""

    def __init__(self, mod: Module, graph: "CallGraph") -> None:
        self.mod = mod
        self.graph = graph
        self.class_stack: list[str] = []
        self.func_stack: list[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node: FuncDef) -> None:
        if self.func_stack:
            qual = ".".join(self.func_stack) + f".<locals>.{node.name}"
        elif self.class_stack:
            qual = ".".join(self.class_stack) + f".{node.name}"
        else:
            qual = node.name
        key = FuncKey(self.mod.rel, qual)
        info = FuncInfo(
            key=key, node=node, module=self.mod,
            class_name=self.class_stack[-1] if self.class_stack else None)
        for dec in node.decorator_list:
            if _is_hot_decorator(dec):
                info.hot_root = True
            reason = _boundary_reason(dec)
            if reason is not None:
                info.boundary = True
                info.boundary_reason = reason
        self.graph.add(info)
        self.func_stack.append(qual)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


class CallGraph:
    def __init__(self, project: Project) -> None:
        self.project = project
        self.funcs: dict[FuncKey, FuncInfo] = {}
        # (module_rel, class_name, method) -> key;  (module_rel, name) -> key
        self._methods: dict[tuple[str, str, str], FuncKey] = {}
        self._module_funcs: dict[tuple[str, str], FuncKey] = {}
        self._dotted = project.module_by_dotted()
        self._imports: dict[str, dict] = {}
        for mod in project.modules:
            _Collector(mod, self).visit(mod.tree)
        self._link()

    def add(self, info: FuncInfo) -> None:
        self.funcs[info.key] = info
        if info.class_name and "." not in info.key.qualname.replace(
                info.class_name + ".", "", 1):
            self._methods[(info.key.module, info.class_name,
                           info.node.name)] = info.key
        if info.class_name is None and "<locals>" not in info.key.qualname:
            self._module_funcs[(info.key.module, info.node.name)] = info.key

    # -- resolution ---------------------------------------------------

    def _resolve(self, info: FuncInfo, call: ast.Call) -> FuncKey | None:
        func = call.func
        # self.X(...)
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id in ("self", "cls")
                and info.class_name is not None):
            return self._methods.get(
                (info.key.module, info.class_name, func.attr))
        # bare X(...)
        if isinstance(func, ast.Name):
            # nested function within this function's scope chain
            qual = info.key.qualname
            while qual:
                cand = FuncKey(info.key.module,
                               f"{qual}.<locals>.{func.id}")
                if cand in self.funcs:
                    return cand
                if "." not in qual:
                    break
                qual = qual.rsplit(".", 1)[0]
                if qual.endswith("<locals>"):
                    qual = qual.rsplit(".", 1)[0]
            got = self._module_funcs.get((info.key.module, func.id))
            if got is not None:
                return got
            # from gofr_tpu_torch.x import y — follow into a sibling module
            target = self._import_target(info.module, func.id)
            if target is not None:
                return target
        return None

    def _import_target(self, mod: Module, name: str) -> FuncKey | None:
        for node, imported in self._from_imports(mod).get(name, ()):
            target_mod = self._find_from_module(mod, node)
            if target_mod is not None:
                return self._module_funcs.get((target_mod.rel, imported))
        return None

    def _from_imports(self, mod: Module) -> dict:
        """Bound name -> [(``ImportFrom`` node, imported name)] of a
        module, in ``ast.walk`` order; built once per module (a walk per
        call made large modules quadratic)."""
        got = self._imports.get(mod.rel)
        if got is None:
            got = {}
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ImportFrom):
                    for a in node.names:
                        got.setdefault(a.asname or a.name, []).append(
                            (node, a.name))
            self._imports[mod.rel] = got
        return got

    def _find_from_module(self, mod: Module,
                          node: ast.ImportFrom) -> Module | None:
        parts = list(Path(mod.rel).with_suffix("").parts)
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        if node.level:
            base = parts[:-(node.level)] if node.level <= len(parts) else []
            dotted = ".".join(base + (node.module.split(".") if node.module else []))
        else:
            dotted = node.module or ""
        return self._dotted.get(dotted)

    def _link(self) -> None:
        for info in self.funcs.values():
            for call in (n for n in ast.walk(info.node)
                         if isinstance(n, ast.Call)):
                target = self._resolve(info, call)
                if target is not None and target != info.key:
                    info.calls.append((target, call))

    # -- closure ------------------------------------------------------

    def hot_closure(self) -> dict[FuncKey, list[str]]:
        """Every function reachable from a ``@hot_path`` root without
        crossing a ``@hot_path_boundary``. Maps key -> a sample call
        chain (root-first qualnames) for diagnostics."""
        out: dict[FuncKey, list[str]] = {}
        stack: list[tuple[FuncKey, list[str]]] = [
            (k, [str(k)]) for k, f in self.funcs.items() if f.hot_root]
        while stack:
            key, chain = stack.pop()
            info = self.funcs.get(key)
            if info is None or key in out:
                continue
            if info.boundary and len(chain) > 1:
                continue  # sanctioned exit — do not descend
            out[key] = chain
            for callee, _ in info.calls:
                if callee not in out:
                    stack.append((callee, chain + [str(callee)]))
        return out
