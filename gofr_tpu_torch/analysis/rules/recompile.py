"""Rule ``recompile-hazard``: a copy of ``gofr_tpu/analysis/rules/recompile.py``
that also treats a ``torch.compile`` wrapper as a jit.

The static sibling of the runtime RecompileSentinel: a ``jax.jit`` /
``pjit`` wrapper whose ``static_argnums``/``static_argnames`` position
is fed a value derived from per-request data recompiles once per
distinct value — the classic way a serving engine melts down under
real traffic (every novel prompt length or sampling param burns a
compile).

Detection (intra-function/intra-module approximation):

1. find wrappers: ``g = jax.jit(f, static_argnums=(1,))`` (also
   ``pjit``, also via ``functools.partial(jax.jit, ...)``) with
   statically-known static positions/names;
2. find calls of those wrappers visible in the same scope chain;
3. taint: an argument expression at a static position is per-request
   when it mentions a request-ish root (``req``, ``request``,
   ``prompt``, ``msg``, ``payload``, ``body``, ``sampling``/``params``
   attribute chains) or a direct ``len(...)`` of one.

Bucketing the value first (``self._bucket_for(len(prompt))``) breaks
the taint only when routed through a call — calls are opaque to the
taint walk by design, because bucketing IS the sanctioned fix.

``torch.compile`` has no static arguments: it specialises on every
Python ``int`` and ``bool`` it is given, so a per-request scalar
recompiles per value wherever it lands. A ``torch.compile`` wrapper
(assigned, through ``functools.partial``, or as a decorator) is checked
at every argument, and an argument is a per-request scalar when it is a
``len()``, ``int()`` or ``bool()`` of a per-request root, a comparison or
``not`` of one, or arithmetic on one. A per-request tensor (``req.tokens``)
passes: a tensor's value does not recompile.
"""

from __future__ import annotations

import ast

from ..core import Finding, Project, canonical_call, import_aliases

RULE_ID = "recompile-hazard"

JIT_FUNCS = {"jax.jit", "jax.pjit", "jit", "pjit",
             "jax.experimental.pjit.pjit"}
#: torch.compile specialises on Python scalars: every argument counts
TORCH_COMPILE_FUNCS = {"torch.compile"}
#: the spec of a torch.compile wrapper (no static argnums: all of them)
TORCH_SPEC = "torch.compile"
REQUEST_ROOTS = {"req", "request", "requests_in", "msg", "message",
                 "payload", "body", "prompt", "prompt_tokens", "params",
                 "sampling", "sampling_params"}


def _is_jit_call(node: ast.Call, aliases: dict[str, str],
                 funcs: set[str] = JIT_FUNCS) -> bool:
    name = canonical_call(node, aliases)
    if name is None:
        return False
    if name in funcs:
        return True
    # functools.partial(jax.jit, ...)
    if name in ("functools.partial", "partial") and node.args:
        inner = node.args[0]
        if isinstance(inner, (ast.Name, ast.Attribute)):
            fake = ast.Call(func=inner, args=[], keywords=[])
            return (canonical_call(fake, aliases) or "") in funcs
    return False


def _is_compile_call(node: ast.Call, aliases: dict[str, str]) -> bool:
    return _is_jit_call(node, aliases, TORCH_COMPILE_FUNCS)


def _is_compile_ref(node: ast.expr, aliases: dict[str, str]) -> bool:
    """A bare ``torch.compile`` (a decorator without arguments)."""
    if not isinstance(node, (ast.Name, ast.Attribute)):
        return False
    fake = ast.Call(func=node, args=[], keywords=[])
    return (canonical_call(fake, aliases) or "") in TORCH_COMPILE_FUNCS


def _scalar_taint(node: ast.AST) -> str | None:
    """A per-request root behind an expression that is a Python scalar:
    ``len()`` / ``int()`` / ``bool()`` of one, a comparison, ``not`` or
    arithmetic on one. A bare per-request name or attribute may be a
    tensor and does not count."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("len", "int", "bool"):
        for a in node.args:
            hit = _tainted(a)
            if hit:
                return hit
        return None
    if isinstance(node, (ast.Compare, ast.BoolOp, ast.BinOp)) or (
            isinstance(node, ast.UnaryOp)
            and isinstance(node.op, (ast.Not, ast.USub))):
        for child in ast.iter_child_nodes(node):
            hit = _tainted(child) if not isinstance(child, ast.Call) \
                else _scalar_taint(child)
            if hit:
                return hit
    return None


def _static_spec(node: ast.Call) -> tuple[list[int], list[str]] | None:
    """(positions, names) when the call carries static_argnums/names
    with literal values; None when it has none (not a hazard source)."""
    nums: list[int] = []
    names: list[str] = []
    found = False
    for kw in node.keywords:
        if kw.arg == "static_argnums":
            found = True
            nums.extend(_int_list(kw.value))
        elif kw.arg == "static_argnames":
            found = True
            names.extend(_str_list(kw.value))
    return (nums, names) if found else None


def _int_list(node: ast.expr) -> list[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [el.value for el in node.elts
                if isinstance(el, ast.Constant)
                and isinstance(el.value, int)]
    return []


def _str_list(node: ast.expr) -> list[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [el.value for el in node.elts
                if isinstance(el, ast.Constant)
                and isinstance(el.value, str)]
    return []


def _tainted(node: ast.AST) -> str | None:
    """A per-request root mentioned in ``node``, or None. Calls are
    opaque (routing a value through a bucketing helper breaks the
    taint — that is the sanctioned fix) except builtin ``len()``,
    which is transparent (``len(prompt)`` is still per-request)."""
    if isinstance(node, ast.Name):
        return node.id if node.id in REQUEST_ROOTS else None
    if isinstance(node, ast.Attribute):
        if node.attr in REQUEST_ROOTS:
            return node.attr
        return _tainted(node.value)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            for a in node.args:
                hit = _tainted(a)
                if hit:
                    return hit
        return None
    for child in ast.iter_child_nodes(node):
        hit = _tainted(child)
        if hit:
            return hit
    return None


class _ScopeScanner(ast.NodeVisitor):
    """One pass per module: record jit wrappers by assigned name, then
    flag tainted call sites of those wrappers."""

    def __init__(self, mod, aliases: dict[str, str]) -> None:
        self.mod = mod
        self.aliases = aliases
        self.wrappers: dict[str, tuple[list[int], list[str]]] = {}
        self.findings: list[Finding] = []

    # wrapper discovery: name = jax.jit(f, static_argnums=...), also the
    # two-step form name = functools.partial(jax.jit, static...)(f)
    def visit_Assign(self, node: ast.Assign) -> None:
        src = None
        if isinstance(node.value, ast.Call) and (
                _is_compile_call(node.value, self.aliases)
                or (isinstance(node.value.func, ast.Call)
                    and _is_compile_call(node.value.func, self.aliases))):
            for t in node.targets:
                tgt = t.id if isinstance(t, ast.Name) else \
                    t.attr if isinstance(t, ast.Attribute) else None
                if tgt:
                    self.wrappers[tgt] = TORCH_SPEC
        elif isinstance(node.value, ast.Call):
            if _is_jit_call(node.value, self.aliases):
                src = node.value
            elif isinstance(node.value.func, ast.Call) \
                    and _is_jit_call(node.value.func, self.aliases):
                src = node.value.func
        if src is not None:
            spec = _static_spec(src)
            if spec is not None:
                for t in node.targets:
                    tgt = None
                    if isinstance(t, ast.Name):
                        tgt = t.id
                    elif isinstance(t, ast.Attribute):
                        tgt = t.attr  # self._decode = jax.jit(...)
                    if tgt:
                        self.wrappers[tgt] = spec
        self.generic_visit(node)

    def _visit_def(self, node) -> None:
        # @torch.compile / @torch.compile(...) on a def: the def's name
        # is a wrapper
        for dec in node.decorator_list:
            if _is_compile_ref(dec, self.aliases) or (
                    isinstance(dec, ast.Call)
                    and _is_compile_call(dec, self.aliases)):
                self.wrappers[node.name] = TORCH_SPEC
        self.generic_visit(node)

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_Call(self, node: ast.Call) -> None:
        # torch.compile(f)(a, b): every argument
        if isinstance(node.func, ast.Call) \
                and _is_compile_call(node.func, self.aliases):
            self._check(node, TORCH_SPEC, "wrapped callable")
        # direct immediate invocation: jax.jit(f, static_argnums=(1,))(a, b)
        if isinstance(node.func, ast.Call) \
                and _is_jit_call(node.func, self.aliases):
            spec = _static_spec(node.func)
            if spec is not None:
                self._check(node, spec, "jit-wrapped callable")
        # call of a recorded wrapper name
        name = None
        if isinstance(node.func, ast.Name):
            name = node.func.id
        elif isinstance(node.func, ast.Attribute):
            name = node.func.attr
        if name in self.wrappers:
            self._check(node, self.wrappers[name], f"'{name}'")
        self.generic_visit(node)

    def _check(self, call: ast.Call, spec, label: str) -> None:
        if spec == TORCH_SPEC:
            self._check_compiled(call, label)
            return
        nums, names = spec
        # static positions count the wrapped fn's first arg as 0; at a
        # wrapper call site positions map 1:1
        for pos in nums:
            if pos < len(call.args):
                root = _tainted(call.args[pos])
                if root:
                    self._flag(call, label, f"positional arg {pos}", root)
        for kw in call.keywords:
            if kw.arg in names:
                root = _tainted(kw.value)
                if root:
                    self._flag(call, label, f"keyword '{kw.arg}'", root)

    def _check_compiled(self, call: ast.Call, label: str) -> None:
        for pos, arg in enumerate(call.args):
            root = _scalar_taint(arg)
            if root:
                self._flag_compiled(call, label, f"positional arg {pos}",
                                    root)
        for kw in call.keywords:
            root = _scalar_taint(kw.value)
            if root:
                self._flag_compiled(call, label, f"keyword '{kw.arg}'", root)

    def _flag_compiled(self, call: ast.Call, label: str, where: str,
                       root: str) -> None:
        self.findings.append(Finding(
            RULE_ID, self.mod.rel, call.lineno, call.col_offset,
            f"Python scalar ({where}) of torch.compile {label} derives "
            f"from per-request data ('{root}') — torch.compile "
            f"specialises on it, so every distinct value recompiles; "
            f"bucket it first or pass a tensor"))

    def _flag(self, call: ast.Call, label: str, where: str,
              root: str) -> None:
        self.findings.append(Finding(
            RULE_ID, self.mod.rel, call.lineno, call.col_offset,
            f"static arg ({where}) of {label} derives from per-request "
            f"data ('{root}') — every distinct value triggers a "
            f"recompile; bucket it first"))


def run(project: Project, graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules:
        aliases = import_aliases(mod.tree)
        scanner = _ScopeScanner(mod, aliases)
        scanner.visit(mod.tree)
        findings.extend(scanner.findings)
    return findings
