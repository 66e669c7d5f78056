"""Rule ``hot-path-purity``: a copy of ``gofr_tpu/analysis/rules/hot_path.py``
that also knows the PyTorch spellings of a device sync.

Functions marked ``@hot_path`` — and everything they statically call
within the package (see ``callgraph.py`` for the resolution
approximation) — must stay dispatch-bound: no device syncs, no wall
clock, no logging, no metric writes. The sanctioned exits are
``@hot_path_boundary`` functions (retire/collect/failure handling),
where the walk stops.

Forbidden constructs:

- ``<expr>.item()`` — a device sync, full stop.
- ``numpy.asarray(...)`` / ``numpy.array(...)`` — device->host copy
  when handed a jax array (``jnp.asarray`` stays on device and is
  allowed).
- ``jax.device_get`` / ``block_until_ready`` (function or method).
- PyTorch: ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``
  (or ``device="cpu"``), ``torch.cuda.synchronize()`` and a stream's or
  event's ``.synchronize()`` — each waits for the card.
- ``int()/float()/bool()`` applied *directly to a jax/jnp or torch call* — the
  statically-visible slice of "coercion of a traced value". Coercing a
  host value (``int(self.lengths[i])`` over a numpy mirror) is not
  flagged; the dynamic transfer-guard test still owns that blind spot.
- ``time.time()`` / ``datetime.now()/utcnow()`` — wall-clock reads;
  ``time.perf_counter`` / ``monotonic`` are the sanctioned timers and
  stay legal.
- logging calls (``logger.info`` etc., any receiver whose name says
  logger/logging/log).
- metric writes through the Manager API (``increment_counter``,
  ``add_counter``, ``delta_up_down_counter``, ``record_histogram``,
  ``set_gauge``).
"""

from __future__ import annotations

import ast

from ..callgraph import CallGraph, FuncKey
from ..core import Finding, Project, canonical_call, import_aliases

RULE_ID = "hot-path-purity"

METRIC_WRITES = {"increment_counter", "add_counter",
                 "delta_up_down_counter", "record_histogram", "set_gauge"}
LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
               "critical", "log", "fatal"}
LOG_RECEIVERS = {"logger", "logging", "log", "_logger", "_log"}
WALL_CLOCK = {"time.time", "datetime.now", "datetime.utcnow",
              "datetime.datetime.now", "datetime.datetime.utcnow"}
SYNC_FUNCS = {"numpy.asarray", "numpy.array", "jax.device_get",
              "jax.block_until_ready", "torch.cuda.synchronize"}
JAX_ROOTS = {"jax", "jax.numpy"}
TORCH_ROOTS = {"torch"}
#: tensor methods that copy to the host or wait for the card
TORCH_SYNC_METHODS = {"tolist", "cpu", "numpy", "synchronize"}


def _is_jax_expr(node: ast.expr, aliases: dict[str, str]) -> bool:
    """True when ``node`` is itself a call into jax/jnp — the static
    stand-in for "this expression is a traced value"."""
    if not isinstance(node, ast.Call):
        return False
    name = canonical_call(node, aliases)
    if name is None:
        return False
    head = name.rsplit(".", 1)[0] if "." in name else name
    return head in JAX_ROOTS or name.startswith("jax.")


def _is_torch_expr(node: ast.expr, aliases: dict[str, str]) -> bool:
    """True when ``node`` is itself a call into torch (``torch.sum(x)``):
    a tensor whose coercion to a Python scalar waits for the card."""
    if not isinstance(node, ast.Call):
        return False
    name = canonical_call(node, aliases)
    return name is not None and (name in TORCH_ROOTS
                                 or name.startswith("torch."))


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``: a device-to-host copy."""
    values = list(node.args[:1]) + [kw.value for kw in node.keywords
                                    if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and isinstance(v.value, str)
               and v.value.split(":")[0] == "cpu" for v in values)


def _receiver_is_logger(func: ast.Attribute) -> bool:
    base = func.value
    if isinstance(base, ast.Name):
        return base.id in LOG_RECEIVERS
    if isinstance(base, ast.Attribute):  # self.logger / app._logger / ctx.log
        return base.attr in LOG_RECEIVERS
    return False


def _scan_function(info, chain: list[str],
                   aliases: dict[str, str]) -> list[Finding]:
    out: list[Finding] = []
    mod = info.module
    via = "" if len(chain) == 1 else \
        " (on the hot path via %s)" % " -> ".join(
            c.split("::")[-1] for c in chain)

    def flag(node: ast.AST, what: str) -> None:
        out.append(Finding(
            RULE_ID, mod.rel, node.lineno, node.col_offset,
            f"{what} in hot-path function "
            f"'{info.key.qualname}'{via}"))

    for node in ast.walk(info.node):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        # <expr>.item()
        if isinstance(func, ast.Attribute) and func.attr == "item" \
                and not node.args and not node.keywords:
            flag(node, "device sync '.item()'")
            continue
        if isinstance(func, ast.Attribute) \
                and func.attr == "block_until_ready":
            flag(node, "device sync 'block_until_ready'")
            continue
        name = canonical_call(node, aliases)
        if name in SYNC_FUNCS:
            flag(node, f"device sync '{name}'")
            continue
        if isinstance(func, ast.Attribute) \
                and func.attr in TORCH_SYNC_METHODS:
            flag(node, f"device sync '.{func.attr}()'")
            continue
        if isinstance(func, ast.Attribute) and func.attr == "to" \
                and _to_cpu(node):
            flag(node, "device sync '.to(\"cpu\")'")
            continue
        if name in WALL_CLOCK:
            flag(node, f"wall-clock read '{name}' (use time.perf_counter "
                       "outside the hot path)")
            continue
        if isinstance(func, ast.Name) and func.id in ("int", "float", "bool") \
                and node.args and _is_jax_expr(node.args[0], aliases):
            flag(node, f"'{func.id}()' coerces a traced jax value "
                       "(implicit device sync)")
            continue
        if isinstance(func, ast.Name) and func.id in ("int", "float", "bool") \
                and node.args and _is_torch_expr(node.args[0], aliases):
            flag(node, f"'{func.id}()' coerces a torch tensor "
                       "(implicit device sync)")
            continue
        if isinstance(func, ast.Attribute) and func.attr in METRIC_WRITES:
            flag(node, f"metric write '.{func.attr}(...)'")
            continue
        if isinstance(func, ast.Attribute) and func.attr in LOG_METHODS \
                and _receiver_is_logger(func):
            flag(node, f"logging call '.{func.attr}(...)'")
            continue
    return out


def run(project: Project, graph: CallGraph) -> list[Finding]:
    findings: list[Finding] = []
    closure = graph.hot_closure()
    alias_cache: dict[str, dict[str, str]] = {}
    seen: set[tuple[str, int, int]] = set()  # nested defs walk twice
    for key, chain in sorted(closure.items(),
                             key=lambda kv: (kv[0].module, kv[0].qualname)):
        info = graph.funcs[key]
        aliases = alias_cache.setdefault(
            info.module.rel, import_aliases(info.module.tree))
        for f in _scan_function(info, chain, aliases):
            spot = (f.path, f.line, f.col)
            if spot not in seen:
                seen.add(spot)
                findings.append(f)
    return findings
