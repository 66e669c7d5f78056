"""Rule ``kv-quant-boundary``: a copy of ``gofr_tpu/analysis/rules/kv_quant.py``
that also knows the port's pool writers and PyTorch's casts and reads.

The paged KV pool's representation — dtype, int8 codes, per-row
scales — is owned by the scatters/gathers in ``ops/paged_kv.py``,
which run INSIDE the jitted hot closures (quantize-on-write,
dequantize-in-kernel). Serving code violates that boundary when it:

1. casts a pool itself (``kc.astype(...)``, ``pool["q"].astype(...)``)
   — a dtype re-lay in the closure silently de-quantizes the pool or
   materialises a second full-size copy in HBM;
2. casts rows AT a scatter boundary
   (``scatter_chunk(kc, t, k.astype(kc.dtype), ...)``) — the cast
   belongs inside the scatter, where the quantized path replaces it
   with quantize-on-write; a caller-side cast bakes the plain-pool
   dtype into the closure and breaks the int8 layout;
3. reads a pool back to host (``np.asarray(pool)``,
   ``jax.device_get(kc)``, ``kc.block_until_ready()``) to dequantize
   or inspect it host-side — KV stays on device, always.

Detection is name-based (graph-free, same approximation as
``recompile-hazard``): an expression is pool-ish when its root name is
one of the pool spellings the serving/model layers use (``kc``/``vc``,
``kp``/``vp``, ``k_pool``/``v_pool``, ``k_cache``/``v_cache``,
``pool``), including ``self.``-attributes and the quantized pytree's
``["q"]``/``["s"]`` leaves.

The port's spellings: its pool writers (``rope_kv_write``,
``scatter_chunk_kv``, ``scatter_decode_kv``, ``kv_write``) own
quantize-on-write as JAX's scatters do; a cast is also ``.to(<dtype>)``
(a ``torch.<dtype>``, a ``dtype=`` keyword or a name ending in
``dtype``), ``.float()``, ``.half()`` or ``.bfloat16()``; a host read is
also ``.cpu()`` or ``.numpy()``.
"""

from __future__ import annotations

import ast

from ..core import Finding, Project, canonical_call, import_aliases

RULE_ID = "kv-quant-boundary"

#: pool spellings across engine/glue/model code
POOL_ROOTS = {"kc", "vc", "kp", "vp", "kp_all", "vp_all",
              "k_pool", "v_pool", "k_cache", "v_cache", "pool"}
#: the jitted pool writers that own quantize-on-write
WRITERS = {"scatter_prefill", "scatter_chunk", "scatter_decode",
           "pool_write", "rope_kv_write", "scatter_chunk_kv",
           "scatter_decode_kv", "kv_write"}
#: host-readback calls (canonical names after alias resolution)
HOST_READS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array",
              "jax.device_get"}
#: tensor methods that cast to a fixed dtype
TORCH_CASTS = {"float", "half", "bfloat16", "double"}
#: tensor methods that read back to the host
TORCH_HOST_READS = {"cpu", "numpy"}
TORCH_DTYPES = {"float32", "float", "float16", "half", "bfloat16",
                "float64", "double", "int8", "uint8", "int32", "int64",
                "float8_e4m3fn", "float8_e5m2"}


def _is_dtype(node: ast.AST) -> bool:
    """A dtype expression: ``torch.bfloat16``, ``kc.dtype``, ``dtype``."""
    if isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "torch":
            return node.attr in TORCH_DTYPES
        return node.attr.endswith("dtype")
    if isinstance(node, ast.Name):
        return node.id.endswith("dtype")
    return False


def _is_cast(node: ast.Call) -> bool:
    """``x.astype(...)``, ``x.to(<dtype>)``, ``x.float()`` / ``.half()`` /
    ``.bfloat16()``."""
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr == "astype":
        return True
    if fn.attr in TORCH_CASTS:
        return not node.args and not node.keywords
    if fn.attr == "to":
        return any(_is_dtype(a) for a in node.args) \
            or any(kw.arg == "dtype" for kw in node.keywords)
    return False


def _is_pool(node: ast.AST) -> bool:
    """True when ``node`` is a pool reference: a pool-root name, a
    ``self.<pool>`` attribute, or a subscript of one (``pool["q"]``,
    ``kc[li]``)."""
    if isinstance(node, ast.Name):
        return node.id in POOL_ROOTS
    if isinstance(node, ast.Attribute):
        return node.attr in POOL_ROOTS
    if isinstance(node, ast.Subscript):
        return _is_pool(node.value)
    return False


def _astype_calls(node: ast.AST):
    """Yield every cast call (``.astype`` and the torch casts of
    :func:`_is_cast`) inside ``node``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _is_cast(sub):
            yield sub


class _Scanner(ast.NodeVisitor):
    def __init__(self, mod, aliases: dict[str, str]) -> None:
        self.mod = mod
        self.aliases = aliases
        self.findings: list[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        # (1) pool.astype(...) / pool["q"].astype(...)
        if isinstance(fn, ast.Attribute) and _is_cast(node) \
                and _is_pool(fn.value):
            self._flag(node, "pool dtype cast in the hot closure — the "
                             "scatters own the pool representation "
                             "(quantize-on-write); drop the .astype")
        # (3) kc.block_until_ready() — host sync on the pool
        if isinstance(fn, ast.Attribute) \
                and fn.attr in ("block_until_ready",) \
                and _is_pool(fn.value):
            self._flag(node, "host sync on the KV pool in serving "
                             "code — KV stays on device")
        # (3) pool.cpu() / pool.numpy(): a torch host read of the pool
        if isinstance(fn, ast.Attribute) and fn.attr in TORCH_HOST_READS \
                and _is_pool(fn.value):
            self._flag(node, "host-side readback of the KV pool — "
                             "dequantization happens inside the jitted "
                             "gather (gather_view), never on host")
        # (3) np.asarray(pool) / jax.device_get(pool): the argument
        # must BE a pool reference — reading back kernel outputs that
        # merely close over a pool (np.asarray(fn(q, kp, vp))) is the
        # normal way offline profiling scripts check results
        name = canonical_call(node, self.aliases)
        if name in HOST_READS and any(_is_pool(a) for a in node.args):
            self._flag(node, "host-side readback of the KV pool — "
                             "dequantization happens inside the jitted "
                             "gather (gather_view), never on host")
        # (2) writer call with a cast argument
        wname = None
        if isinstance(fn, ast.Name):
            wname = fn.id
        elif isinstance(fn, ast.Attribute):
            wname = fn.attr
        if wname in WRITERS:
            for arg in list(node.args) + [kw.value
                                          for kw in node.keywords]:
                for cast in _astype_calls(arg):
                    self._flag(cast, f"dtype cast at the "
                               f"'{wname}' boundary — the scatter "
                               f"quantizes/casts on write; pass the "
                               f"raw rows")
        self.generic_visit(node)

    def _flag(self, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            RULE_ID, self.mod.rel, node.lineno, node.col_offset, msg))


def run(project: Project, graph=None) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules:
        aliases = import_aliases(mod.tree)
        scanner = _Scanner(mod, aliases)
        scanner.visit(mod.tree)
        findings.extend(scanner.findings)
    return findings
