"""Parameter sharding rules per model family (counterpart of
``gofr_tpu/parallel/sharding.py``).

Megatron-style tensor parallel layout for the Llama tree: column-
parallel up-projections (``wq``, ``wk``, ``wv``, ``w1``, ``w3`` shard
their output features over ``tp``), row-parallel down-projections
(``wo``, ``w2`` shard their input features), a vocabulary-sharded
embedding and head. The stacked layer axis (leading ``L``) shards over
``pp`` when the mesh has a pipeline axis: each stage holds a contiguous
slice of layers, which is what ``pipeline.py`` consumes.

The specs are JAX's, written for the ``[in, out]`` layout of plain
matrices. The choice of placement: a rank holds explicit per-rank
slices — :func:`shard_params` cuts each leaf to this rank's block and
copies it, so a shard's bytes are the leaf's over the product of its
sharded axes' sizes — and the forward passes name their collectives
(``comm.py``). DTensor would have been the closer counterpart of GSPMD,
but its propagation rules would decide which collective each op of the
plain model runs; here every collective is written where it runs.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.quant import is_int4, is_quantized
from .mesh import Mesh


class PartitionSpec(tuple):
    """Per dimension, the mesh axis it is sharded over (or a tuple of
    axes, or None): JAX's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _axis(mesh_axes: tuple, name: str) -> str | None:
    return name if name in mesh_axes else None


def llama_param_specs(mesh: Mesh) -> dict:
    """PartitionSpec tree matching llama_init's structure."""
    ax = mesh.axis_names
    tp = _axis(ax, "tp")
    pp = _axis(ax, "pp")
    specs = {
        "embed": P(tp, None),                 # vocab-sharded
        "layers": {
            "attn_norm": P(pp, None),
            "wq": P(pp, None, tp),            # column parallel
            "wk": P(pp, None, tp),
            "wv": P(pp, None, tp),
            "wo": P(pp, tp, None),            # row parallel
            "ffn_norm": P(pp, None),
            "w1": P(pp, None, tp),
            "w3": P(pp, None, tp),
            "w2": P(pp, tp, None),
        },
        "final_norm": P(None),
    }
    specs["lm_head"] = P(None, tp)
    return specs


def kv_cache_spec(mesh: Mesh) -> P:
    """Dense caches and prompt-KV slabs ``[L, B, S, Hkv, hd]``: KV heads
    over ``tp``, the rest replicated (JAX's ``_kv_sharding``)."""
    return P(None, None, None, _axis(mesh.axis_names, "tp"), None)


def kv_pool_spec(mesh: Mesh) -> P:
    """Head-major page pools ``[L, Hkv, Np, pg, hd]`` (and an int8 pool's
    scales ``[L, Hkv, Np, pg, 1]``): KV heads over ``tp``."""
    return P(None, _axis(mesh.axis_names, "tp"))


def moe_param_specs(mesh: Mesh) -> dict:
    """MoE params: experts sharded over ``ep`` (falling back to ``tp``)."""
    ax = mesh.axis_names
    tp = _axis(ax, "tp")
    pp = _axis(ax, "pp")
    ep = _axis(ax, "ep") or tp
    specs = {
        "embed": P(tp, None),
        "layers": {
            "attn_norm": P(pp, None),
            "wq": P(pp, None, tp),
            "wk": P(pp, None, tp),
            "wv": P(pp, None, tp),
            "wo": P(pp, tp, None),
            "ffn_norm": P(pp, None),
            "gate": P(pp, None, None),
            "w1": P(pp, ep, None, None),      # expert-sharded
            "w3": P(pp, ep, None, None),
            "w2": P(pp, ep, None, None),
        },
        "final_norm": P(None),
    }
    specs["lm_head"] = P(None, tp)
    return specs


def _match_specs(params: Any, specs: Any, transposed: bool = False) -> Any:
    """Prune the spec tree to the keys present in params (tied embeddings
    drop lm_head), descending into weight-only-quantized ``{'q','s'}``
    leaves: the codes keep the matrix spec, and the per-output-channel
    scales inherit it with the collapsed (size-1) axis unsharded, so
    int8 serving shards exactly like bf16. The port stores quantized
    layer matrices and an untied head output-major (``[.., out, in]``,
    ``ops/quant.py``), so their specs swap the last two entries."""
    if is_quantized(params) and not isinstance(specs, dict):
        spec = tuple(specs)
        if transposed and len(spec) >= 2:
            spec = spec[:-2] + (spec[-1], spec[-2])
        scale = params["s"]
        s_spec = P(*(None if scale.shape[i] == 1
                     else (spec[i] if i < len(spec) else None)
                     for i in range(scale.ndim)))
        return {"q": P(*spec), "s": s_spec}
    if isinstance(params, dict):
        return {k: _match_specs(v, specs[k],
                                transposed or k in ("layers", "lm_head"))
                for k, v in params.items()}
    return specs


class Sharding:
    """A placement: ``mesh`` and ``spec``. :meth:`index` is this rank's
    block of a global shape; :meth:`shard` cuts and copies it onto the
    mesh's device. (JAX's ``NamedSharding``.)"""

    def __init__(self, mesh: Mesh, spec) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def index(self, shape) -> tuple:
        out = []
        for d, n in enumerate(shape):
            axes = self.spec[d] if d < len(self.spec) else None
            if axes is None:
                out.append(slice(None))
                continue
            axes = axes if isinstance(axes, tuple) else (axes,)
            parts, pos = 1, 0
            for a in axes:   # row-major over the named axes
                parts *= self.mesh.size(a)
                pos = pos * self.mesh.size(a) + self.mesh.coord(a)
            if n % parts:
                raise ValueError(f"dim {d} of {tuple(shape)} not divisible "
                                 f"by {axes}={parts}")
            step = n // parts
            out.append(slice(pos * step, (pos + 1) * step))
        return tuple(out)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        block = x[self.index(x.shape)]
        if block.shape == x.shape:
            return x.to(self.device)
        return block.to(self.device, copy=True).contiguous()


def shard_params(params: Any, mesh: Mesh, specs: Any) -> Any:
    """This rank's shard of a param tree per the spec tree, on the mesh's
    device (a leaf's block copied out, so the full leaf can be freed).
    Int4 codes are packed two per byte along K: a split of K must leave
    each rank whole bytes."""
    specs = _match_specs(params, specs)

    def place(p, s):
        if is_quantized(p) and is_int4(p):
            try:
                return {k: place(v, s[k]) for k, v in p.items()}
            except ValueError as exc:
                raise ValueError(f"int4 codes are packed two per byte "
                                 f"along K, and a rank's block must be "
                                 f"whole bytes: {exc}") from None
        if isinstance(p, dict):
            return {k: place(v, s[k]) for k, v in p.items()}
        return Sharding(mesh, s).shard(p)

    return place(params, specs)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every leaf whole on the mesh's device (each rank a full copy)."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return tree.to(mesh.device)


def batch_spec(mesh: Mesh) -> P:
    """Input batch: sharded over dp (and sequence over sp if present)."""
    ax = mesh.axis_names
    return P(_axis(ax, "dp"), _axis(ax, "sp"))
