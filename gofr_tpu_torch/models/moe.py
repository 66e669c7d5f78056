"""Mixtral-style MoE decoder: Llama attention and the sparse expert MLP
(counterpart of ``gofr_tpu/models/moe.py``).

Parameters are the Llama dict (``models/llama.py``) with the MLP
replaced per layer by a router ``gate`` [L, D, E] and the experts'
``w1`` / ``w3`` [L, E, D, F] and ``w2`` [L, E, F, D]. Attention is the
Llama block's: prefill through ``ops/attention.attention`` (the flash
kernel on CUDA), decode over the dense cache [L, B, S, Hkv, hd] through
``ops/attention.decode_attention``, as the reference's XLA op. The
expert products are the reference's: dense over every expert, in
float32 (``ops/moe.moe_layer``).

The decode step writes each slot's new K/V row at its length, in place;
a row at or past the cache's width is dropped, as JAX's scatter drops
it (the engine parks slots that must not write at ``max_seq``). It
holds no host sync, so the engine captures it in a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.moe import ExpertShard, moe_layer
from ..ops.norms import rms_norm
from ..ops.quant import qgather
from .llama import (LlamaConfig, _attn_block, _dense_decode, _inv_freq,
                    _layer, _logits)


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2

    @classmethod
    def tiny(cls) -> "MoEConfig":
        """Test config: runs everywhere in milliseconds."""
        return cls(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_dim=96, max_seq=128, n_experts=4,
                   top_k=2, dtype=torch.float32)

    @classmethod
    def mixtral_8x7b(cls) -> "MoEConfig":
        """Mixtral-8x7B shape."""
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, ffn_dim=14336, n_experts=8, top_k=2,
                   rope_theta=1e6)


def moe_init(config: MoEConfig, generator: torch.Generator,
             device: str | torch.device) -> dict:
    """Random-init parameters drawn from ``generator`` (on the
    generator's device) and placed on ``device``, with the reference's
    scales: N(0, 1/fan_in) matrices, N(0, 0.02²) embeddings, unit norms.
    Stacked matrices are drawn one layer at a time, so the float32 draw
    never holds more than a layer."""
    c = config
    hd = c.head_dim
    L, E = c.n_layers, c.n_experts
    gdev = generator.device

    def draw(shape, std):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * std
        return x.to(device=device, dtype=c.dtype)

    def normal(shape, std):
        out = torch.empty(shape, device=device, dtype=c.dtype)
        for li in range(shape[0]):
            out[li] = draw(shape[1:], std)
        return out

    def ones(shape):
        return torch.ones(shape, device=device, dtype=c.dtype)

    params = {
        "embed": draw((c.vocab_size, c.dim), 0.02),
        "layers": {
            "attn_norm": ones((L, c.dim)),
            "wq": normal((L, c.dim, c.n_heads * hd), c.dim ** -0.5),
            "wk": normal((L, c.dim, c.n_kv_heads * hd), c.dim ** -0.5),
            "wv": normal((L, c.dim, c.n_kv_heads * hd), c.dim ** -0.5),
            "wo": normal((L, c.n_heads * hd, c.dim),
                         (c.n_heads * hd) ** -0.5),
            "ffn_norm": ones((L, c.dim)),
            "gate": normal((L, c.dim, E), c.dim ** -0.5),
            "w1": normal((L, E, c.dim, c.ffn_dim), c.dim ** -0.5),
            "w3": normal((L, E, c.dim, c.ffn_dim), c.dim ** -0.5),
            "w2": normal((L, E, c.ffn_dim, c.dim), c.ffn_dim ** -0.5),
        },
        "final_norm": ones((c.dim,)),
    }
    if not c.tie_embeddings:
        params["lm_head"] = draw((c.dim, c.vocab_size), c.dim ** -0.5)
    return params


def moe_decode_flops(config: MoEConfig, context: int) -> float:
    """Floating-point operations of one decoded token (2 a
    multiply-add), the engine's MFU basis:

        2 * (L * (D*Hq*hd + 2*D*Hkv*hd + Hq*hd*D + 2*D*E + 3*D*F*E)
             + D*V) + 4 * L * Hq * hd * context

    the attention products, the router and the combine (D*E each), all
    E experts' three products (the step computes every expert, not only
    the top k), the LM head, and attention's two products over
    ``context`` rows for every query head."""
    c = config
    hd = c.head_dim
    products = c.n_layers * (c.dim * c.n_heads * hd
                             + 2 * c.dim * c.n_kv_heads * hd
                             + c.n_heads * hd * c.dim
                             + 2 * c.dim * c.n_experts
                             + 3 * c.dim * c.ffn_dim * c.n_experts) \
        + c.dim * c.vocab_size
    return float(2 * products + 4 * c.n_layers * c.n_heads * hd * context)


def _moe_mlp(x: torch.Tensor, lp: dict, c: MoEConfig, shard=None):
    """x [B, S, D] -> (MLP output [B, S, D], router logits [B, S, E])."""
    b, s, d = x.shape
    h = rms_norm(x, lp["ffn_norm"], c.norm_eps)
    out, router = moe_layer(h.reshape(b * s, d), lp["gate"], lp["w1"],
                            lp["w3"], lp["w2"], num_selected=c.top_k,
                            shard=shard)
    return out.reshape(b, s, d), router.reshape(b, s, -1)


def _expert_shard(mesh, c: MoEConfig):
    """The ``ExpertShard`` of this rank on ``mesh``'s expert axis (``ep``,
    else ``tp``, as ``moe_param_specs`` shards the experts), or None on a
    mesh without one. Attention stays replicated, as in JAX on a
    ``{dp, ep}`` mesh."""
    if mesh is None:
        return None
    from ..parallel import comm
    axis = "ep" if "ep" in mesh.axis_names else "tp"
    if axis not in mesh.axis_names:
        return None
    if mesh.size("tp") > 1:
        raise ValueError("moe_prefill(mesh=) shards the experts only; a "
                         "tensor-parallel attention is not supported")
    n = mesh.size(axis)
    if c.n_experts % n:
        raise ValueError(f"{c.n_experts} experts over {axis}={n}")
    return ExpertShard(first=mesh.coord(axis) * (c.n_experts // n),
                       copy=lambda t: comm.copy_to(t, mesh, axis),
                       reduce=lambda t: comm.reduce_from(t, mesh, axis))


def _moe_backbone(params: dict, tokens: torch.Tensor, c: MoEConfig,
                  kv_lengths, implementation: str, shard=None):
    """Embedding + every block -> (hidden [B, S, D], (k, v) each
    [L, B, S, Hkv, hd], router logits [L, B, S, E])."""
    b, s = tokens.shape
    inv_freq = _inv_freq(c, tokens.device)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = qgather(params["embed"], tokens, c.dtype)
    ks, vs, routers = [], [], []
    for li in range(c.n_layers):
        lp = _layer(params, li)
        attn_out, k, v = _attn_block(x, lp, c, inv_freq, positions,
                                     kv_lengths, implementation)
        x = x + attn_out
        mlp_out, router = _moe_mlp(x, lp, c, shard)
        x = x + mlp_out
        ks.append(k)
        vs.append(v)
        routers.append(router)
    return x, (torch.stack(ks), torch.stack(vs)), torch.stack(routers)


def moe_prefill(params: dict, tokens: torch.Tensor, config: MoEConfig, *,
                kv_lengths: torch.Tensor | None = None,
                implementation: str = "auto", mesh=None):
    """tokens [B, S] -> (logits [B, S, V] float32, (k, v) each [L, B, S,
    Hkv, hd], router logits [L, B, S, E]). ``mesh``: the expert-parallel
    step's (``parallel/``): ``params`` hold this rank's experts
    (``moe_param_specs``) and each layer's combine is summed over the
    expert axis with a differentiable all-reduce."""
    x, caches, router = _moe_backbone(params, tokens, config, kv_lengths,
                                      implementation,
                                      _expert_shard(mesh, config))
    return _logits(params, config, x, implementation), caches, router


def moe_prefill_last(params: dict, tokens: torch.Tensor, config: MoEConfig,
                     *, kv_lengths: torch.Tensor,
                     implementation: str = "auto"):
    """Serving prefill: logits only at each row's last prompt position
    -> (logits [B, V] float32, (k, v), router logits)."""
    x, caches, router = _moe_backbone(params, tokens, config, kv_lengths,
                                      implementation)
    last = (kv_lengths.long() - 1).clamp(min=0)
    rows = x[torch.arange(x.shape[0], device=x.device), last]
    return _logits(params, config, rows, implementation), caches, router


def moe_decode_step(params: dict, tokens: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    lengths: torch.Tensor, config: MoEConfig, *,
                    attn_window: int | None = None):
    """One decode step against the dense cache.

    tokens [B]; caches [L, B, S, Hkv, hd]; lengths [B] int32 = rows
    already cached (the new token lands at that position; a length at or
    past S drops the write). Each layer writes its new K/V row in place,
    then attends over ``lengths + 1`` rows of the cache's first
    ``attn_window`` rows (all S when None). Returns (logits [B, V]
    float32, k_cache, v_cache)."""
    c = config
    return _dense_decode(params, tokens, k_cache, v_cache, lengths, c,
                         attn_window, lambda x, lp: _moe_mlp(x, lp, c)[0])
