"""Llama-3-family decoder (counterpart of ``gofr_tpu/models/llama.py``).

Parameters are a plain dict with the JAX package's structure: stacked
per-layer weights under ``"layers"`` (leading ``L`` axis), plain matrices
in ``[in, out]`` layout so their products read ``x @ w``; quantized
matrices (``{"q", "s"}`` leaves) are stored ``[out, in]`` and read
``x @ w.T``. Layers run as a Python loop over the stacked weights
(``layers[name][li]`` is a view). bf16 params/activations, float32
norms/softmax/logits. Every matrix product and the embedding gather go
through ``ops/quant.py``
(``qmatmul`` / ``qmatmul_t`` / ``qgather``), so a tree quantized by
``quantize_llama_int8`` / ``_int4`` (``{"q", "s"}`` leaves) runs the same
functions: on CUDA its decode-sized products and every LM head through
the weight-dequantizing GEMM kernel ``csrc/wq_gemm.cu``.

Tensor parallel (``tp=``, a ``parallel.comm.TensorParallel``):
``llama_prefill_last``, ``llama_decode_step`` and ``llama_prefill_chunk``
run on one rank's shards (``parallel/sharding.llama_param_specs``): its
q / k / v and ``w1`` / ``w3`` columns give its own heads and hidden
columns (the head counts come from the weights' widths), its ``wo`` /
``w2`` rows a partial sum that ``tp.reduce`` all-reduces; the embedding
is vocabulary-sharded (``tp.embed``) and the head's vocabulary columns
are all-gathered (``tp.logits``), so the logits come back whole on every
rank. Caches hold this rank's KV heads.

``implementation``: ``"auto"`` routes attention through the kernel
wrappers (the CUDA kernels for CUDA tensors, their plain versions for
CPU tensors); ``"plain"`` forces the plain PyTorch versions of the
attention, of the paged K/V write and of the quantized products on any
device — the path the kernels are held against.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache, partial

import torch

from ..device import resolve_device
from ..ops.attention import attention, decode_attention, tree_attention
from ..ops.norms import rms_norm
from ..ops.paged_attention import (paged_chunk_attention,
                                   paged_chunk_attention_plain,
                                   paged_decode_attention,
                                   paged_decode_attention_plain,
                                   paged_tree_attention,
                                   paged_tree_attention_plain)
from ..ops.paged_kv import (KV_DTYPES, keep_index, pool_layer, pool_shape,
                            quantize_rows, rope_kv_write,
                            rope_kv_write_plain)
from ..ops.quant import is_int4, is_quantized, qgather, qmatmul, qmatmul_t
from ..ops.rope import apply_rope, rope_frequencies

#: cache rows a dense decode step attends at a time: windows that are
#: multiples of it give the full cache's bits (``decode_attention``)
DECODE_BLOCK = 256


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: dict | None = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Test config: runs everywhere in milliseconds."""
        return cls(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_dim=128, max_seq=128,
                   dtype=torch.float32)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        """Llama-3-8B shape: the defaults."""
        return cls()

    @classmethod
    def llama3_70b(cls) -> "LlamaConfig":
        """Llama-3-70B shape."""
        return cls(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                   ffn_dim=28672)

    @classmethod
    def llama3_1b(cls) -> "LlamaConfig":
        """Llama-3.2-1B shape."""
        return cls(vocab_size=128256, dim=2048, n_layers=16, n_heads=32,
                   n_kv_heads=8, ffn_dim=8192, tie_embeddings=True)

    def scaled(self, **kw) -> "LlamaConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------- params

def llama_init(config: LlamaConfig, generator: torch.Generator,
               device: str | torch.device) -> dict:
    """Random-init parameters with stacked layer weights, drawn from
    ``generator`` (on the generator's device) and placed on
    ``device``. Same scales as the JAX ``llama_init``: N(0, 1/fan_in)
    matrices, N(0, 0.02²) embeddings, unit norms."""
    c = config
    hd = c.head_dim
    L = c.n_layers
    gdev = generator.device

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * std
        return x.to(device=device, dtype=c.dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=c.dtype)

    params = {
        "embed": normal((c.vocab_size, c.dim), 0.02),
        "layers": {
            "attn_norm": ones((L, c.dim)),
            "wq": normal((L, c.dim, c.n_heads * hd), c.dim ** -0.5),
            "wk": normal((L, c.dim, c.n_kv_heads * hd), c.dim ** -0.5),
            "wv": normal((L, c.dim, c.n_kv_heads * hd), c.dim ** -0.5),
            "wo": normal((L, c.n_heads * hd, c.dim),
                         (c.n_heads * hd) ** -0.5),
            "ffn_norm": ones((L, c.dim)),
            "w1": normal((L, c.dim, c.ffn_dim), c.dim ** -0.5),
            "w3": normal((L, c.dim, c.ffn_dim), c.dim ** -0.5),
            "w2": normal((L, c.ffn_dim, c.dim), c.ffn_dim ** -0.5),
        },
        "final_norm": ones((c.dim,)),
    }
    if not c.tie_embeddings:
        params["lm_head"] = normal((c.dim, c.vocab_size), c.dim ** -0.5)
    return params


def param_count(params: dict) -> int:
    """Parameters in a tree, as the JAX ``param_count`` counts its
    leaves: a quantized leaf counts its codes (int4 codes unpacked, two
    a byte) and its scales."""
    total = 0
    for leaf in params.values():
        if is_quantized(leaf):
            total += leaf["q"].numel() * (2 if is_int4(leaf) else 1) \
                + leaf["s"].numel()
        elif isinstance(leaf, dict):
            total += param_count(leaf)
        else:
            total += leaf.numel()
    return total


def _inv_freq(c: LlamaConfig, device: torch.device) -> torch.Tensor:
    """The config's inverse RoPE frequencies on ``device``: a constant,
    built once and not inside every step (a CUDA graph of the decode
    step then holds no set-up work). Callers only read it."""
    return _rope_table(c.head_dim, c.rope_theta,
                       tuple(sorted((c.rope_scaling or {}).items())),
                       torch.device(device))


@lru_cache(maxsize=16)
def _rope_table(head_dim, theta, scaling, device) -> torch.Tensor:
    return rope_frequencies(head_dim, theta, dict(scaling) or None,
                            device=device)


def _layer(params: dict, li: int) -> dict:
    """Layer ``li``'s weights: views of the stacked leaves (a quantized
    leaf's codes and scales each sliced)."""
    return {name: ({"q": w["q"][li], "s": w["s"][li]} if is_quantized(w)
                   else w[li])
            for name, w in params["layers"].items()}


def _mm(x: torch.Tensor, w, implementation: str = "auto") -> torch.Tensor:
    """x @ w: plain ``[in, out]`` weights in their dtype (bf16 in
    serving: float32 accumulation inside the GEMM, bf16 out), quantized
    ``[out, in]`` ones through ``qmatmul_t`` (the scale after the
    product; ``"plain"`` forces its plain version)."""
    if is_quantized(w):
        return qmatmul_t(x, w, plain=implementation == "plain")
    return qmatmul(x, w)


# --------------------------------------------------------------- forward

def _attn_block(x, lp, c: LlamaConfig, inv_freq, positions, kv_lengths,
                implementation):
    """Self-attention over a full prefill block -> (out, k, v)."""
    b, s, _ = x.shape
    hd = c.head_dim
    h = rms_norm(x, lp["attn_norm"], c.norm_eps)
    # heads from the weights' widths: a tensor-parallel rank's column
    # shards hold its own heads, and its ``wo`` rows give a partial sum
    q = _mm(h, lp["wq"], implementation).reshape(b, s, -1, hd)
    k = _mm(h, lp["wk"], implementation).reshape(b, s, -1, hd)
    v = _mm(h, lp["wv"], implementation).reshape(b, s, -1, hd)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    out = attention(q, k, v, causal=True, kv_lengths=kv_lengths,
                    implementation=implementation)
    return (_mm(out.reshape(b, s, -1), lp["wo"], implementation), k, v)


def _mlp_block(x, lp, c: LlamaConfig, implementation: str = "auto"):
    h = rms_norm(x, lp["ffn_norm"], c.norm_eps)
    gate = torch.nn.functional.silu(_mm(h, lp["w1"], implementation).float())
    up = _mm(h, lp["w3"], implementation).float()
    return _mm((gate * up).to(x.dtype), lp["w2"], implementation)


def _logits(params, c: LlamaConfig, x, implementation: str = "auto"):
    """Final norm + LM head, float32 logits. The tied head is
    ``x @ embed.T``, a quantized head (``[V, D]``, tied or not) too; on
    CUDA a bf16 head runs as a bf16 GEMM with a float32 output (float32
    accumulation, as the JAX head's ``preferred_element_type``), a
    quantized one through the kernel with a float32 output and scale."""
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    plain = implementation == "plain"
    head = params["embed"] if c.tie_embeddings else params["lm_head"]
    if c.tie_embeddings or is_quantized(head):   # [V, D]
        return qmatmul_t(x, head, out_dtype=torch.float32, plain=plain)
    return qmatmul(x, head, out_dtype=torch.float32)


def _embed(params, tokens: torch.Tensor, c: LlamaConfig, tp=None):
    """The embedding rows of ``tokens``; on a tp rank the sum of every
    rank's vocabulary shard (``tp.embed``)."""
    if tp is None:
        return qgather(params["embed"], tokens, c.dtype)
    return tp.embed(params["embed"], tokens, c.dtype)


def _reduce(x: torch.Tensor, tp, name: str) -> torch.Tensor:
    """A row-parallel product's partial summed over the tp ranks, in
    place (``name``: ``"wo"`` or ``"w2"``); the identity without tp."""
    return x if tp is None else tp.reduce(x, name)


def _head(params, c: LlamaConfig, x, implementation: str = "auto", tp=None):
    """:func:`_logits`, whole on every tp rank (``tp.logits``)."""
    logits = _logits(params, c, x, implementation)
    return logits if tp is None else tp.logits(logits)


def _backbone(params: dict, tokens: torch.Tensor, c: LlamaConfig,
              kv_lengths, implementation, constrain=None, tp=None):
    """Embedding + every block -> (hidden [B, S, D], (k, v) each
    [L, B, S, Hkv, hd]). ``constrain`` (optional) is applied to the
    residual activations after the embedding and after each block; ``tp``
    as in the module docstring."""
    b, s = tokens.shape
    inv_freq = _inv_freq(c, tokens.device)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = _embed(params, tokens, c, tp)
    if constrain is not None:
        x = constrain(x)
    ks, vs = [], []
    for li in range(c.n_layers):
        lp = _layer(params, li)
        attn_out, k, v = _attn_block(x, lp, c, inv_freq, positions,
                                     kv_lengths, implementation)
        x = x + _reduce(attn_out, tp, "wo")
        x = x + _reduce(_mlp_block(x, lp, c, implementation), tp, "w2")
        if constrain is not None:
            x = constrain(x)
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


def llama_decode_flops(config: LlamaConfig, context: int) -> float:
    """Floating-point operations of one decoded token (2 a
    multiply-add), the engine's MFU basis:

        2 * (L * (D*Hq*hd + 2*D*Hkv*hd + Hq*hd*D + 3*D*F) + D*V)
        + 4 * L * Hq * hd * context

    the products (q, k, v, o; w1, w3, w2; the LM head, tied or not: one
    ``D x V`` product either way) and attention's two products over
    ``context`` rows for every query head. Norms, RoPE, softmax and
    sampling are left out, as a compiler's cost analysis leaves out
    elementwise work."""
    c = config
    hd = c.head_dim
    products = c.n_layers * (c.dim * c.n_heads * hd
                             + 2 * c.dim * c.n_kv_heads * hd
                             + c.n_heads * hd * c.dim
                             + 3 * c.dim * c.ffn_dim) \
        + c.dim * c.vocab_size
    return float(2 * products + 4 * c.n_layers * c.n_heads * hd * context)


def llama_prefill(params: dict, tokens: torch.Tensor, config: LlamaConfig,
                  *, kv_lengths: torch.Tensor | None = None,
                  implementation: str = "auto", constrain=None):
    """Full-sequence forward: tokens [B, S] -> (logits [B, S, V]
    float32, (k, v) each [L, B, S, Hkv, hd]); ``kv_lengths`` [B] masks
    right-padded rows. ``constrain``: an optional function of the
    residual activations, applied after the embedding and after each
    block (JAX's hook, where the parallel layer pins its layouts);
    without it the forward is unchanged."""
    x, kv = _backbone(params, tokens, config, kv_lengths, implementation,
                      constrain)
    return _logits(params, config, x, implementation), kv


def llama_prefill_last(params: dict, tokens: torch.Tensor,
                       config: LlamaConfig, *, kv_lengths: torch.Tensor,
                       implementation: str = "auto", constrain=None,
                       tp=None):
    """Prefill for serving: logits only at each row's last prompt token.

    tokens [B, S], kv_lengths [B] int32 -> (last_logits [B, V] float32,
    (k, v) each [L, B, S, Hkv, hd]); ``constrain`` as in
    :func:`llama_prefill`; with ``tp`` the K/V hold this rank's heads.
    """
    x, kv = _backbone(params, tokens, config, kv_lengths, implementation,
                      constrain, tp)
    last = (kv_lengths.long() - 1).clamp(min=0)
    rows = x[torch.arange(x.shape[0], device=x.device), last]
    return _head(params, config, rows, implementation, tp), kv


def _writer(implementation: str, tokens: torch.Tensor, pids: torch.Tensor,
            n_pages: int):
    """(the per-layer RoPE + K/V write, its ``keep``): the fused kernel's
    wrapper for ``"auto"`` on CUDA (one launch a layer, no host sync;
    ``keep`` None), else the plain version (``apply_rope`` on q and k,
    then the plain write), which selects its rows once (one host sync on
    CUDA) for every layer."""
    if implementation == "auto" and tokens.device.type != "cpu":
        return rope_kv_write, None
    return rope_kv_write_plain, keep_index(pids, n_pages)


def llama_decode_step_paged(params: dict, tokens: torch.Tensor, k_pool,
                            v_pool, tables: torch.Tensor, lengths: torch.Tensor,
                            config: LlamaConfig, *,
                            implementation: str = "auto",
                            active: torch.Tensor | None = None):
    """One decode step straight against the paged KV pool.

    tokens [B]; pools [L, Hkv, Np, pg, hd] (head-major; plain, or the
    quantized ``{q, s}`` form, written quantized); tables [B, Mp] int32; lengths [B] int32 = rows already cached (the new token lands
    at that position). Each layer writes its new K/V row through the
    table — a row at or past the table's end, or on an unallocated page,
    or of a row whose ``active`` [B] bool entry is False, is dropped —
    then attends over ``lengths + 1`` rows. The pools are updated in
    place. On CUDA the step holds no host sync (the write kernel drops
    rows on the card), so it can be captured in a CUDA graph. Returns
    (logits [B, V] float32, k_pool, v_pool).
    """
    c = config
    b = tokens.shape[0]
    hd = c.head_dim
    n_pages, pg = pool_shape(k_pool)[2:4]
    mp = tables.shape[1]
    inv_freq = _inv_freq(c, tokens.device)
    positions = lengths[:, None]
    lens_long = lengths.long()
    pids = torch.gather(tables, 1,
                        (lens_long // pg).clamp(max=mp - 1)[:, None])[:, 0]
    inside = lens_long < mp * pg
    if active is not None:
        inside = inside & active
    pids = torch.where(inside, pids, torch.full_like(pids, n_pages))
    offs = lengths % pg
    write, keep = _writer(implementation, tokens, pids, n_pages)
    attend = lengths + 1
    decode_attn = (paged_decode_attention if implementation == "auto"
                   else paged_decode_attention_plain)

    x = qgather(params["embed"], tokens, c.dtype)[:, None, :]   # [B, 1, D]
    for li in range(c.n_layers):
        lp = _layer(params, li)
        h = rms_norm(x, lp["attn_norm"], c.norm_eps)
        q = _mm(h, lp["wq"], implementation).reshape(b, 1, c.n_heads, hd)
        k = _mm(h, lp["wk"], implementation).reshape(b, 1, c.n_kv_heads, hd)
        v = _mm(h, lp["wv"], implementation).reshape(b, 1, c.n_kv_heads, hd)
        q = write(q, k, v, positions, inv_freq, k_pool, v_pool, li, pids,
                  offs, keep=keep)
        out = decode_attn(q[:, 0].contiguous(), pool_layer(k_pool, li),
                          pool_layer(v_pool, li), tables, attend)
        x = x + _mm(out.reshape(b, 1, c.n_heads * hd), lp["wo"],
                    implementation)
        x = x + _mlp_block(x, lp, c, implementation)
    return _logits(params, c, x, implementation)[:, 0], k_pool, v_pool


def llama_prefill_chunk_paged(params: dict, tokens: torch.Tensor, k_pool,
                              v_pool, tables: torch.Tensor,
                              offsets: torch.Tensor,
                              chunk_lengths: torch.Tensor,
                              config: LlamaConfig, *,
                              implementation: str = "auto",
                              return_all_logits: bool = False,
                              tree_depths: torch.Tensor | None = None,
                              tree_masks: torch.Tensor | None = None):
    """One chunk of a chunked prefill straight against the paged pool.

    tokens [B, S] start at absolute positions ``offsets`` [B] int32 per
    row; pools [L, Hkv, Np, pg, hd] (head-major; plain or quantized, as
    in ``llama_decode_step_paged``); tables [B, Mp] int32.
    Each layer writes the chunk's K/V through the table — padding rows
    (past ``chunk_lengths[b]``) and rows past the table's end map to the
    OOB id and are dropped — then attends with the chunk kernel's
    wrapper over the slot's history and the chunk's causal prefix. The
    pools are updated in place. Returns (logits of each row's last valid
    position [B, V] float32 — or of every position [B, S, V] with
    ``return_all_logits``, for speculative verify — k_pool, v_pool); a
    ``chunk_lengths[b] == 0`` row's logits are garbage the caller
    discards.

    ``tree_depths`` / ``tree_masks`` [B, S] (both or neither) switch the
    chunk into draft-tree verify mode: RoPE at ``offsets + tree_depths``,
    K/V rows at the node index ``offsets + i``, attention through the
    tree kernel's wrapper and each node's packed ancestor mask.
    """
    if implementation not in ("auto", "plain"):
        raise ValueError(f"implementation must be 'auto' or 'plain', "
                         f"got {implementation!r}")
    if (tree_depths is None) != (tree_masks is None):
        raise ValueError("tree_depths and tree_masks go together")
    c = config
    b, s = tokens.shape
    hd = c.head_dim
    n_pages, pg = pool_shape(k_pool)[2:4]
    mp = tables.shape[1]
    inv_freq = _inv_freq(c, tokens.device)
    node_pos = offsets.long()[:, None] + torch.arange(
        s, device=tokens.device)[None, :]                           # [B, S]
    # RoPE positions (a tree node at its depth) apart from the rows the
    # K/V land on (the node index); int32, as the write kernel takes them
    positions = (node_pos if tree_depths is None
                 else offsets.long()[:, None] + tree_depths.long()
                 ).to(torch.int32)
    valid = torch.arange(s, device=tokens.device)[None, :] \
        < chunk_lengths[:, None]
    pids = torch.gather(tables, 1, (node_pos // pg).clamp(0, mp - 1))
    pids = torch.where(valid & (node_pos < mp * pg), pids,
                       torch.full_like(pids, n_pages))
    offs = (node_pos % pg).to(torch.int32)
    write, keep = _writer(implementation, tokens, pids, n_pages)
    if tree_masks is None:
        chunk_attn = (paged_chunk_attention if implementation == "auto"
                      else paged_chunk_attention_plain)
    else:
        chunk_attn = partial(paged_tree_attention if implementation == "auto"
                             else paged_tree_attention_plain,
                             tree_masks=tree_masks)

    x = qgather(params["embed"], tokens, c.dtype)               # [B, S, D]
    for li in range(c.n_layers):
        lp = _layer(params, li)
        h = rms_norm(x, lp["attn_norm"], c.norm_eps)
        q = _mm(h, lp["wq"], implementation).reshape(b, s, c.n_heads, hd)
        k = _mm(h, lp["wk"], implementation).reshape(b, s, c.n_kv_heads, hd)
        v = _mm(h, lp["wv"], implementation).reshape(b, s, c.n_kv_heads, hd)
        q = write(q, k, v, positions, inv_freq, k_pool, v_pool, li, pids,
                  offs, keep=keep)
        out = chunk_attn(q.contiguous(), pool_layer(k_pool, li),
                         pool_layer(v_pool, li), tables, offsets,
                         chunk_lengths)
        x = x + _mm(out.reshape(b, s, c.n_heads * hd), lp["wo"],
                    implementation)
        x = x + _mlp_block(x, lp, c, implementation)
    if return_all_logits:
        return _logits(params, c, x, implementation), k_pool, v_pool
    last = (chunk_lengths.long() - 1).clamp(min=0)
    rows = x[torch.arange(b, device=x.device), last]
    return _logits(params, c, rows, implementation), k_pool, v_pool


def _dense_write(cache: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
                 new: torch.Tensor, keep: torch.Tensor) -> None:
    """Write ``new`` [B, S, Hkv, hd] at rows ``at`` [B, S] (``rows`` the
    slot index [B, 1]) of one layer's dense cache [B, W, Hkv, hd], in
    place, where ``keep`` [B, S] holds; elsewhere the row is dropped. No
    host sync: the caller passes positions mod W, so a dropped row
    writes back what it reads at a row no kept row of its slot lands on
    while S <= W, and no two writes meet."""
    cache[rows, at] = torch.where(keep[..., None, None], new.to(cache.dtype),
                                  cache[rows, at])


def _dense_decode(params: dict, tokens: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, lengths: torch.Tensor,
                  c: LlamaConfig, attn_window: int | None, mlp, tp=None):
    """One decode step on dense caches with the family's ``mlp(x, lp)``
    (``llama_decode_step``, ``models/moe.moe_decode_step``); heads from
    the weights' widths, ``tp`` as in the module docstring."""
    b = tokens.shape[0]
    hd = c.head_dim
    width = k_cache.shape[2]
    inv_freq = _inv_freq(c, tokens.device)
    positions = lengths[:, None]
    keep = positions < width
    rows = torch.arange(b, device=tokens.device)[:, None]
    at = positions.long() % width
    attend = lengths + 1
    window = attn_window if attn_window is not None \
        and attn_window < width else width

    x = _embed(params, tokens, c, tp)[:, None, :]                # [B, 1, D]
    for li in range(c.n_layers):
        lp = _layer(params, li)
        h = rms_norm(x, lp["attn_norm"], c.norm_eps)
        q = _mm(h, lp["wq"]).reshape(b, 1, -1, hd)
        k = _mm(h, lp["wk"]).reshape(b, 1, -1, hd)
        v = _mm(h, lp["wv"]).reshape(b, 1, -1, hd)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        _dense_write(k_cache[li], rows, at, k, keep)
        _dense_write(v_cache[li], rows, at, v, keep)
        out = decode_attention(q, k_cache[li, :, :window],
                               v_cache[li, :, :window], attend,
                               block=DECODE_BLOCK)
        x = x + _reduce(_mm(out.reshape(b, 1, -1), lp["wo"]), tp, "wo")
        x = x + mlp(x, lp)
    return _head(params, c, x, tp=tp)[:, 0], k_cache, v_cache


def llama_decode_step(params: dict, tokens: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      lengths: torch.Tensor, config: LlamaConfig, *,
                      attn_window: int | None = None, tp=None):
    """One decode step against the dense cache (the slot layout, or the
    paged pool's dense view).

    tokens [B]; caches [L, B, S, Hkv, hd]; lengths [B] int32 = rows
    already cached (the new token lands at that position; a length at or
    past S drops the write). Each layer writes its new K/V row in place,
    then attends over ``lengths + 1`` rows of the cache's first
    ``attn_window`` rows (all S when None) with the plain
    ``decode_attention``, as the JAX step's XLA op, ``DECODE_BLOCK``
    rows at a time: a window gives the full cache's bits. No host sync,
    so the engine captures it in a CUDA graph. Returns (logits [B, V]
    float32, k_cache, v_cache). ``tp``: as in the module docstring (the
    caches hold this rank's KV heads)."""
    c = config
    return _dense_decode(
        params, tokens, k_cache, v_cache, lengths, c, attn_window,
        lambda x, lp: _reduce(_mlp_block(x, lp, c), tp, "w2"), tp)


def llama_prefill_chunk(params: dict, tokens: torch.Tensor,
                        k_cache: torch.Tensor, v_cache: torch.Tensor,
                        offsets: torch.Tensor, chunk_lengths: torch.Tensor,
                        config: LlamaConfig, *,
                        implementation: str = "auto",
                        return_all_logits: bool = False,
                        tree_depths: torch.Tensor | None = None,
                        tree_masks: torch.Tensor | None = None, tp=None):
    """One chunk of a chunked prefill against the dense cache.

    tokens [B, S] start at absolute positions ``offsets`` [B] int32;
    caches [L, B, Smax, Hkv, hd]. Each layer writes the chunk's K/V at
    ``[offsets, offsets + chunk_lengths)`` in place — padding rows and
    rows at or past Smax are dropped — then attends causally over the
    history and the chunk (the plain attention, as the JAX function's
    ``q_offset`` call routes). Returns (logits of each row's last valid
    position [B, V] float32 — or of every position [B, S, V] with
    ``return_all_logits``, for speculative verify — k_cache, v_cache).

    ``tree_depths`` / ``tree_masks`` [B, S] (both or neither) switch the
    chunk into draft-tree verify mode: RoPE at ``offsets + tree_depths``,
    K/V rows at the node index ``offsets + i``, attention through
    ``tree_attention`` under each node's packed ancestor mask. ``tp``: as
    in the module docstring.
    """
    if implementation not in ("auto", "plain"):
        raise ValueError(f"implementation must be 'auto' or 'plain', "
                         f"got {implementation!r}")
    if (tree_depths is None) != (tree_masks is None):
        raise ValueError("tree_depths and tree_masks go together")
    c = config
    b, s = tokens.shape
    smax = k_cache.shape[2]
    if s > smax:
        raise ValueError(f"a chunk of {s} rows exceeds the cache's {smax}")
    hd = c.head_dim
    inv_freq = _inv_freq(c, tokens.device)
    ar = torch.arange(s, device=tokens.device)[None, :]
    node_pos = offsets.long()[:, None] + ar                         # [B, S]
    positions = node_pos if tree_depths is None \
        else offsets.long()[:, None] + tree_depths.long()
    keep = (ar < chunk_lengths[:, None]) & (node_pos < smax)
    rows = torch.arange(b, device=tokens.device)[:, None]
    at = node_pos % smax

    x = _embed(params, tokens, c, tp)                           # [B, S, D]
    for li in range(c.n_layers):
        lp = _layer(params, li)
        h = rms_norm(x, lp["attn_norm"], c.norm_eps)
        q = _mm(h, lp["wq"], implementation).reshape(b, s, -1, hd)
        k = _mm(h, lp["wk"], implementation).reshape(b, s, -1, hd)
        v = _mm(h, lp["wv"], implementation).reshape(b, s, -1, hd)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        _dense_write(k_cache[li], rows, at, k, keep)
        _dense_write(v_cache[li], rows, at, v, keep)
        if tree_masks is None:
            out = attention(q, k_cache[li], v_cache[li], causal=True,
                            q_offset=offsets, implementation=implementation)
        else:
            out = tree_attention(q, k_cache[li], v_cache[li],
                                 history_lens=offsets,
                                 chunk_lens=chunk_lengths,
                                 tree_masks=tree_masks)
        x = x + _reduce(_mm(out.reshape(b, s, -1), lp["wo"],
                            implementation), tp, "wo")
        x = x + _reduce(_mlp_block(x, lp, c, implementation), tp, "w2")
    if return_all_logits:
        return _head(params, c, x, implementation, tp), k_cache, v_cache
    last = (chunk_lengths.long() - 1).clamp(min=0)
    rows = x[torch.arange(b, device=x.device), last]
    return _head(params, c, rows, implementation, tp), k_cache, v_cache


def make_empty_cache(config: LlamaConfig, batch: int,
                     max_seq: int | None = None,
                     device: str | torch.device | None = None):
    """A zeroed dense K and V cache pair [L, batch, max_seq, Hkv, hd] in
    the model's dtype (``max_seq`` defaults to the config's) on
    ``device`` (default: CUDA, or raise): the slot layout, one
    contiguous run of rows per slot."""
    c = config
    shape = (c.n_layers, batch, max_seq or c.max_seq, c.n_kv_heads,
             c.head_dim)
    dev = resolve_device(device)
    return tuple(torch.zeros(shape, dtype=c.dtype, device=dev)
                 for _ in range(2))


def make_pool(config: LlamaConfig, n_pages: int, page: int,
              device: str | torch.device, kv_dtype: str = "bf16"):
    """A zeroed head-major K and V pool pair [L, Hkv, Np, pg, hd]: in
    the model's dtype for ``"bf16"``, or for ``"int8"`` the quantized
    form of those zeros (codes 0, scales ``1e-8 / 127``), as the JAX
    engine's ``_alloc_pool`` lays it out."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    c = config
    shape = (c.n_layers, c.n_kv_heads, n_pages, page, c.head_dim)
    if kv_dtype == "bf16":
        return tuple(torch.zeros(shape, dtype=c.dtype, device=device)
                     for _ in range(2))
    # quantize_pool of zeros, built without the zeros: every row's scale
    # is a zero row's
    _, scale = quantize_rows(torch.zeros(1, device=device))
    return tuple({"q": torch.zeros(shape, dtype=torch.int8, device=device),
                  "s": scale.expand(*shape[:-1], 1).contiguous()}
                 for _ in range(2))
