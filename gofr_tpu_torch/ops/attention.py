"""Attention: plain PyTorch reference versions + flash kernel dispatch
(counterpart of ``gofr_tpu/ops/attention.py``).

Layouts follow the serving stack: ``q`` is ``[B, Sq, Hq, D]``,
``k``/``v`` are ``[B, Skv, Hkv, D]`` with grouped-query attention when
``Hq > Hkv``. Logits and softmax run in float32; outputs take q's
dtype.
"""

from __future__ import annotations

import torch

#: finite "minus infinity" for masked logits — the same value as the
#: JAX package, so fully-masked rows behave identically (see
#: ``xla_attention``'s note on kv_len == 0)
NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*group, D] for GQA (plain path only;
    the kernels read each KV head once per query-head group)."""
    if group == 1:
        return x
    return x.repeat_interleave(group, dim=2)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  kv_lengths: torch.Tensor | None = None,
                  q_offset: torch.Tensor | int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """Reference attention. q [B,Sq,Hq,D]; k,v [B,Skv,Hkv,D].

    ``q_offset``: absolute position of q row 0 (int or [B]). A row
    whose every column is masked (``kv_lengths[b] == 0``) softmaxes
    ``exp(NEG_INF - NEG_INF) = 1`` over all columns: the uniform average
    of V, exactly as the JAX reference does.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    k = _repeat_kv(k, group)
    v = _repeat_kv(v, group)
    scale = scale if scale is not None else d ** -0.5

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[None, :]           # [1, Sq]
    if isinstance(q_offset, int):
        q_pos = q_pos + q_offset
    else:
        q_pos = q_pos + q_offset[:, None]                        # [B, Sq]
    kv_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((q_pos.shape[0], sq, skv), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = kv_pos[None, None, :] <= q_pos[:, :, None]
    if kv_lengths is not None:
        mask = mask & (kv_pos[None, None, :] < kv_lengths[:, None, None])
    # a scalar fill: a tensor made from host data would be copied to the
    # card, and that copy waits for every queued kernel
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)


def tree_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   history_lens: torch.Tensor, chunk_lens: torch.Tensor,
                   tree_masks: torch.Tensor,
                   scale: float | None = None) -> torch.Tensor:
    """Draft-tree verify attention. q [B,Sq,Hq,D] holds Sq tree nodes
    per slot (topological order, node 0 = root); k/v [B,Skv,Hkv,D] hold
    the history followed by the tree nodes at rows
    ``[history_lens, history_lens + chunk_lens)``. Node i attends every
    history row plus exactly the in-tree rows whose bit is set in
    ``tree_masks[b, i]`` (packed ancestor-or-self bits over the in-chunk
    node index, so Sq <= 32). A row that sees nothing (padding with no
    history) returns zeros, as the kernel's denominator clamp does."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if sq > 32:
        raise ValueError(f"tree width {sq} exceeds the 32-node packed "
                         f"ancestor bitmask")
    group = hq // hkv
    k = _repeat_kv(k, group)
    v = _repeat_kv(v, group)
    scale = scale if scale is not None else d ** -0.5

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kv_pos = torch.arange(skv, device=q.device)[None, None, :]    # [1,1,Skv]
    rel = kv_pos - history_lens[:, None, None].long()              # [B,1,Skv]
    bit = (tree_masks[:, :, None].long() >> rel.clamp(0, 31)) & 1  # [B,Sq,Skv]
    visible = (rel < 0) | ((rel < chunk_lens[:, None, None]) & (bit == 1))
    logits = logits.masked_fill(~visible[:, None], NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    out = torch.where(visible.any(-1)[:, :, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_lengths: torch.Tensor,
                     scale: float | None = None,
                     block: int | None = None) -> torch.Tensor:
    """Single-step decode: q [B,1,Hq,D] against cache [B,Smax,Hkv,D];
    every row at position < kv_lengths[b] participates.

    The JAX version contracts in the cache dtype with float32
    accumulation; this plain version contracts in float32 throughout,
    which is the same arithmetic on float32 inputs and the tighter
    reference on bf16 ones.

    ``block``: attend ``block`` cache rows at a time with a running
    (online) softmax, blocks in order. A block whose every row is masked
    leaves the running max, sum and output bit for bit as they were
    (its weights are exact zeros), so the result does not depend on how
    many masked rows trail the cache: a decode window over the first
    ``n * block`` rows gives the full cache's bits.
    """
    if block is not None:
        return _decode_attention_blocked(q, k_cache, v_cache, kv_lengths,
                                         scale, block)
    b, sq, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qr = q.float().reshape(b, sq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr, k_cache.float()) * scale  # gofrlint: allow(kv-quant-boundary) -- torch.einsum has no preferred_element_type: the float32 operand is JAX's preferred_element_type=float32 product (gofr_tpu/ops/attention.py:138), exact for bf16 rows; plain path
    mask = torch.arange(smax, device=q.device)[None, :] < kv_lengths[:, None]
    logits = logits.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights, v_cache.float())  # gofrlint: allow(kv-quant-boundary) -- torch.einsum has no preferred_element_type: the float32 operand is JAX's preferred_element_type=float32 product (gofr_tpu/ops/attention.py:143); plain path
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _decode_attention_blocked(q, k_cache, v_cache, kv_lengths, scale,
                              block: int) -> torch.Tensor:
    b, sq, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qr = q.float().reshape(b, sq, hkv, group, d)
    m = total = acc = None
    for start in range(0, smax, block):
        stop = min(start + block, smax)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qr,
                              k_cache[:, start:stop].float()) * scale  # gofrlint: allow(kv-quant-boundary) -- one block's float32 operand, as JAX's preferred_element_type=float32 (gofr_tpu/ops/attention.py:138); plain path
        cols = torch.arange(start, stop, device=q.device)
        masked = cols[None, :] >= kv_lengths[:, None]
        # a scalar fill: nothing crosses from the host (the step is
        # captured in a CUDA graph)
        logits = logits.masked_fill(masked[:, None, None, None, :], NEG_INF)
        peak = logits.amax(-1, keepdim=True)
        m_new = peak if m is None else torch.maximum(m, peak)
        p = torch.exp(logits - m_new)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p,
                          v_cache[:, start:stop].float())  # gofrlint: allow(kv-quant-boundary) -- one block's float32 operand, as JAX's preferred_element_type=float32 (gofr_tpu/ops/attention.py:143); plain path
        if m is None:
            total, acc = p.sum(-1, keepdim=True), pv
        else:
            alpha = torch.exp(m - m_new)
            total = total * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + pv
        m = m_new
    out = (acc / total).permute(0, 3, 1, 2, 4)              # [B,Sq,Hkv,G,D]
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              kv_lengths: torch.Tensor | None = None,
              q_offset: torch.Tensor | int = 0,
              scale: float | None = None,
              implementation: str = "auto") -> torch.Tensor:
    """Prefill attention with implementation dispatch.

    ``"auto"``: the flash kernel's wrapper for causal, ``q_offset == 0``
    prefill (the wrapper launches the CUDA kernel for CUDA tensors and
    runs its plain version for CPU tensors); the plain reference for
    every other shape of call, as in the JAX package. ``"plain"``
    forces the plain reference on any device — the comparison path.
    """
    if implementation not in ("auto", "plain"):
        raise ValueError(f"implementation must be 'auto' or 'plain', "
                         f"got {implementation!r}")
    if (implementation == "auto" and causal and isinstance(q_offset, int)
            and q_offset == 0):
        from .flash_attention import flash_attention
        return flash_attention(q, k, v, kv_lengths=kv_lengths, scale=scale)
    return xla_attention(q, k, v, causal=causal, kv_lengths=kv_lengths,
                         q_offset=q_offset, scale=scale)
