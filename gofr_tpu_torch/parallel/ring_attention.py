"""Ring attention: causal attention over sequence-sharded q/k/v
(counterpart of ``gofr_tpu/parallel/ring_attention.py``).

The sequence axis is sharded over the ``sp`` mesh axis: each rank holds
a contiguous sequence chunk, and K/V chunks rotate around the ring
(``comm.ppermute``, whose backward sends each gradient back the other
way round, as JAX transposes ``ppermute``) while a running online
softmax merges the partial results, so no rank holds the [S, S] scores.

Causality across chunks: with chunk index ``r`` (this rank) and the K/V
chunk currently held originating from rank ``src``, the block is
- fully visible when ``src < r`` (entirely in the past),
- causal-diagonal when ``src == r``,
- fully masked when ``src > r`` (entirely in the future), zero-weighted
  as in JAX (its scores are ``NEG_INF``, so its merge weight is 0).
"""

from __future__ import annotations

import torch

from . import comm
from .mesh import Mesh

NEG_INF = -1e30
FULL, DIAGONAL, MASKED = 0, 1, 2


def _block_mode(src: int, rank: int) -> int:
    return DIAGONAL if src == rank else (FULL if src < rank else MASKED)


def _block_attend(q, k, v, scale, row_off, col_off, mode):
    """Partial attention of q against one k/v block with running-softmax
    stats. mode: 0 full, 1 diagonal-causal, 2 masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, skv = q.shape[1], k.shape[1]
    row = row_off + torch.arange(sq, device=q.device)
    col = col_off + torch.arange(skv, device=q.device)
    if mode == MASKED:
        mask = torch.zeros((sq, skv), dtype=torch.bool, device=q.device)
    elif mode == DIAGONAL:
        mask = col[None, :] <= row[:, None]
    else:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    s = s.masked_fill(~mask[None, None], NEG_INF)
    m = s.amax(dim=-1)                                        # [b,h,q]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, axis_name: str = "sp",
                   scale: float | None = None) -> torch.Tensor:
    """Causal attention inside a rank: q/k/v [B, S_local, H, D] are this
    rank's sequence chunk along ``axis_name``; returns the local output
    chunk."""
    ring = mesh.size(axis_name)
    rank = mesh.coord(axis_name)
    b, s_local, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5

    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32,
                      device=q.device)
    m_run = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, s_local), dtype=torch.float32,
                        device=q.device)

    row_off = rank * s_local
    k_cur, v_cur = k, v
    src = rank  # origin of the k/v chunk currently held
    perm = [(i, (i + 1) % ring) for i in range(ring)]
    for step in range(ring):
        o_blk, m_blk, l_blk = _block_attend(q, k_cur, v_cur, scale, row_off,
                                            src * s_local,
                                            _block_mode(src, rank))
        o_blk = o_blk.movedim(1, 2)   # [b,q,h,d] -> [b,h,q,d]
        m_new = torch.maximum(m_run, m_blk)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m_blk - m_new)
        acc = acc * alpha[..., None] + o_blk * beta[..., None]
        l_run = l_run * alpha + l_blk * beta
        m_run = m_new
        if step < ring - 1:
            # rotate k/v to the next rank; the origin rotates with them
            k_cur = comm.ppermute(k_cur, mesh, axis_name, perm)
            v_cur = comm.ppermute(v_cur, mesh, axis_name, perm)
            src = (src - 1) % ring

    out = acc / l_run.clamp(min=1e-30)[..., None]     # [b,h,q,d]
    return out.movedim(1, 2).to(q.dtype)              # [b,q,h,d]


def make_ring_attention(mesh: Mesh, axis_name: str = "sp"):
    """Sequence-sharded causal attention over the mesh: takes the global
    [B, S, H, D] arrays (the same on every rank of the axis), runs this
    rank's chunk around the ring and returns the global output on every
    rank; gradients reach the global inputs whole."""

    def apply(q, k, v):
        q, k, v = (comm.split(t.to(mesh.device), mesh, axis_name, 1)
                   for t in (q, k, v))
        out = ring_attention(q, k, v, mesh=mesh, axis_name=axis_name)
        return comm.gather(out, mesh, axis_name, 1)

    return apply
