"""Paged KV cache primitives on the head-major pool (counterpart of
``gofr_tpu/ops/paged_kv.py``: plain bf16/f32 pools and the int8
``{"q", "s"}`` pool).

K/V live in a pool ``[L, Hkv, Np, pg, hd]``; each slot owns an ordered
list of page ids, its block table ``[Mp]``, with the out-of-range id
``Np`` for "unallocated". Writes through an OOB id are dropped, as the
JAX package's ``.at[...].set(mode="drop")`` drops them. PyTorch index
assignment faults on an out-of-range index (a device-side assert on
CUDA), so the writers here select the in-range rows first.

Unlike the JAX functions, which return new arrays, the writers update
the pool IN PLACE (and return it for symmetry): a per-step copy of a
multi-GiB pool is what the JAX engine avoided by donation.

Quantized pools (``kv_dtype="int8"``) are a dict with JAX's keys,
``{"q": int8 [L, Hkv, Np, pg, hd], "s": float32 [L, Hkv, Np, pg, 1]}``:
narrow codes plus one scale per written row, ``max(amax, 1e-8) / 127``
(so a JAX pool converts leaf by leaf with ``torch.from_numpy``). Every
writer quantizes on write, through the same in-range selection for both
leaves; :func:`pool_move_rows` moves codes and scales as they are, and
:func:`slot_view` dequantizes in float32, as the kernels do.
"""

from __future__ import annotations

import torch

#: a pool is either a plain tensor or a dict with these two leaves
QUANT_KEYS = ("q", "s")
#: pool forms by ``kv_dtype``: the model's own dtype (``"bf16"``, as the
#: JAX engine names it) or int8 codes with a float32 scale per row
KV_DTYPES = ("bf16", "int8")


def is_quantized_pool(pool) -> bool:
    """True for the ``{"q": int8, "s": float32}`` quantized pool."""
    return isinstance(pool, dict)


def quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [..., d] -> (int8 codes [..., d], float32 scales [..., 1]):
    symmetric, ``scale = max(amax, 1e-8) / 127``, codes rounded half to
    even and clipped to ±127. Zero rows give all-zero codes, so fresh
    pages dequantize to exact zeros."""
    rf = rows.float()
    scale = rf.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
    codes = torch.round(rf / scale).clamp(-127, 127).to(torch.int8)
    return codes, scale


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Codes [..., d] * scales [..., 1] -> values [..., d] in ``dtype``."""
    return (codes.float() * scales).to(dtype)


def quantize_pool(pool: torch.Tensor) -> dict:
    """A plain pool [L, H, Np, pg, d] as the quantized dict (per-row
    scales)."""
    codes, scales = quantize_rows(pool)
    return {"q": codes, "s": scales}


def pool_shape(pool) -> tuple:
    """[L, H, Np, pg, d] logical shape of either pool form."""
    return tuple((pool["q"] if is_quantized_pool(pool) else pool).shape)


def pool_row_bytes(pool) -> int:
    """Device bytes of one KV row (one token, every layer and head, the
    K or the V side): a quantized row adds its float32 scale."""
    if is_quantized_pool(pool):
        n_layers, h, _, _, d = pool["q"].shape
        return n_layers * h * (d * pool["q"].element_size()
                               + pool["s"].element_size())
    n_layers, h, _, _, d = pool.shape
    return n_layers * h * d * pool.element_size()


def pool_layer(pool, li: int):
    """Layer ``li``'s [H, Np, pg, d] slice (views; a dict of both leaves
    for a quantized pool) — what the paged attention wrappers take as
    ``k_pool`` / ``v_pool``."""
    if is_quantized_pool(pool):
        return {k: pool[k][li] for k in QUANT_KEYS}
    return pool[li]


def keep_index(pids: torch.Tensor, n_pages: int) -> torch.Tensor:
    """Flat indices of the entries of ``pids`` that name a real page
    (``0 <= pid < n_pages``). One host sync on CUDA; a caller writing
    several layers with the same ids computes it once and passes it as
    ``keep`` to :func:`pool_write`."""
    flat = pids.reshape(-1)
    return torch.nonzero((flat >= 0) & (flat < n_pages)).reshape(-1)


def _set_rows(dst, index: tuple, rows: torch.Tensor) -> None:
    """``dst[index] = rows`` (rows [..., d], already selected in range),
    quantizing them first when ``dst`` is a quantized pool or layer."""
    if is_quantized_pool(dst):
        codes, scales = quantize_rows(rows)
        dst["q"][index] = codes
        dst["s"][index] = scales
    else:
        dst[index] = rows.to(dst.dtype)


def pool_write(pool, li: int, pids: torch.Tensor, offs: torch.Tensor,
               rows: torch.Tensor, keep: torch.Tensor | None = None):
    """Write ``rows`` into layer ``li`` at (page, offset) coordinates,
    in place. ``pids``/``offs`` are [B] (decode) or [B, S] (chunk);
    ``rows`` is [*pids.shape, H, d]. Entries whose page id is out of
    range are dropped. Rows are cast to the pool dtype, or quantized."""
    if keep is None:
        keep = keep_index(pids, pool_shape(pool)[2])
    n = pids.numel()
    p = pids.reshape(-1).index_select(0, keep)
    o = offs.reshape(-1).index_select(0, keep)
    r = rows.reshape(n, *rows.shape[-2:]).index_select(0, keep)
    _set_rows(pool_layer(pool, li), (slice(None), p, o),
              r.transpose(0, 1))                        # [H, n, d]
    return pool


def scatter_chunk(pool, tables: torch.Tensor, slab: torch.Tensor,
                  offsets: torch.Tensor, chunk_lens: torch.Tensor):
    """Write a chunk slab [L, P, S, H, d] whose row b covers logical
    positions ``[offsets[b], offsets[b] + chunk_lens[b])`` into the pool
    (in place), touching only the pages the chunk spans: positions past
    ``chunk_lens``, past the table, or whose table entry is the OOB id
    are dropped."""
    n_pages, pg = pool_shape(pool)[2:4]
    mp = tables.shape[1]
    s = slab.shape[2]
    ar = torch.arange(s, device=tables.device)
    pos = offsets[:, None] + ar[None, :]                          # [P, S]
    valid = ar[None, :] < chunk_lens[:, None]
    pids = torch.gather(tables, 1, (pos // pg).clamp(0, mp - 1))
    pids = torch.where(valid & (pos < mp * pg), pids,
                       torch.full_like(pids, n_pages))
    offs = pos % pg
    keep = keep_index(pids, n_pages)
    p = pids.reshape(-1).index_select(0, keep)
    o = offs.reshape(-1).index_select(0, keep)
    n_layers, n_rows = slab.shape[0], slab.shape[1] * s
    rows = slab.reshape(n_layers, n_rows, *slab.shape[3:]).index_select(1, keep)
    _set_rows(pool, (slice(None), slice(None), p, o),
              rows.transpose(1, 2))                     # [L, H, n, d]
    return pool


def pool_move_rows(pool, tables: torch.Tensor, src_pos: torch.Tensor,
                   dst_pos: torch.Tensor):
    """Move K/V rows between logical positions of each slot, over every
    layer, in place: row ``src_pos[b, k]`` -> ``dst_pos[b, k]`` through
    slot b's table (speculative verify compacts the accepted root-to-leaf
    path out of the node-indexed rows with it). Every source row is
    gathered before any row is written, so overlapping source and
    destination sets are safe. A destination outside the slot's table
    (the caller's "no move" sentinel) is dropped; its source may be
    anything (ids are clamped on read). A quantized pool moves its raw
    codes and their scales: no dequantize / requantize round trip."""
    n_pages, pg = pool_shape(pool)[2:4]
    mp = tables.shape[1]

    def coords(pos):
        pids = torch.gather(tables, 1, (pos // pg).clamp(0, mp - 1))
        pids = torch.where((pos >= 0) & (pos < mp * pg), pids,
                           torch.full_like(pids, n_pages))
        return pids.reshape(-1), (pos % pg).reshape(-1)

    s_pids, s_offs = coords(src_pos)
    d_pids, d_offs = coords(dst_pos)
    keep = keep_index(d_pids, n_pages)
    src = (slice(None), slice(None),
           s_pids.clamp(max=n_pages - 1).index_select(0, keep),
           s_offs.index_select(0, keep))
    dst = (slice(None), slice(None), d_pids.index_select(0, keep),
           d_offs.index_select(0, keep))
    for leaf in (pool.values() if is_quantized_pool(pool) else (pool,)):
        leaf[dst] = leaf[src]                      # the gather is a copy
    return pool


def _gather(x: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    h, n_pages, pg, d = x.shape
    b, mp = tables.shape
    safe = tables.clamp(max=n_pages - 1).long()
    return x[:, safe].permute(1, 2, 3, 0, 4).reshape(b, mp * pg, h, d)


def slot_view(pool, tables: torch.Tensor) -> torch.Tensor:
    """Gather one layer's pool [H, Np, pg, d] into the dense slot view
    [B, Mp*pg, H, d]. Out-of-range table ids clamp to the last page;
    the caller masks those rows by length. A quantized layer
    dequantizes in float32 (``codes.float() * scales``), the values the
    kernels compute with."""
    if is_quantized_pool(pool):
        return _gather(pool["q"], tables).float() * _gather(pool["s"], tables)
    return _gather(pool, tables)
