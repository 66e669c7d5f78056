"""Paged KV cache primitives on the head-major pool (counterpart of
``gofr_tpu/ops/paged_kv.py``, bf16/f32 pools; the int8 ``{q, s}`` pool
is later work).

K/V live in a pool ``[L, Hkv, Np, pg, hd]``; each slot owns an ordered
list of page ids, its block table ``[Mp]``, with the out-of-range id
``Np`` for "unallocated". Writes through an OOB id are dropped, as the
JAX package's ``.at[...].set(mode="drop")`` drops them. PyTorch index
assignment faults on an out-of-range index (a device-side assert on
CUDA), so the writers here select the in-range rows first.

Unlike the JAX functions, which return new arrays, the writers update
the pool IN PLACE (and return it for symmetry): a per-step copy of a
multi-GiB pool is what the JAX engine avoided by donation.
"""

from __future__ import annotations

import torch


def pool_shape(pool: torch.Tensor) -> tuple:
    """[L, H, Np, pg, d] logical shape of the pool."""
    return tuple(pool.shape)


def pool_layer(pool: torch.Tensor, li: int) -> torch.Tensor:
    """Layer ``li``'s [H, Np, pg, d] slice — a view, what the paged
    attention wrapper takes as ``k_pool`` / ``v_pool``."""
    return pool[li]


def keep_index(pids: torch.Tensor, n_pages: int) -> torch.Tensor:
    """Flat indices of the entries of ``pids`` that name a real page
    (``0 <= pid < n_pages``). One host sync on CUDA; a caller writing
    several layers with the same ids computes it once and passes it as
    ``keep`` to :func:`pool_write`."""
    flat = pids.reshape(-1)
    return torch.nonzero((flat >= 0) & (flat < n_pages)).reshape(-1)


def pool_write(pool: torch.Tensor, li: int, pids: torch.Tensor,
               offs: torch.Tensor, rows: torch.Tensor,
               keep: torch.Tensor | None = None) -> torch.Tensor:
    """Write ``rows`` into layer ``li`` at (page, offset) coordinates,
    in place. ``pids``/``offs`` are [B] (decode) or [B, S] (chunk);
    ``rows`` is [*pids.shape, H, d]. Entries whose page id is out of
    range are dropped. Rows are cast to the pool dtype."""
    if keep is None:
        keep = keep_index(pids, pool.shape[2])
    n = pids.numel()
    p = pids.reshape(-1).index_select(0, keep)
    o = offs.reshape(-1).index_select(0, keep)
    r = rows.reshape(n, *rows.shape[-2:]).index_select(0, keep)
    pool[li][:, p, o] = r.transpose(0, 1).to(pool.dtype)   # [H, n, d]
    return pool


def scatter_chunk(pool: torch.Tensor, tables: torch.Tensor,
                  slab: torch.Tensor, offsets: torch.Tensor,
                  chunk_lens: torch.Tensor) -> torch.Tensor:
    """Write a chunk slab [L, P, S, H, d] whose row b covers logical
    positions ``[offsets[b], offsets[b] + chunk_lens[b])`` into the pool
    (in place), touching only the pages the chunk spans: positions past
    ``chunk_lens``, past the table, or whose table entry is the OOB id
    are dropped."""
    n_pages, pg = pool.shape[2], pool.shape[3]
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
    pool[:, :, p, o] = rows.transpose(1, 2).to(pool.dtype)   # [L, H, n, d]
    return pool


def pool_move_rows(pool: torch.Tensor, tables: torch.Tensor,
                   src_pos: torch.Tensor, dst_pos: torch.Tensor) -> torch.Tensor:
    """Move K/V rows between logical positions of each slot, over every
    layer, in place: row ``src_pos[b, k]`` -> ``dst_pos[b, k]`` through
    slot b's table (speculative verify compacts the accepted root-to-leaf
    path out of the node-indexed rows with it). Every source row is
    gathered before any row is written, so overlapping source and
    destination sets are safe. A destination outside the slot's table
    (the caller's "no move" sentinel) is dropped; its source may be
    anything (ids are clamped on read)."""
    n_pages, pg = pool.shape[2], pool.shape[3]
    mp = tables.shape[1]

    def coords(pos):
        pids = torch.gather(tables, 1, (pos // pg).clamp(0, mp - 1))
        pids = torch.where((pos >= 0) & (pos < mp * pg), pids,
                           torch.full_like(pids, n_pages))
        return pids.reshape(-1), (pos % pg).reshape(-1)

    s_pids, s_offs = coords(src_pos)
    d_pids, d_offs = coords(dst_pos)
    keep = keep_index(d_pids, n_pages)
    s_pids = s_pids.clamp(max=n_pages - 1).index_select(0, keep)
    rows = pool[:, :, s_pids, s_offs.index_select(0, keep)]   # a copy
    pool[:, :, d_pids.index_select(0, keep),
         d_offs.index_select(0, keep)] = rows
    return pool


def slot_view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Gather one layer's pool [H, Np, pg, d] into the dense slot view
    [B, Mp*pg, H, d]. Out-of-range table ids clamp to the last page;
    the caller masks those rows by length."""
    h, n_pages, pg, d = pool.shape
    b, mp = tables.shape
    safe = tables.clamp(max=n_pages - 1).long()
    return pool[:, safe].permute(1, 2, 3, 0, 4).reshape(b, mp * pg, h, d)
