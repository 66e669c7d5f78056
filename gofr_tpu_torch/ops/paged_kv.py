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

The model steps' per-layer row write, :func:`kv_write` (and
:func:`pool_write`, :func:`scatter_chunk` and the prefill's
:func:`scatter_chunk_kv` on CUDA tensors), launches the hand-written kernel ``csrc/kv_write.cu``: K and
V in one launch, out-of-range rows dropped on the card and int8 rows
quantized there, so a decode step holds no host sync and can be
captured in a CUDA graph, and a prefill returns before the card is
done. CPU tensors take the plain versions below, which select the
in-range rows first.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

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
    amax = rf.abs().amax(-1, keepdim=True).clamp(min=1e-8)
    # a tensor divisor: PyTorch's CUDA kernels divide by a Python scalar
    # as a product with its reciprocal, one bit off the IEEE quotient
    # that the CPU, the JAX package and csrc/kv_write.cu compute
    scale = amax / torch.full_like(amax, 127.0)
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
    range are dropped. Rows are cast to the pool dtype, or quantized.

    CUDA tensors launch the ``kv_write`` kernel (K only; bf16 rows) or
    raise. CPU tensors run the plain version: the in-range rows are
    selected (``keep``, computed here unless given) and written."""
    if rows.device.type != "cpu":
        _kv_write_kernel(pool, None, li, pids, offs, rows, None)
        return pool
    if keep is None:
        keep = keep_index(pids, pool_shape(pool)[2])
    _write_kept(pool, li, pids, offs, rows, keep)
    return pool


def _write_kept(pool, li, pids, offs, rows, keep) -> None:
    """The plain write: the rows at flat indices ``keep`` (in range)."""
    n = pids.numel()
    p = pids.reshape(-1).index_select(0, keep)
    o = offs.reshape(-1).index_select(0, keep)
    r = rows.reshape(n, *rows.shape[-2:]).index_select(0, keep)
    _set_rows(pool_layer(pool, li), (slice(None), p, o),
              r.transpose(0, 1))                        # [H, n, d]


def kv_write_plain(k_pool, v_pool, li: int, pids: torch.Tensor,
                   offs: torch.Tensor, k_rows: torch.Tensor,
                   v_rows: torch.Tensor, keep: torch.Tensor | None = None):
    """The plain version of :func:`kv_write`, on any device: both rows
    through :func:`pool_write`'s CPU code, with one in-range selection
    (one host sync on CUDA)."""
    if keep is None:
        keep = keep_index(pids, pool_shape(k_pool)[2])
    _write_kept(k_pool, li, pids, offs, k_rows, keep)
    _write_kept(v_pool, li, pids, offs, v_rows, keep)
    return k_pool, v_pool


def kv_write(k_pool, v_pool, li: int, pids: torch.Tensor,
             offs: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
             keep: torch.Tensor | None = None):
    """Write one layer's new K and V rows, in place: row n of ``k_rows``
    / ``v_rows`` ([*pids.shape, Hkv, hd]) lands in layer ``li`` at page
    ``pids[n]``, offset ``offs[n]``; a row whose page id is outside
    ``[0, Np)`` is dropped. Returns (k_pool, v_pool).

    CUDA tensors launch the kernel for the pools' form (bf16 rows; bf16
    pools, or int8 ``{q, s}`` pools quantized on the card bit for bit as
    :func:`quantize_rows` does) — one launch, no host sync — or raise:
    there is no fallback. CPU tensors run :func:`kv_write_plain`
    (``keep``, the in-range indices, may be passed in to share one
    selection across layers)."""
    if k_rows.device.type == "cpu":
        return kv_write_plain(k_pool, v_pool, li, pids, offs, k_rows,
                              v_rows, keep)
    _kv_write_kernel(k_pool, v_pool, li, pids, offs, k_rows, v_rows)
    return k_pool, v_pool


#: C entry by pool form: (symbol, pool pointer arguments); every entry
#: takes (k_rows, v_rows, pids, offs, <pools>, N, Hkv, Np, pg, hd, stream)
_KV_WRITE = {False: ("gofr_kv_write", 2), True: ("gofr_kv_write_i8", 4)}
_kv_fns: dict = {}


def _kv_kernel(quantized: bool):
    fn = _kv_fns.get(quantized)
    if fn is None:
        symbol, n_pools = _KV_WRITE[quantized]
        fn = getattr(_build.load("kv_write"), symbol)
        fn.argtypes = [ctypes.c_void_p] * (4 + n_pools) + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kv_fns[quantized] = fn
    return fn


def _kv_write_kernel(k_pool, v_pool, li, pids, offs, k_rows, v_rows) -> None:
    """Check what the kernel takes, launch it on the current stream (V
    absent: ``v_pool`` and ``v_rows`` None), raise if the launch was
    refused, and count it: ``kv_write.launches`` for bf16 pools,
    ``kv_write.launches_int8`` for quantized ones."""
    if k_rows.device.type != "cuda":
        raise ValueError(f"kv_write: no kernel for device {k_rows.device}")
    quantized = is_quantized_pool(k_pool)
    pools = [k_pool] if v_pool is None else [k_pool, v_pool]
    if any(is_quantized_pool(p) != quantized for p in pools):
        raise ValueError("kv_write: k_pool and v_pool must both be plain or "
                         "both quantized")
    n_layers, hkv, n_pages, pg, d = pool_shape(k_pool)
    if not 0 <= li < n_layers:
        raise ValueError(f"kv_write: layer {li} outside [0, {n_layers})")
    n = pids.numel()
    if offs.numel() != n:
        raise ValueError("kv_write: pids and offs must hold one entry per row")
    rows = [k_rows] if v_rows is None else [k_rows, v_rows]
    rows = [r.reshape(n, *r.shape[-2:]) for r in rows]
    leaves = []
    for pool in pools:
        leaves += ([pool["q"], pool["s"]] if quantized else [pool])
    for r in rows:
        if r.dtype != torch.bfloat16 or tuple(r.shape) != (n, hkv, d):
            raise ValueError(f"kv_write: rows must be bfloat16 "
                             f"[*pids.shape, {hkv}, {d}], got {r.dtype} "
                             f"{tuple(r.shape)}")
    for t in rows + leaves + [pids, offs]:
        if t.device != k_rows.device:
            raise ValueError(f"kv_write: a tensor on {t.device}, the rows "
                             f"on {k_rows.device}")
    for pool in pools:
        want = (n_layers, hkv, n_pages, pg, d)
        if pool_shape(pool) != want:
            raise ValueError(f"kv_write: pools must both be {want}")
        if quantized:
            if pool["q"].dtype != torch.int8 or pool["s"].dtype != \
                    torch.float32 or pool["s"].shape != (*want[:4], 1):
                raise TypeError("kv_write: a quantized pool is int8 codes "
                                "and float32 [L, Hkv, Np, pg, 1] scales")
        elif pool.dtype != torch.bfloat16:
            raise TypeError(f"kv_write: pools must be bfloat16, got "
                            f"{pool.dtype}")
    if not all(t.is_contiguous() for t in leaves):
        raise ValueError("kv_write: pools must be contiguous")
    rows = [r.contiguous() for r in rows]
    pids = pids.reshape(-1).to(torch.int32).contiguous()
    offs = offs.reshape(-1).to(torch.int32).contiguous()
    layer = [t[li] for t in leaves]
    if v_pool is None:
        # K only: the V row and pool arguments are null
        layer = ([layer[0], None, layer[1], None] if quantized
                 else [layer[0], None])
        rows.append(None)
    elif quantized:                 # (k codes, v codes, k scales, v scales)
        layer = [layer[0], layer[2], layer[1], layer[3]]
    ptr = [None if t is None else t.data_ptr() for t in rows + [pids, offs]
           + layer]
    rc = _kv_kernel(quantized)(
        *ptr, n, hkv, n_pages, pg, d,
        torch.cuda.current_stream(k_rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kv_write{'_int8' if quantized else ''} kernel "
                           f"launch failed: cudaError {rc}")
    if n:
        counter = "launches_int8" if quantized else "launches"
        setattr(kv_write, counter, getattr(kv_write, counter) + 1)


#: kernel launches since the last reset, per pool form (plain integers;
#: set one to 0 to start counting); pool_write's CUDA path counts here
kv_write.launches = 0           # bf16 pools
kv_write.launches_int8 = 0      # int8 {q, s} pools


def _chunk_coords(pool, tables: torch.Tensor, offsets: torch.Tensor,
                  chunk_lens: torch.Tensor, width: int):
    """(page ids, offsets) [P, S] of a chunk slab's rows, on the device:
    positions past ``chunk_lens``, past the table, or whose table entry
    is the OOB id get the OOB page id ``Np``."""
    n_pages, pg = pool_shape(pool)[2:4]
    mp = tables.shape[1]
    ar = torch.arange(width, device=tables.device)
    pos = offsets[:, None] + ar[None, :]                          # [P, S]
    valid = ar[None, :] < chunk_lens[:, None]
    pids = torch.gather(tables, 1, (pos // pg).clamp(0, mp - 1))
    pids = torch.where(valid & (pos < mp * pg), pids,
                       torch.full_like(pids, n_pages))
    return pids, pos % pg


def _scatter_kept(pool, pids, offs, slab, keep) -> None:
    """The plain write of a slab [L, P, S, H, d]: the rows at flat
    indices ``keep`` (in range) of every layer."""
    p = pids.reshape(-1).index_select(0, keep)
    o = offs.reshape(-1).index_select(0, keep)
    n_layers, n_rows = slab.shape[0], slab.shape[1] * slab.shape[2]
    rows = slab.reshape(n_layers, n_rows, *slab.shape[3:]).index_select(1, keep)
    _set_rows(pool, (slice(None), slice(None), p, o),
              rows.transpose(1, 2))                     # [L, H, n, d]


def scatter_chunk_plain(pool, tables: torch.Tensor, slab: torch.Tensor,
                        offsets: torch.Tensor, chunk_lens: torch.Tensor):
    """The plain version of :func:`scatter_chunk`, on any device: the
    in-range rows are selected (``keep_index``, one host sync on CUDA)
    and written by index."""
    pids, offs = _chunk_coords(pool, tables, offsets, chunk_lens,
                               slab.shape[2])
    _scatter_kept(pool, pids, offs, slab, keep_index(pids, pool_shape(pool)[2]))
    return pool


def scatter_chunk(pool, tables: torch.Tensor, slab: torch.Tensor,
                  offsets: torch.Tensor, chunk_lens: torch.Tensor):
    """Write a chunk slab [L, P, S, H, d] whose row b covers logical
    positions ``[offsets[b], offsets[b] + chunk_lens[b])`` into the pool
    (in place), touching only the pages the chunk spans: positions past
    ``chunk_lens``, past the table, or whose table entry is the OOB id
    are dropped. One pool, as JAX's ``scatter_chunk``; the engine writes
    K and V together through :func:`scatter_chunk_kv`.

    CUDA tensors launch the ``kv_write`` kernel once per layer (K only,
    bf16 rows). CPU tensors run :func:`scatter_chunk_plain`."""
    if slab.device.type == "cpu":
        return scatter_chunk_plain(pool, tables, slab, offsets, chunk_lens)
    pids, offs = _chunk_coords(pool, tables, offsets, chunk_lens,
                               slab.shape[2])
    for li in range(slab.shape[0]):
        _kv_write_kernel(pool, None, li, pids, offs, slab[li], None)
    return pool


def scatter_chunk_kv_plain(k_pool, v_pool, tables: torch.Tensor,
                           k_slab: torch.Tensor, v_slab: torch.Tensor,
                           offsets: torch.Tensor, chunk_lens: torch.Tensor):
    """The plain version of :func:`scatter_chunk_kv`, on any device: one
    in-range selection (one host sync on CUDA) for both pools."""
    pids, offs = _chunk_coords(k_pool, tables, offsets, chunk_lens,
                               k_slab.shape[2])
    keep = keep_index(pids, pool_shape(k_pool)[2])
    _scatter_kept(k_pool, pids, offs, k_slab, keep)
    _scatter_kept(v_pool, pids, offs, v_slab, keep)
    return k_pool, v_pool


def scatter_chunk_kv(k_pool, v_pool, tables: torch.Tensor,
                     k_slab: torch.Tensor, v_slab: torch.Tensor,
                     offsets: torch.Tensor, chunk_lens: torch.Tensor):
    """:func:`scatter_chunk` of a K slab and a V slab [L, P, S, Hkv, hd]
    into their pools, in place. Returns (k_pool, v_pool).

    CUDA tensors launch the ``kv_write`` kernel once per layer for K and
    V together (bf16 rows; counted in ``kv_write.launches`` /
    ``launches_int8``): the page ids and offsets are derived once on the
    device and the kernel drops the out-of-range rows, so the call holds
    no host sync and returns before the card has written. CPU tensors
    run :func:`scatter_chunk_kv_plain`."""
    if k_slab.device.type == "cpu":
        return scatter_chunk_kv_plain(k_pool, v_pool, tables, k_slab, v_slab,
                                      offsets, chunk_lens)
    pids, offs = _chunk_coords(k_pool, tables, offsets, chunk_lens,
                               k_slab.shape[2])
    for li in range(k_slab.shape[0]):
        _kv_write_kernel(k_pool, v_pool, li, pids, offs, k_slab[li],
                         v_slab[li])
    return k_pool, v_pool


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
