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

The writers launch the hand-written kernels of ``csrc/kv_write.cu`` on
CUDA tensors, out-of-range rows dropped on the card and int8 rows
quantized there, so a decode step holds no host sync and can be
captured in a CUDA graph, and a prefill returns before the card is
done:

- :func:`rope_kv_write`, the model steps' per-layer write: RoPE on the
  new token's q and k, the rotated q out, K and V into the pool, one
  launch a layer;
- :func:`scatter_chunk_kv`, the prefill's write: the K and V slabs of
  every layer in one launch;
- :func:`kv_write` (and :func:`pool_write`, :func:`scatter_chunk`): one
  layer's K and V rows, as they are.

CPU tensors take the plain versions below, which select the in-range
rows first.

The dense view of the pool, for model families that decode on dense
caches (``gather_view``: every layer's pages gathered into [L, B,
Mp*pg, H, d], an int8 pool dequantized to the model's dtype;
``scatter_decode`` / ``scatter_decode_kv``: the rows a decode pass
appended to the view written back through ``scatter_chunk`` /
``scatter_chunk_kv``), ``scatter_prefill`` and ``pool_from_cache_shape``
are JAX's functions of the same names.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .rope import apply_rope

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


def dequantize_rows(q: torch.Tensor, s: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Codes ``q`` [..., d] * scales ``s`` [..., 1] -> values [..., d] in
    ``dtype`` (JAX's parameter names)."""
    return (q.float() * s).to(dtype)


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


def keep_index(pids: torch.Tensor, n_pages: int,
               offs: torch.Tensor | None = None,
               page: int | None = None) -> torch.Tensor:
    """Flat indices of the entries of ``pids`` that name a real page
    (``0 <= pid < n_pages``) and, with ``offs`` and ``page``, a real row
    of it (``0 <= off < page``), as the kernels select them. One host
    sync on CUDA; a caller writing several layers with the same ids
    computes it once and passes it as ``keep`` to :func:`pool_write`."""
    flat = pids.reshape(-1)
    ok = (flat >= 0) & (flat < n_pages)
    if offs is not None:
        o = offs.reshape(-1)
        ok &= (o >= 0) & (o < page)
    return torch.nonzero(ok).reshape(-1)


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

    CUDA tensors launch the ``kv_write`` kernel (K only; rows in the
    pool's type) or raise. CPU tensors run the plain version: the
    in-range rows are selected (``keep``, computed here unless given) and
    written."""
    if rows.device.type != "cpu":
        _kv_write_kernel(pool, None, li, pids, offs, rows, None)
        return pool
    if keep is None:
        keep = keep_index(pids, pool_shape(pool)[2], offs,
                          pool_shape(pool)[3])
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
        keep = keep_index(pids, pool_shape(k_pool)[2], offs,
                          pool_shape(k_pool)[3])
    _write_kept(k_pool, li, pids, offs, k_rows, keep)
    _write_kept(v_pool, li, pids, offs, v_rows, keep)
    return k_pool, v_pool


def kv_write(k_pool, v_pool, li: int, pids: torch.Tensor,
             offs: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
             keep: torch.Tensor | None = None):
    """Write one layer's new K and V rows, in place: row n of ``k_rows``
    / ``v_rows`` ([*pids.shape, Hkv, hd]) lands in layer ``li`` at page
    ``pids[n]``, offset ``offs[n]``; a row whose page id is outside
    ``[0, Np)`` (or whose offset is outside ``[0, pg)``) is dropped.
    Returns (k_pool, v_pool).

    CUDA tensors launch the kernel for the pools' form (pools in bf16,
    float16 or float32 and rows of their type, or int8 ``{q, s}`` pools
    and rows of any of the three, quantized on the card bit for bit as
    :func:`quantize_rows` does) — one launch, no host sync — or raise:
    there is no fallback. CPU tensors run :func:`kv_write_plain`
    (``keep``, the in-range indices, may be passed in to share one
    selection across layers)."""
    if k_rows.device.type == "cpu":
        return kv_write_plain(k_pool, v_pool, li, pids, offs, k_rows,
                              v_rows, keep)
    _kv_write_kernel(k_pool, v_pool, li, pids, offs, k_rows, v_rows)
    return k_pool, v_pool


#: C entries of ``csrc/kv_write.cu``: symbol -> (pointer arguments,
#: int arguments, the last the activation type's code) before the stream
_ENTRIES = {"gofr_kv_write": (6, 6), "gofr_kv_write_i8": (8, 6),
            "gofr_rope_kv_write": (10, 7), "gofr_rope_kv_write_i8": (12, 7),
            "gofr_kv_write_slab": (6, 7), "gofr_kv_write_slab_i8": (8, 7)}
_kv_fns: dict = {}


def _launch(name: str, symbol: str, tensors: list, ints: tuple,
            device: torch.device) -> None:
    """Call C entry ``symbol`` with the tensors' addresses (None: a null
    pointer), ``ints`` and the current stream; raise if the launch was
    refused."""
    fn = _kv_fns.get(symbol)
    if fn is None:
        n_ptr, n_int = _ENTRIES[symbol]
        fn = getattr(_build.load("kv_write"), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kv_fns[symbol] = fn
    rc = fn(*[None if t is None else t.data_ptr() for t in tensors], *ints,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _check_pools(name: str, k_pool, v_pool, device: torch.device):
    """(quantized, [L, Hkv, Np, pg, hd], the leaves in the C entries'
    order: (k, v) or (k codes, v codes, k scales, v scales), None for an
    absent V pool), or raise on what the kernels do not take: a plain
    pool in bf16, float16 or float32 (the model's dtype), or int8 codes
    with float32 scales."""
    quantized = is_quantized_pool(k_pool)
    pools = [k_pool] if v_pool is None else [k_pool, v_pool]
    if any(is_quantized_pool(p) != quantized for p in pools):
        raise ValueError(f"{name}: k_pool and v_pool must both be plain or "
                         f"both quantized")
    shape = pool_shape(k_pool)
    for pool in pools:
        if pool_shape(pool) != shape:
            raise ValueError(f"{name}: pools must both be {shape}")
        if quantized:
            if pool["q"].dtype != torch.int8 or pool["s"].dtype != \
                    torch.float32 or pool["s"].shape != (*shape[:4], 1):
                raise TypeError(f"{name}: a quantized pool is int8 codes "
                                f"and float32 [L, Hkv, Np, pg, 1] scales")
        else:
            _build.dtype_code(name, "pools", pool.dtype)
            if pool.dtype != k_pool.dtype:
                raise TypeError(f"{name}: pools must share one dtype")
    if quantized:
        leaves = [k_pool["q"], None if v_pool is None else v_pool["q"],
                  k_pool["s"], None if v_pool is None else v_pool["s"]]
    else:
        leaves = [k_pool, v_pool]
    for t in leaves:
        if t is not None and t.device != device:
            raise ValueError(f"{name}: a pool on {t.device}, the rows on "
                             f"{device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: pools must be contiguous")
    return quantized, shape, leaves


def _rows_dtype(name: str, k_pool, rows: torch.Tensor):
    """(the type the rows must have, its C code): a plain pool's own (the
    rows are written as they are), or for a quantized pool the rows' own,
    any kernel type (the rows are quantized from it)."""
    dtype = rows.dtype if is_quantized_pool(k_pool) else k_pool.dtype
    return dtype, _build.dtype_code(name, "rows", dtype)


def _check_rows(name: str, rows: torch.Tensor, n: int, heads: int, d: int,
                device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``rows`` [*pids.shape, heads, d] of ``dtype`` on ``device`` as a
    contiguous [n, heads, d], or raise."""
    if rows.dtype != dtype or tuple(rows.shape[-2:]) != (heads, d) \
            or rows.numel() != n * heads * d:
        raise ValueError(f"{name}: rows must be {dtype} [*pids.shape, "
                         f"{heads}, {d}], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if rows.device != device:
        raise ValueError(f"{name}: a tensor on {rows.device}, the rows on "
                         f"{device}")
    return rows.reshape(n, heads, d).contiguous()


def _index(name: str, t: torch.Tensor, n: int,
           device: torch.device) -> torch.Tensor:
    """An index tensor of ``n`` entries as contiguous int32 [n]."""
    if t.numel() != n:
        raise ValueError(f"{name}: pids, offs (and positions) must hold one "
                         f"entry per row")
    if t.device != device:
        raise ValueError(f"{name}: a tensor on {t.device}, the rows on "
                         f"{device}")
    return t.reshape(-1).to(torch.int32).contiguous()


def _count(fn, quantized: bool) -> None:
    counter = "launches_int8" if quantized else "launches"
    setattr(fn, counter, getattr(fn, counter) + 1)


def _kv_write_kernel(k_pool, v_pool, li, pids, offs, k_rows, v_rows) -> None:
    """Check what the kernel takes, launch it on the current stream (V
    absent: ``v_pool`` and ``v_rows`` None), raise if the launch was
    refused, and count it: ``kv_write.launches`` for bf16 pools,
    ``kv_write.launches_int8`` for quantized ones."""
    if k_rows.device.type != "cuda":
        raise ValueError(f"kv_write: no kernel for device {k_rows.device}")
    dev = k_rows.device
    quantized, (n_layers, hkv, n_pages, pg, d), leaves = _check_pools(
        "kv_write", k_pool, v_pool, dev)
    if not 0 <= li < n_layers:
        raise ValueError(f"kv_write: layer {li} outside [0, {n_layers})")
    n = pids.numel()
    dtype, code = _rows_dtype("kv_write", k_pool, k_rows)
    rows = [None if r is None
            else _check_rows("kv_write", r, n, hkv, d, dev, dtype)
            for r in (k_rows, v_rows)]
    idx = [_index("kv_write", t, n, dev) for t in (pids, offs)]
    layer = [None if t is None else t[li] for t in leaves]
    _launch("kv_write" + ("_int8" if quantized else ""),
            "gofr_kv_write" + ("_i8" if quantized else ""),
            rows + idx + layer, (n, hkv, n_pages, pg, d, code), dev)
    if n:
        _count(kv_write, quantized)


#: kernel launches since the last reset, per pool form (plain integers;
#: set one to 0 to start counting); pool_write's and scatter_chunk's CUDA
#: paths count here
kv_write.launches = 0           # bf16 pools
kv_write.launches_int8 = 0      # int8 {q, s} pools


def rope_kv_write_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, inv_freq: torch.Tensor,
                        k_pool, v_pool, li: int, pids: torch.Tensor,
                        offs: torch.Tensor,
                        keep: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of :func:`rope_kv_write`, on any device:
    ``apply_rope`` on q and on k, then :func:`kv_write_plain` of the
    rotated k and of v (``keep`` as there)."""
    q_rot = apply_rope(q, positions, inv_freq)
    kv_write_plain(k_pool, v_pool, li, pids, offs,
                   apply_rope(k, positions, inv_freq), v, keep)
    return q_rot


def rope_kv_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, inv_freq: torch.Tensor, k_pool,
                  v_pool, li: int, pids: torch.Tensor, offs: torch.Tensor,
                  keep: torch.Tensor | None = None) -> torch.Tensor:
    """A step's new rows through RoPE into the pool, in place: q [*lead,
    Hq, hd] and k [*lead, Hkv, hd] rotated by ``positions`` [*lead]
    (``apply_rope`` with ``inv_freq`` [hd / 2]), the rotated k and v
    [*lead, Hkv, hd] written into layer ``li`` at (``pids``, ``offs``)
    [*lead] as :func:`kv_write` writes them (a row whose page id is
    outside ``[0, Np)`` dropped). Returns the rotated q [*lead, Hq, hd].
    The RoPE position and the write coordinates are separate: a tree
    verify rotates node i at its depth and writes it at row i.

    CUDA tensors launch the fused kernel for the pools' form (q, k, v in
    bf16, float16 or float32, a plain pool of their type; hd a multiple
    of 4 from 16 to 256; one launch, no host sync), bit for bit
    :func:`rope_kv_write_plain`, or raise: there is no fallback. CPU
    tensors run :func:`rope_kv_write_plain` (``keep``, the in-range
    indices, may be passed in to share one selection across layers)."""
    if q.device.type == "cpu":
        return rope_kv_write_plain(q, k, v, positions, inv_freq, k_pool,
                                   v_pool, li, pids, offs, keep)
    name = "rope_kv_write"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    quantized, tensors, ints = _rope_args(q, k, v, positions, inv_freq,
                                          k_pool, v_pool, li, pids, offs)
    _launch(name + ("_int8" if quantized else ""),
            "gofr_rope_kv_write" + ("_i8" if quantized else ""), tensors,
            ints, q.device)
    if ints[0]:
        _count(rope_kv_write, quantized)
    return tensors[7].reshape(q.shape)


def _rope_args(q, k, v, positions, inv_freq, k_pool, v_pool, li, pids,
               offs) -> tuple:
    """What the fused kernel takes, checked on ``q``'s device (raise on
    anything else): (quantized, the C entry's tensors — the rotated q's
    new buffer eighth —, its ints)."""
    name, dev = "rope_kv_write", q.device
    quantized, (n_layers, hkv, n_pages, pg, d), leaves = _check_pools(
        name, k_pool, v_pool, dev)
    if not 0 <= li < n_layers:
        raise ValueError(f"{name}: layer {li} outside [0, {n_layers})")
    _build.check_head_dim(name, d)
    dtype, code = _rows_dtype(name, k_pool, q)
    n, hq = pids.numel(), q.shape[-2]
    rows = [_check_rows(name, t, n, heads, d, dev, dtype)
            for t, heads in ((q, hq), (k, hkv), (v, hkv))]
    idx = [_index(name, t, n, dev) for t in (positions, pids, offs)]
    if inv_freq.dtype != torch.float32 or tuple(inv_freq.shape) != (d // 2,) \
            or inv_freq.device != dev:
        raise ValueError(f"{name}: inv_freq must be float32 [{d // 2}] on "
                         f"{dev}")
    tensors = rows + [idx[0], inv_freq.contiguous(), idx[1], idx[2],
                      torch.empty_like(rows[0])] + [t[li] for t in leaves]
    return quantized, tensors, (n, hq, hkv, n_pages, pg, d, code)


#: fused kernel launches since the last reset, per pool form
rope_kv_write.launches = 0
rope_kv_write.launches_int8 = 0


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
    rows in the pool's type). CPU tensors run :func:`scatter_chunk_plain`."""
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

    CUDA tensors launch the slab kernel once for every layer, K and V
    together (slabs in the plain pools' type, or in bf16, float16 or
    float32 for int8 pools; counted in ``scatter_chunk_kv.launches`` /
    ``launches_int8``): the page ids and offsets are derived once on the
    device and the kernel drops the out-of-range rows, so the call holds
    no host sync and returns before the card has written. CPU tensors
    run :func:`scatter_chunk_kv_plain`."""
    if k_slab.device.type == "cpu":
        return scatter_chunk_kv_plain(k_pool, v_pool, tables, k_slab, v_slab,
                                      offsets, chunk_lens)
    name = "scatter_chunk_kv"
    if k_slab.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {k_slab.device}")
    quantized, tensors, ints = _slab_args(k_pool, v_pool, tables, k_slab,
                                          v_slab, offsets, chunk_lens)
    _launch(name + ("_int8" if quantized else ""),
            "gofr_kv_write_slab" + ("_i8" if quantized else ""), tensors,
            ints, k_slab.device)
    if ints[0] and ints[1]:
        _count(scatter_chunk_kv, quantized)
    return k_pool, v_pool


def _slab_args(k_pool, v_pool, tables, k_slab, v_slab, offsets,
               chunk_lens) -> tuple:
    """What the slab kernel takes, checked on the slabs' device (raise on
    anything else): (quantized, the C entry's tensors, its ints)."""
    name, dev = "scatter_chunk_kv", k_slab.device
    quantized, (n_layers, hkv, n_pages, pg, d), leaves = _check_pools(
        name, k_pool, v_pool, dev)
    dtype, code = _rows_dtype(name, k_pool, k_slab)
    if not (d == 8 and dtype == torch.bfloat16):   # bf16 also takes 8
        _build.check_head_dim(name, d)
    if k_slab.dim() != 5 or k_slab.shape[0] != n_layers:
        raise ValueError(f"{name}: slabs must be [{n_layers}, P, S, {hkv}, "
                         f"{d}], got {tuple(k_slab.shape)}")
    n = k_slab.shape[1] * k_slab.shape[2]
    pids, offs = _chunk_coords(k_pool, tables, offsets, chunk_lens,
                               k_slab.shape[2])
    slabs = [_check_rows(name, t, n_layers * n, hkv, d, dev, dtype)
             for t in (k_slab, v_slab)]
    if tuple(v_slab.shape) != tuple(k_slab.shape):
        raise ValueError(f"{name}: K and V slabs differ in shape")
    if any(t.data_ptr() % 16 for t in slabs + leaves):
        raise ValueError(f"{name}: slabs and pools must be 16-byte aligned")
    return (quantized,
            slabs + [_index(name, t, n, dev) for t in (pids, offs)] + leaves,
            (n_layers, n, hkv, n_pages, pg, d, code))


#: slab kernel launches since the last reset, per pool form
scatter_chunk_kv.launches = 0
scatter_chunk_kv.launches_int8 = 0


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


def pool_from_cache_shape(k_cache: torch.Tensor) -> torch.Tensor:
    """Re-lay a dense [L, Np, pg, H, d] allocation as the head-major
    pool [L, H, Np, pg, d] (contiguous)."""
    return k_cache.permute(0, 3, 1, 2, 4).contiguous()


def _gather_all(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    n_layers, h, n_pages, pg, d = pool.shape
    b, mp = tables.shape
    safe = tables.clamp(max=n_pages - 1).long()
    view = pool[:, :, safe]                          # [L, H, B, Mp, pg, d]
    return view.permute(0, 2, 3, 4, 1, 5).reshape(n_layers, b, mp * pg, h, d)


def gather_view(pool, tables: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """Pool [L, H, Np, pg, d] + tables [B, Mp] -> the dense slot view [L,
    B, Mp*pg, H, d] of every layer (a copy). Out-of-range table ids clamp
    to the last page; the caller masks those rows by length. A quantized
    pool dequantizes to ``dtype`` (default bf16: the model's dtype, not
    :func:`slot_view`'s float32); a plain pool's view keeps the pool's
    dtype and ignores ``dtype``."""
    if is_quantized_pool(pool):
        return dequantize_rows(_gather_all(pool["q"], tables),
                               _gather_all(pool["s"], tables),
                               torch.bfloat16 if dtype is None else dtype)
    return _gather_all(pool, tables)


def scatter_prefill(pool, tables: torch.Tensor, k_slab: torch.Tensor):
    """Write a prompt K (or V) slab [L, P, S, H, d] into the pool through
    per-row tables [P, Mp], in place: every slab position of every row
    (pad rows past a prompt's length included), dropped only where the
    table has no page. :func:`scatter_chunk` at offset 0 over the whole
    width."""
    p, s = k_slab.shape[1:3]
    zeros = torch.zeros(p, dtype=torch.int32, device=k_slab.device)
    return scatter_chunk(pool, tables, k_slab, zeros, zeros + s)


def _appended(view: torch.Tensor, lengths: torch.Tensor, k_steps: int):
    """(rows [L, B, K, H, d], chunk lengths [B]): the ``k_steps`` rows a
    decode pass appended to ``view`` [L, B, S, H, d] at positions
    ``lengths .. lengths + K - 1`` of each slot (read clamped to the
    view), and how many of them lie inside the view: those past it drop
    on write."""
    b, s = view.shape[1:3]
    ar = torch.arange(k_steps, device=view.device)
    pos = (lengths.long()[:, None] + ar[None, :]).clamp(max=s - 1)
    rows = view[:, torch.arange(b, device=view.device)[:, None], pos]
    keep = (s - lengths).clamp(0, k_steps).to(torch.int32)
    return rows, keep


def scatter_decode(pool, tables: torch.Tensor, view: torch.Tensor,
                   lengths: torch.Tensor, k_steps: int):
    """Copy the ``k_steps`` rows a decode pass appended to ``view`` [L,
    B, S, H, d] (at logical positions ``lengths .. lengths + K - 1`` per
    slot) back into the pool through ``tables`` [B, Mp], in place.
    Positions past the view (a slot at the cache ceiling, or parked at
    ``max_seq``) drop, and so do unallocated pages. Rows are cast to the
    pool dtype, or quantized. One pool, as JAX's ``scatter_decode``
    (:func:`scatter_chunk`'s route); the engine writes K and V back
    together through :func:`scatter_decode_kv`."""
    rows, keep = _appended(view, lengths, k_steps)
    return scatter_chunk(pool, tables, rows, lengths, keep)


def scatter_decode_kv(k_pool, v_pool, tables: torch.Tensor,
                      k_view: torch.Tensor, v_view: torch.Tensor,
                      lengths: torch.Tensor, k_steps: int):
    """:func:`scatter_decode` of the K and the V view into their pools,
    in place, through :func:`scatter_chunk_kv`: on CUDA one launch of
    the slab kernel for every layer, K and V together, with no host
    sync; on the CPU the plain version. Returns (k_pool, v_pool)."""
    k_rows, keep = _appended(k_view, lengths, k_steps)
    v_rows, _ = _appended(v_view, lengths, k_steps)
    return scatter_chunk_kv(k_pool, v_pool, tables, k_rows, v_rows, lengths,
                            keep)


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
