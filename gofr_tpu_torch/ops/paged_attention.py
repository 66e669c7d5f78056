"""Paged attention against the head-major KV pool: the CUDA kernels'
wrappers and their plain PyTorch versions (counterpart of
``gofr_tpu/ops/paged_attention.py``, decode, chunk and tree-verify
paths, over plain bf16/f32 pools and int8 ``{"q", "s"}`` pools).

Layouts:
- decode (one new token per slot): ``q`` [B, Hq, hd], ``lengths`` [B]
  int32 = valid rows per slot AFTER this step's write, out [B, Hq, hd]
- chunk (Sq new rows per slot, already written into the pool):
  ``q`` [B, Sq, Hq, hd], ``history_lens`` / ``chunk_lens`` [B] int32,
  out [B, Sq, Hq, hd]; row i of slot b sees pool rows
  ``p <= history + i`` and ``p < history + chunk``
- tree (Sq <= 32 draft-tree nodes per slot, packed topologically and
  already written at ``[history, history + chunk)``): the chunk layout
  plus ``tree_masks`` [B, Sq] int32; node i sees every pool row below
  ``history`` and in-chunk row j iff ``j < chunk`` and bit j of
  ``tree_masks[b, i]`` is set
- ``k_pool``   [Hkv, Np, pg, hd] — one layer of the head-major pool, or
  the quantized layer ``{"q": int8 [Hkv, Np, pg, hd], "s": float32
  [Hkv, Np, pg, 1]}`` (``paged_kv.pool_layer`` gives either)
- ``tables``   [B, Mp] int32 — page ids, ``Np`` = unallocated

The kernels (``csrc/paged_decode.cu``, ``csrc/paged_chunk.cu``) replace
the TPU kernels ``gofr_tpu/ops/paged_attention.py:_paged_decode_kernel``,
``_paged_chunk_kernel`` and ``_paged_tree_kernel``, both of their
branches: each source instantiates its kernel for pages in the
activation type and for int8 pages with their row scales, with one C
entry point per kernel and form (``_i8`` for int8). The chunk and tree
kernels are one kernel body templated on its visibility rule. Each
source says what bounds it on the H100 and what the design does about
it. The plain versions compute
over the dequantizing ``paged_kv.slot_view`` (float32 ``codes *
scales``), as the JAX package's ``_slot_view`` does.

Types, head dims and groups: q in bf16, float16 or float32, a plain
pool in q's type, any head dim that is a multiple of 4 from 16 to 256
and any GQA group that divides Hq, as the TPU kernels take any. The
routes (``_build.attention_route``; one C entry point per kernel and
form, which picks): decode runs the split-KV kernel of
``csrc/paged_decode.cu`` in every type; chunk and tree run the
``wgmma`` kernel of ``csrc/paged_chunk.cu`` for bf16 and float16 and
the float32 kernel of ``csrc/attn_simt.cuh`` for float32. A group of
more query heads than a block holds (SUB_GROUP; 8 in decode at head dims
above 128) is cut into sub-groups of the same KV head, one block each.

Split-KV: the decode kernel and the ``wgmma`` chunk and tree kernel
spread a work item's walk (a slot's pages for decode, a q tile's 64-row
K/V tiles for chunk and tree) over S blocks that form one thread-block
cluster and merge their partial softmax states on the card.
:func:`kv_splits` picks S from the shapes alone, so no length is read
on the host.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import decode_attention, tree_attention, xla_attention
from .paged_kv import is_quantized_pool, slot_view

#: nodes a draft tree may hold: the ancestor masks are 32-bit
MAX_TREE_WIDTH = 32
#: query heads of one KV head a block holds (decode: the warps' register
#: arrays, 8 at head dims above 128; chunk: 64 block rows = BQ positions
#: x heads, BQ >= 4); a wider group is cut into sub-groups (csrc/
#: paged_common.cuh ``sub_groups``)
SUB_GROUP = 16
DECODE_SUB_GROUP_WIDE = 8

#: split-KV sizing: the grid should fill about SPLIT_WAVES waves of
#: blocks on the H100's SPLIT_SMS SMs; a cluster holds at most
#: MAX_SPLITS blocks (the portable cluster size)
SPLIT_SMS = 132
SPLIT_WAVES = 2
MAX_SPLITS = 8
#: the chunk kernel's block rows (BQ positions x group heads) and K/V
#: tile rows (csrc/paged_chunk.cu ROWS, BK)
CHUNK_ROWS = 64
CHUNK_KV_TILE = 64

#: kernel (wrapper name, ``_int8`` for a quantized pool) -> (library, C
#: symbol, pointer arguments, int arguments); every C entry point ends
#: with (int dtype, int n_splits, float scale, void* stream) — dtype and
#: n_splits counted in the ints —, and an ``_i8`` one takes the K and V
#: scale pointers right after the K and V codes
_KERNELS = {
    "paged_decode_attention": ("paged_decode", "gofr_paged_decode", 6, 9),
    "paged_decode_attention_int8": ("paged_decode", "gofr_paged_decode_i8",
                                    8, 9),
    "paged_chunk_attention": ("paged_chunk", "gofr_paged_chunk", 7, 10),
    "paged_chunk_attention_int8": ("paged_chunk", "gofr_paged_chunk_i8",
                                   9, 10),
    "paged_tree_attention": ("paged_chunk", "gofr_paged_tree", 8, 10),
    "paged_tree_attention_int8": ("paged_chunk", "gofr_paged_tree_i8",
                                  10, 10),
}
_fns: dict = {}


def _kernel(name: str):
    """The ctypes function of kernel ``name``, built and bound on first
    use."""
    fn = _fns.get(name)
    if fn is None:
        lib, symbol, n_ptrs, n_ints = _KERNELS[name]
        fn = getattr(_build.load(lib), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def sub_groups(group: int, cap: int) -> tuple[int, int]:
    """(n, size): a group of query heads cut into n sub-groups of at most
    ``cap`` heads, ``size`` = ceil(group / n) each (the kernels' rule,
    csrc/paged_common.cuh ``sub_groups``); (1, group) when it fits."""
    n = -(-group // cap)
    return n, -(-group // n)


def kv_splits(mode: str, batch: int, sq: int, hq: int, hkv: int,
              max_pages: int, page: int, head_dim: int = 64) -> int:
    """S, the number of blocks that share each work item's K/V walk, from
    the launch's shapes alone (the lengths stay on the card).

    ``mode`` is ``"decode"`` (work items: B x Hkv x the group's
    sub-groups, walked in pages) or ``"chunk"`` / ``"tree"`` (one rule:
    B x Hkv x sub-groups x the q tiles of ``CHUNK_ROWS // heads``
    positions, walked in ``CHUNK_KV_TILE``-row tiles), ``max_pages`` the
    tables' width; ``head_dim`` sets decode's sub-group size. S is the
    largest power of two up to MAX_SPLITS that keeps the grid within
    SPLIT_WAVES waves on SPLIT_SMS SMs and S no larger than the units a
    walk can have: 1 when the grid already fills that (a 1024-row chunk),
    4 for decode or a tree verify at 8 slots of Llama-3.2-1B's 8 KV
    heads, 8 at 1 slot.
    """
    group = hq // hkv
    if mode == "decode":
        cap = DECODE_SUB_GROUP_WIDE if head_dim > 128 else SUB_GROUP
        blocks, units = batch * hkv * sub_groups(group, cap)[0], max_pages
    elif mode in ("chunk", "tree"):
        n_sub, size = sub_groups(group, SUB_GROUP)
        q_tiles = -(-sq // (CHUNK_ROWS // size))
        blocks = batch * hkv * n_sub * q_tiles
        units = -(-max_pages * page // CHUNK_KV_TILE)
    else:
        raise ValueError(f"kv_splits: unknown mode {mode!r}")
    s = 1
    while (2 * s <= MAX_SPLITS and 2 * s <= units
           and 2 * s * blocks <= SPLIT_WAVES * SPLIT_SMS):
        s *= 2
    return s


def paged_decode_attention_plain(q: torch.Tensor, k_pool, v_pool,
                                 tables: torch.Tensor, lengths: torch.Tensor,
                                 *, scale: float | None = None
                                 ) -> torch.Tensor:
    """The plain version: gather the dense slot views, run masked
    decode attention, and give zero-length slots exact zeros (the
    kernel's ``max(l, 1e-30)`` denominator does the same)."""
    k_view = slot_view(k_pool, tables)
    v_view = slot_view(v_pool, tables)
    out = decode_attention(q[:, None], k_view, v_view, lengths,
                           scale=scale)[:, 0]
    return torch.where(lengths[:, None, None] > 0, out,
                       torch.zeros_like(out))


def paged_chunk_attention_plain(q: torch.Tensor, k_pool, v_pool,
                                tables: torch.Tensor,
                                history_lens: torch.Tensor,
                                chunk_lens: torch.Tensor, *,
                                scale: float | None = None) -> torch.Tensor:
    """The plain version: gather the dense slot views and run causal
    attention offset by the history, bounded by ``history + chunk``.
    Rows past ``chunk_lens[b]`` (padding, which the caller discards)
    are zeros, as the kernel writes them — so a zero-length slot is
    exact zeros, and kernel and plain version agree on every row."""
    k_view = slot_view(k_pool, tables)
    v_view = slot_view(v_pool, tables)
    out = xla_attention(q, k_view, v_view, causal=True, q_offset=history_lens,
                        kv_lengths=history_lens + chunk_lens, scale=scale)
    rows = torch.arange(q.shape[1], device=q.device)
    live = rows[None, :] < chunk_lens[:, None]
    return torch.where(live[:, :, None, None], out, torch.zeros_like(out))


def paged_tree_attention_plain(q: torch.Tensor, k_pool, v_pool,
                               tables: torch.Tensor,
                               history_lens: torch.Tensor,
                               chunk_lens: torch.Tensor,
                               tree_masks: torch.Tensor, *,
                               scale: float | None = None) -> torch.Tensor:
    """The plain version: gather the dense slot views and run tree-masked
    attention. Rows past ``chunk_lens[b]`` (padding) are zeros, as the
    kernel writes them, so a zero-length slot is exact zeros."""
    k_view = slot_view(k_pool, tables)
    v_view = slot_view(v_pool, tables)
    out = tree_attention(q, k_view, v_view, history_lens=history_lens,
                         chunk_lens=chunk_lens, tree_masks=tree_masks,
                         scale=scale)
    rows = torch.arange(q.shape[1], device=q.device)
    live = rows[None, :] < chunk_lens[:, None]
    return torch.where(live[:, :, None, None], out, torch.zeros_like(out))


def _check_placed(fn: str, name: str, t, q) -> None:
    """``t`` is contiguous and on q's device (compared by index: the
    kernels only see CUDA tensors)."""
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if t.get_device() != q.get_device():
        raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")


def _check(fn: str, q, k_pool, v_pool, tables, *lengths) -> list:
    """What the kernels take: q in bf16, float16 or float32; pools [Hkv,
    Np, pg, hd], both in q's type, or both quantized (int8 codes and
    float32 [Hkv, Np, pg, 1] scales), with hd a multiple of 4 from 16 to
    256 and Hkv dividing Hq (any group); int32 [B, Mp] tables and [B]
    lengths; all contiguous and on q's device. The kernels stage rows in
    copies of up to 16 bytes, at least four elements, so q and the pages
    (or codes) must be aligned to four elements (float32 scales are
    4-byte aligned by construction). Returns the pool tensors in the
    kernel's argument order: (K, V), or (K codes, V codes, K scales, V
    scales)."""
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    quantized = is_quantized_pool(k_pool)
    if quantized != is_quantized_pool(v_pool):
        raise ValueError(f"{fn}: k_pool and v_pool must both be plain or "
                         f"both quantized")
    _build.dtype_code(fn, "q", q.dtype)
    if quantized:
        pools = [k_pool["q"], v_pool["q"], k_pool["s"], v_pool["s"]]
        page_dtype, page_names = torch.int8, ("k_pool codes", "v_pool codes")
    else:
        pools = [k_pool, v_pool]
        page_dtype, page_names = q.dtype, ("k_pool", "v_pool")
    kp, vp = pools[:2]
    if kp.ndim != 4 or kp.shape != vp.shape or kp.shape[3] != d:
        raise ValueError(f"{fn}: pools must be [Hkv, Np, pg, {d}], got "
                         f"{tuple(kp.shape)} / {tuple(vp.shape)}")
    hkv = kp.shape[0]
    if hq % hkv:
        raise ValueError(f"{fn}: Hq={hq}, Hkv={hkv}: the group must divide")
    _build.check_head_dim(fn, d)
    named = [("q", q, q.dtype), (page_names[0], kp, page_dtype),
             (page_names[1], vp, page_dtype)]
    if quantized:
        want = (*kp.shape[:3], 1)
        for name, t in (("k_pool scales", pools[2]),
                        ("v_pool scales", pools[3])):
            if t.shape != want:
                raise ValueError(f"{fn}: {name} must be [Hkv, Np, pg, 1], "
                                 f"got {tuple(t.shape)}")
            named.append((name, t, torch.float32))
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        # a float32 scale tensor is 4-byte aligned by construction
        align = None if "scales" in name else 4 * t.element_size()
        if align and t.data_ptr() % align:
            raise ValueError(f"{fn}: {name} must be {align}-byte aligned")
        _check_placed(fn, name, t, q)
    if tables.dtype != torch.int32 or tables.ndim != 2 \
            or tables.shape[0] != b:
        raise ValueError(f"{fn}: tables must be int32 [B, Mp]")
    _check_placed(fn, "tables", tables, q)
    for n in lengths:
        if n.dtype != torch.int32 or n.shape != (b,):
            raise ValueError(f"{fn}: lengths must be int32 [B]")
        _check_placed(fn, "lengths", n, q)
    return pools


def _splits(mode: str, q, b, sq, hq, hkv, mp, pg) -> int:
    """The split count the launch takes: :func:`kv_splits` of its shapes,
    in every type (the float32 chunk and tree kernel walks unsplit and
    does not read it)."""
    return kv_splits(mode, b, sq, hq, hkv, mp, pg, q.shape[-1])


def _check_page(wrapper, page: int) -> None:
    """The chunk and tree kernels address a page's rows with shifts: the
    page size must be a power of two (the engine's are)."""
    if page & (page - 1):
        raise ValueError(f"{wrapper.__name__}: page size {page} is not a "
                         f"power of two")


def _launch(wrapper, pools: list, q: torch.Tensor, *args) -> None:
    """Launch ``wrapper``'s kernel for the pools' form on the current
    stream (q, the pools, then ``args``), raise if the launch was
    refused (a cluster that does not fit is never retried unsplit), and
    count it: ``wrapper.launches`` for bf16 pools,
    ``wrapper.launches_int8`` for quantized ones."""
    quantized = len(pools) == 4
    name = wrapper.__name__ + ("_int8" if quantized else "")
    rc = _kernel(name)(q.data_ptr(), *(t.data_ptr() for t in pools), *args,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    counter = "launches_int8" if quantized else "launches"
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def paged_decode_attention(q: torch.Tensor, k_pool, v_pool,
                           tables: torch.Tensor, lengths: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """One decode step's attention against one layer's paged pool.

    CPU tensors run the plain version. CUDA tensors launch the kernel
    for the pools' form (q in bf16, float16 or float32; pools in q's type
    or int8 ``{q, s}``; contiguous; hd a multiple of 4 from 16 to 256;
    any group) or raise — there is no fallback. A slot
    walks at most ``Mp`` pages, as the plain version's ``[Mp*pg]`` view
    does.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables,
                                            lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    pools = _check("paged_decode_attention", q, k_pool, v_pool, tables,
                   lengths)
    b, hq, d = q.shape
    hkv, n_pages, pg, _ = pools[0].shape
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    mp = tables.shape[1]
    _launch(paged_decode_attention, pools, q, tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, hq, hkv, n_pages, pg,
            mp, d, _build.KERNEL_DTYPES[q.dtype],
            _splits("decode", q, b, 1, hq, hkv, mp, pg), scale)
    return out


def paged_chunk_attention(q: torch.Tensor, k_pool, v_pool,
                          tables: torch.Tensor, history_lens: torch.Tensor,
                          chunk_lens: torch.Tensor, *,
                          scale: float | None = None) -> torch.Tensor:
    """Ragged chunk attention against one layer's paged pool: each slot
    attends ``chunk_lens[b]`` new rows (already written at positions
    ``[history, history + chunk)``) to its history and their causal
    prefix. Rows past ``chunk_lens[b]`` come back as zeros.

    CPU tensors run the plain version. CUDA tensors launch the kernel
    for the pools' form (q in bf16, float16 or float32; pools in q's type
    or int8 ``{q, s}``; contiguous; hd a multiple of 4 from 16 to 256; a
    power-of-two page size) or raise —
    there is no fallback. A slot walks at most ``Mp`` pages, as the plain
    version's ``[Mp*pg]`` view does.
    """
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(q, k_pool, v_pool, tables,
                                           history_lens, chunk_lens,
                                           scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention: no kernel for device "
                         f"{q.device}")
    pools = _check("paged_chunk_attention", q, k_pool, v_pool, tables,
                   history_lens, chunk_lens)
    b, sq, hq, d = q.shape
    hkv, n_pages, pg, _ = pools[0].shape
    _check_page(paged_chunk_attention, pg)
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)     # the kernel writes every row
    mp = tables.shape[1]
    _launch(paged_chunk_attention, pools, q, tables.data_ptr(),
            history_lens.data_ptr(), chunk_lens.data_ptr(), out.data_ptr(),
            b, sq, hq, hkv, n_pages, pg, mp, d, _build.KERNEL_DTYPES[q.dtype],
            _splits("chunk", q, b, sq, hq, hkv, mp, pg), scale)
    return out


def paged_tree_attention(q: torch.Tensor, k_pool, v_pool,
                         tables: torch.Tensor, history_lens: torch.Tensor,
                         chunk_lens: torch.Tensor,
                         tree_masks: torch.Tensor, *,
                         scale: float | None = None) -> torch.Tensor:
    """Draft-tree verify attention against one layer's paged pool: the
    ``chunk_lens[b]`` nodes of slot b (written at ``[history, history +
    chunk)`` in topological order, parent before child) each attend the
    slot's history and the in-tree rows their ``tree_masks`` bits name.
    Rows past ``chunk_lens[b]`` come back as zeros.

    CPU tensors run the plain version. CUDA tensors launch the kernel
    for the pools' form (q in bf16, float16 or float32; pools in q's type
    or int8 ``{q, s}``; contiguous; hd a multiple of 4 from 16 to 256; a
    power-of-two page size; Sq <= 32; int32 masks) or raise — there is no fallback. A slot walks at most ``Mp``
    pages, as the plain version's ``[Mp*pg]`` view does.
    """
    if q.device.type == "cpu":
        return paged_tree_attention_plain(q, k_pool, v_pool, tables,
                                          history_lens, chunk_lens,
                                          tree_masks, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_tree_attention: no kernel for device "
                         f"{q.device}")
    pools = _check("paged_tree_attention", q, k_pool, v_pool, tables,
                   history_lens, chunk_lens)
    b, sq, hq, d = q.shape
    if sq > MAX_TREE_WIDTH:
        raise ValueError(f"paged_tree_attention: tree width {sq} exceeds "
                         f"the {MAX_TREE_WIDTH}-node packed ancestor mask")
    if tree_masks.dtype != torch.int32 or tree_masks.shape != (b, sq) \
            or not tree_masks.is_contiguous() \
            or tree_masks.device != q.device:
        raise ValueError("paged_tree_attention: tree_masks must be "
                         "contiguous int32 [B, Sq] on q's device")
    hkv, n_pages, pg, _ = pools[0].shape
    _check_page(paged_tree_attention, pg)
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)     # the kernel writes every row
    mp = tables.shape[1]
    _launch(paged_tree_attention, pools, q, tables.data_ptr(),
            history_lens.data_ptr(), chunk_lens.data_ptr(),
            tree_masks.data_ptr(), out.data_ptr(), b, sq, hq, hkv, n_pages,
            pg, mp, d, _build.KERNEL_DTYPES[q.dtype],
            _splits("tree", q, b, sq, hq, hkv, mp, pg), scale)
    return out


#: kernel launches since the last reset, per pool form (plain integers;
#: set one to 0 to start counting)
for _wrapper in (paged_decode_attention, paged_chunk_attention,
                 paged_tree_attention):
    _wrapper.launches = 0           # bf16 pools
    _wrapper.launches_int8 = 0      # int8 {q, s} pools
del _wrapper
