"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at shapes beyond the serving path's: head_dim 128, GQA groups 1 to
16 (3 among them: 63 live rows in a 64-row tile) and 32 / 48 (cut into
sub-groups on the card), page sizes 16 to 64, lengths that are not a
multiple of a tile or a page, zero-length slots and OOB-padded tables;
and every head dim and type (``SHAPES``) on its route, the 16-bit
flash / chunk / tree rows with the P-rounding term of their type.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one. On the card, from the repository root (``--noconftest``:
the suite's conftest imports JAX, which the port's machine need not
have):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, per element, as in ``chip_smoke.py``: ``|out - ref| <= ATOL
+ RTOL |ref|``, where both sides round their output to bf16 (RTOL =
2^-7). Flash also rounds each softmax weight to bf16 before P·V while
its sum stays float32, which moves the output by at most 2^-8 of the
attention average of |V|: that term is added to its limit. The paged
chunk and tree kernels round P the same way and take the same limit.
Paged decode keeps P in float32.

Every paged case also runs the split-KV path the wrapper picks
(``kv_splits``: S blocks per walk, merged in a thread-block cluster);
the cases marked "S = 8" put the longest walks on 8 splits, with empty
splits, zero-length slots, page-aligned lengths and a tree whose slot
has no history. Separate tests hold the merge to determinism and the
tree kernel on causal masks bit for bit to the chunk kernel at a split
shape.

The paged kernels' int8 branches run the same cases on
``paged_kv.quantize_pool`` of the same random bf16 pools, against the
plain versions over the dequantized (float32) pool, with the same
limits: for chunk and tree the P-rounding term is taken over the
dequantized |V| (P V carries p times the row scale, rounded to bf16).

The KV write kernel (``kv_write``, and ``pool_write`` on CUDA) must give
its plain version's pools bit for bit, in both forms (int8 codes and
scales included), dropping out-of-range and -1 page ids; so must its
fused RoPE entry (``rope_kv_write``: the rotated q too, decode, chunk
and tree positions apart from the write coordinates, hd 64 and 128,
``rope_scaling`` off and on, one launch a call; positions shifted by one
and the rotation's sign flipped must not agree) and its slab entry
(``scatter_chunk_kv``: every layer in one launch, hd 32 to 256). A
decode step launches the fused entry once a layer and the per-layer
write never. The compiled
decode dispatch (``serving/decode_graph.py``) must give, on a small
bf16 model at ``max_batch`` rows, the uncaptured pass's tokens, state
and pools bit for bit, for an all-greedy batch and a mixed one, on both
pool forms; and a replay on a pool that is not the captured one raises.

The weight-dequantizing GEMM (``ops/quant.wq_gemm``, int8 and packed
int4 codes in the one ``[N, K]`` layout: every llama3_1b product and
ragged N and K, rows 1 to 200, M not a multiple of 8 among them) must
agree with its plain version within ATOL + 2 RTOL |ref| for the bf16
output (rounded twice on each side: the product, then the product times
the scale) and ATOL + RTOL |ref| for the float32 head, give the same
bits on a second call, fail with its codes read transposed, and raise
on what it does not take (JAX's ``[K, N]`` layout included); and the
decode graph's replay must equal the uncaptured pass bit for bit with
int8 and int4 weights.
"""

import pytest
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.ops import paged_attention
from gofr_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_plain)
from gofr_tpu_torch.ops.paged_attention import (
    kv_splits, paged_chunk_attention, paged_chunk_attention_plain,
    paged_decode_attention, paged_decode_attention_plain,
    paged_tree_attention, paged_tree_attention_plain)
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.ops.paged_kv import (kv_write, kv_write_plain,
                                         pool_write, quantize_pool,
                                         rope_kv_write, rope_kv_write_plain,
                                         scatter_chunk, scatter_chunk_kv,
                                         scatter_chunk_kv_plain,
                                         scatter_chunk_plain)
from gofr_tpu_torch.ops.rope import rope_frequencies
from gofr_tpu_torch.ops import quant
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.spec import build_draft_tree

pytestmark = pytest.mark.cuda

RTOL = 2.0 ** -7
P_ROUND = 2.0 ** -8
ATOL = 1e-3
# float32 outputs (the LM head): both sides sum the same bf16 products in
# float32, so they differ by summation order only, far below bf16's 2^-9
RTOL_F32 = 2.0 ** -12
ATOL_F32 = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return resolve_device("cuda")


def _randn(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev).bfloat16()


@pytest.mark.parametrize("p,s,hq,hkv,d,lens", [
    (2, 64, 4, 4, 64, [64, 64]),               # one tile, no GQA
    (2, 100, 8, 2, 64, [100, 37]),             # S not a tile multiple
    (3, 200, 8, 2, 128, [1, 130, 200]),        # head_dim 128, kv_len 1
    (1, 1024, 32, 8, 64, [1000]),              # widest bucket, llama3_1b heads
    (2, 33, 16, 1, 64, [33, 5]),               # group 16 (MQA)
    (2, 150, 12, 4, 64, [150, 77]),            # group 3
    (1, 100, 12, 4, 128, [90]),                # group 3, head_dim 128
])
def test_flash_kernel_matches_plain(dev, p, s, hq, hkv, d, lens):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(gen, dev, p, s, hq, d), _randn(gen, dev, p, s, hkv, d),
               _randn(gen, dev, p, s, hkv, d))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_lengths=kv_len)
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, kv_lengths=kv_len)
    ref = ref.float()
    limit = (ATOL + RTOL * ref.abs() + P_ROUND * flash_attention_plain(
        q, k, v.abs(), kv_lengths=kv_len).float())
    excess = ((out.float() - ref).abs() / limit).max().item()
    assert excess <= 1.0, f"worst err / limit {excess}"


def _paged_case(gen, dev, b, hq, hkv, d, pg, n_pages, lens):
    """Pool, OOB-padded tables over distinct random pages, lengths."""
    mp = max(1, -(-max(lens) // pg))
    tables = torch.full((b, mp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(1))
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // pg)
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    return (_randn(gen, dev, b, hq, d), _randn(gen, dev, hkv, n_pages, pg, d),
            _randn(gen, dev, hkv, n_pages, pg, d), tables.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


DECODE_CASES = [
    (3, 4, 1, 64, 16, 20, [0, 5, 40]),                  # len 0, group 4
    (4, 32, 8, 64, 64, 64, [1, 64, 65, 700]),           # llama3_1b heads
    (2, 8, 2, 128, 32, 16, [33, 100]),                  # head_dim 128
    (2, 16, 1, 64, 64, 8, [129, 3]),                    # group 16
    (3, 8, 8, 64, 16, 24, [16, 17, 0]),                 # group 1
    (1, 32, 8, 64, 64, 40, [2000]),                     # one request, S = 8
    # S = 8: splits with no page (3 rows, and length 0), a page-aligned
    # length, and a 32-page walk
    (4, 32, 8, 64, 64, 48, [2000, 3, 0, 64]),
    (2, 8, 2, 128, 32, 80, [1024, 640]),                # hd 128, aligned, S = 8
    (3, 16, 1, 64, 16, 140, [1500, 16, 17]),            # group 16, pg 16, S = 8
    (3, 12, 4, 64, 16, 40, [0, 33, 300]),               # group 3
    (2, 12, 4, 128, 64, 80, [2000, 5]),                 # group 3, hd 128, S = 8
]


def _abs_pool(pool):
    """|pool| for either form (codes keep their scales)."""
    if isinstance(pool, dict):
        return {"q": pool["q"].abs(), "s": pool["s"]}
    return pool.abs()


@pytest.mark.parametrize("b,hq,hkv,d,pg,n_pages,lens", DECODE_CASES)
def test_paged_decode_kernel_matches_plain(dev, b, hq, hkv, d, pg, n_pages,
                                           lens):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, kp, vp, tables, lengths = _paged_case(gen, dev, b, hq, hkv, d, pg,
                                             n_pages, lens)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, tables, lengths)
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(q, kp, vp, tables, lengths)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=RTOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert out[i].abs().max().item() == 0.0   # exact zeros


@pytest.mark.parametrize("b,hq,hkv,d,pg,n_pages,lens", DECODE_CASES)
def test_paged_decode_int8_kernel_matches_plain(dev, b, hq, hkv, d, pg,
                                                n_pages, lens):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, kp, vp, tables, lengths = _paged_case(gen, dev, b, hq, hkv, d, pg,
                                             n_pages, lens)
    kq, vq = quantize_pool(kp), quantize_pool(vp)
    before = (paged_decode_attention.launches,
              paged_decode_attention.launches_int8)
    out = paged_decode_attention(q, kq, vq, tables, lengths)
    assert (paged_decode_attention.launches,
            paged_decode_attention.launches_int8) == (before[0], before[1] + 1)
    ref = paged_decode_attention_plain(q, kq, vq, tables, lengths)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL,
                               rtol=RTOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert out[i].abs().max().item() == 0.0   # exact zeros


CHUNK_CASES = [
    # llama3_1b heads, 64-row pages, mid-page histories, a zero-length
    # slot, Sq not a multiple of the 16-position tile
    (100, 32, 8, 64, 64, 32, [0, 130, 64, 0], [100, 37, 1, 0]),
    (1, 8, 2, 128, 16, 24, [0, 45, 16], [1, 1, 1]),        # Sq = 1, hd 128
    (70, 4, 4, 128, 16, 40, [200, 3], [70, 66]),            # group 1
    (33, 16, 1, 64, 64, 16, [513, 0], [33, 20]),            # group 16
    (48, 8, 2, 64, 16, 48, [17, 300, 0], [48, 5, 0]),       # group 4, pg 16
    # group 3: 21-position tiles of 63 live rows, the last tile partial
    (50, 12, 4, 64, 64, 32, [0, 130, 64], [50, 37, 1]),
    (30, 12, 4, 128, 16, 60, [100, 0], [30, 21]),           # group 3, hd 128
    (200, 16, 4, 128, 64, 48, [300, 0], [200, 150]),        # hd 128, long
    # pg 16: a 64-row K/V tile spans 4 pages, and the first q tile's walk
    # limit (history 37 + 16 positions = 53) ends mid-tile and mid-page
    (40, 8, 2, 64, 16, 64, [37, 5], [40, 19]),
]


def _chunk_case(dev, sq, hq, hkv, d, pg, n_pages, hists, clens):
    gen = torch.Generator(device=dev).manual_seed(0)
    b = len(hists)
    mp = max(1, -(-max(h + c for h, c in zip(hists, clens)) // pg))
    tables = torch.full((b, mp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(1))
    used = 0
    for i, (h, c) in enumerate(zip(hists, clens)):
        need = -(-(h + c) // pg)
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    tables = tables.to(dev)
    q = _randn(gen, dev, b, sq, hq, d)
    kp, vp = (_randn(gen, dev, hkv, n_pages, pg, d) for _ in range(2))
    hist = torch.tensor(hists, dtype=torch.int32, device=dev)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, hist, clen


def _assert_chunk_like(out, plain, q, kp, vp, rest, clen):
    """Kernel output within the P-rounding limit of the plain version
    (``plain(q, k, v, *rest)``), and zeros on padding rows."""
    ref = plain(q, kp, vp, *rest).float()
    limit = (ATOL + RTOL * ref.abs()
             + P_ROUND * plain(q, kp, _abs_pool(vp), *rest).float())
    excess = ((out.float() - ref).abs() / limit).max().item()
    assert excess <= 1.0, f"worst err / limit {excess}"
    padding = torch.arange(q.shape[1], device=q.device)[None, :] \
        >= clen[:, None]
    if padding.any():                  # padding rows and empty slots: zeros
        assert out[padding].abs().max().item() == 0.0


@pytest.mark.parametrize("sq,hq,hkv,d,pg,n_pages,hists,clens", CHUNK_CASES)
def test_paged_chunk_kernel_matches_plain(dev, sq, hq, hkv, d, pg, n_pages,
                                          hists, clens):
    q, kp, vp, tables, hist, clen = _chunk_case(dev, sq, hq, hkv, d, pg,
                                                n_pages, hists, clens)
    before = paged_chunk_attention.launches
    out = paged_chunk_attention(q, kp, vp, tables, hist, clen)
    assert paged_chunk_attention.launches == before + 1
    _assert_chunk_like(out, paged_chunk_attention_plain, q, kp, vp,
                       (tables, hist, clen), clen)


@pytest.mark.parametrize("sq,hq,hkv,d,pg,n_pages,hists,clens", CHUNK_CASES)
def test_paged_chunk_int8_kernel_matches_plain(dev, sq, hq, hkv, d, pg,
                                               n_pages, hists, clens):
    q, kp, vp, tables, hist, clen = _chunk_case(dev, sq, hq, hkv, d, pg,
                                                n_pages, hists, clens)
    kq, vq = quantize_pool(kp), quantize_pool(vp)
    before = paged_chunk_attention.launches_int8
    out = paged_chunk_attention(q, kq, vq, tables, hist, clen)
    assert paged_chunk_attention.launches_int8 == before + 1
    _assert_chunk_like(out, paged_chunk_attention_plain, q, kq, vq,
                       (tables, hist, clen), clen)


def _tree_masks(width, n_slots, branches, seed):
    """[n_slots, width] int32 ancestor masks of seeded draft trees that
    fill ``width`` nodes (the last slot's tree is a chain), and each
    tree's node count."""
    gen = torch.Generator().manual_seed(seed)
    masks = torch.ones(n_slots, width, dtype=torch.int32)
    sizes = []
    for i in range(n_slots):
        b = 1 if i == n_slots - 1 else branches
        depth = max(1, (width - 1) // b)
        chains = [torch.randint(0, 9, (depth,), generator=gen).tolist()
                  for _ in range(b)]
        tree = build_draft_tree(7, chains, max_nodes=width)
        masks[i, :tree.n_nodes] = torch.tensor(tree.masks, dtype=torch.int64
                                               ).to(torch.int32)
        sizes.append(tree.n_nodes)
    return masks, sizes


TREE_CASES = [
    # the serving shape: llama3_1b heads, 64-row pages, a 1 + 4 x 2 tree
    # in the 16-wide bucket, mid-page and long histories, an empty slot
    (16, 32, 8, 64, 64, 2, [0, 1, 63, 1000]),
    (2, 8, 2, 128, 16, 1, [5, 0, 40]),           # width 2, hd 128
    (32, 4, 4, 64, 16, 4, [17, 300]),            # width 32, group 1
    (8, 16, 1, 64, 64, 3, [129, 0, 64]),         # group 16
    (32, 8, 2, 128, 64, 2, [0, 70, 700]),        # width 32, hd 128
    # S = 8: a 1900-row history beside a slot with no history (its nodes
    # see only their in-tree ancestors), one request alone, and hd 128 at
    # 16-row pages
    (16, 32, 8, 64, 64, 2, [1900, 0]),
    (16, 32, 8, 64, 64, 2, [1900]),
    (32, 8, 2, 128, 16, 4, [700, 0, 1900]),
    (16, 12, 4, 64, 64, 2, [0, 45, 700]),        # group 3
    (16, 12, 4, 128, 16, 2, [33, 0, 1000]),      # group 3, hd 128, pg 16
]


def _tree_case(dev, width, hq, hkv, d, pg, branches, hists):
    gen = torch.Generator(device=dev).manual_seed(0)
    b = len(hists)
    masks, sizes = _tree_masks(width, b, branches, seed=width + hq)
    # slot 0 with no history is left empty (chunk 0): exact zeros
    clens = [0 if i == 0 and h == 0 else n
             for i, (h, n) in enumerate(zip(hists, sizes))]
    mp = max(1, -(-max(h + width for h in hists) // pg))
    n_pages = b * mp + 2
    tables = torch.full((b, mp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(1))
    used = 0
    for i, (h, c) in enumerate(zip(hists, clens)):
        need = -(-(h + c) // pg)
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    tables, masks = tables.to(dev), masks.to(dev)
    q = _randn(gen, dev, b, width, hq, d)
    kp, vp = (_randn(gen, dev, hkv, n_pages, pg, d) for _ in range(2))
    hist = torch.tensor(hists, dtype=torch.int32, device=dev)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, hist, clen, masks


@pytest.mark.parametrize("width,hq,hkv,d,pg,branches,hists", TREE_CASES)
def test_paged_tree_kernel_matches_plain(dev, width, hq, hkv, d, pg, branches,
                                         hists):
    q, kp, vp, tables, hist, clen, masks = _tree_case(
        dev, width, hq, hkv, d, pg, branches, hists)
    before = paged_tree_attention.launches
    out = paged_tree_attention(q, kp, vp, tables, hist, clen, masks)
    assert paged_tree_attention.launches == before + 1
    _assert_chunk_like(out, paged_tree_attention_plain, q, kp, vp,
                       (tables, hist, clen, masks), clen)


@pytest.mark.parametrize("width,hq,hkv,d,pg,branches,hists", TREE_CASES)
def test_paged_tree_int8_kernel_matches_plain(dev, width, hq, hkv, d, pg,
                                              branches, hists):
    q, kp, vp, tables, hist, clen, masks = _tree_case(
        dev, width, hq, hkv, d, pg, branches, hists)
    kq, vq = quantize_pool(kp), quantize_pool(vp)
    before = paged_tree_attention.launches_int8
    out = paged_tree_attention(q, kq, vq, tables, hist, clen, masks)
    assert paged_tree_attention.launches_int8 == before + 1
    _assert_chunk_like(out, paged_tree_attention_plain, q, kq, vq,
                       (tables, hist, clen, masks), clen)


def _pools(kp, vp, form):
    return (kp, vp) if form == "bf16" else (quantize_pool(kp),
                                             quantize_pool(vp))


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_split_merge_is_deterministic_and_agrees_unsplit(dev, form,
                                                         monkeypatch):
    """At a split shape two runs are bit for bit equal (the merge sums in
    split order), and the unsplit kernel (S forced to 1) agrees within
    the kernels' limit; at the chunk serving shape S is 1 and the kernel
    is bit for bit itself."""
    q, kp, vp, tables, lengths = _paged_case(
        torch.Generator(device=dev).manual_seed(0), dev, 2, 32, 8, 64, 64,
        48, [2000, 700])
    kp, vp = _pools(kp, vp, form)
    assert kv_splits("decode", 2, 1, 32, 8, tables.shape[1], 64) == 8
    split = paged_decode_attention(q, kp, vp, tables, lengths)
    assert torch.equal(split, paged_decode_attention(q, kp, vp, tables,
                                                     lengths))
    ref = paged_decode_attention_plain(q, kp, vp, tables, lengths).float()
    with monkeypatch.context() as m:
        m.setattr(paged_attention, "kv_splits", lambda *a: 1)
        unsplit = paged_decode_attention(q, kp, vp, tables, lengths)
    for out in (split, unsplit):
        torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL)

    q, kp, vp, tables, hist, clen = _chunk_case(
        dev, 1024, 32, 8, 64, 64, 128, [0, 1024, 896, 0], [1024, 777, 6, 0])
    kp, vp = _pools(kp, vp, form)
    assert kv_splits("chunk", 4, 1024, 32, 8, tables.shape[1], 64) == 1
    out = paged_chunk_attention(q, kp, vp, tables, hist, clen)
    assert torch.equal(out, paged_chunk_attention(q, kp, vp, tables, hist,
                                                  clen))
    _assert_chunk_like(out, paged_chunk_attention_plain, q, kp, vp,
                       (tables, hist, clen), clen)


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_tree_on_causal_masks_is_the_chunk_kernel_at_a_split_shape(dev,
                                                                   form):
    q, kp, vp, tables, hist, clen, _ = _tree_case(
        dev, 16, 32, 8, 64, 64, 2, [1900, 700])
    kp, vp = _pools(kp, vp, form)
    assert kv_splits("tree", 2, 16, 32, 8, tables.shape[1], 64) == 8
    causal = torch.cumsum(1 << torch.arange(16, device=dev), 0)
    causal = causal.to(torch.int32)[None].expand(2, 16).contiguous()
    tree = paged_tree_attention(q, kp, vp, tables, hist, clen, causal)
    assert torch.equal(tree, paged_chunk_attention(q, kp, vp, tables, hist,
                                                   clen))


def test_kernel_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 4, 64, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    qb = torch.zeros(1, 8, 4, 98, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(qb, qb[:, :, :2].contiguous(),
                        qb[:, :, :2].contiguous())
    qd = torch.zeros(2, 4, 64, device=dev, dtype=torch.bfloat16)
    pool = torch.zeros(1, 3, 8, 64, device=dev, dtype=torch.bfloat16)
    tables = torch.zeros(2, 2, dtype=torch.int64, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="tables"):
        paged_decode_attention(qd, pool, pool, tables, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(qd.transpose(0, 1).contiguous().transpose(0, 1),
                               pool, pool, tables.int(), lengths)
    qc = torch.zeros(2, 5, 4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lengths"):
        paged_chunk_attention(qc, pool, pool, tables.int(), lengths,
                              lengths.long())
    pool2 = torch.zeros(2, 3, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="group"):
        paged_chunk_attention(torch.zeros(2, 5, 17, 64, device=dev,
                                          dtype=torch.bfloat16),
                              pool2, pool2, tables.int(), lengths, lengths)
    odd = torch.zeros(1, 3, 24, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="power of two"):
        paged_chunk_attention(qc, odd, odd, tables.int(), lengths, lengths)
    qt = torch.zeros(2, 33, 4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="32-node"):
        paged_tree_attention(qt, pool, pool, tables.int(), lengths, lengths,
                             torch.ones(2, 33, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="tree_masks"):
        paged_tree_attention(qc, pool, pool, tables.int(), lengths, lengths,
                             torch.ones(2, 5, dtype=torch.int64, device=dev))


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    qd = torch.zeros(2, 4, 64, device=dev, dtype=torch.bfloat16)
    pool = torch.zeros(1, 3, 8, 64, device=dev, dtype=torch.bfloat16)
    quant = quantize_pool(pool)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="plain or both quantized"):
        paged_decode_attention(qd, quant, pool, tables, lengths)
    with pytest.raises(TypeError, match="float32"):
        paged_decode_attention(qd, quant, {"q": quant["q"],
                                           "s": quant["s"].double()},
                               tables, lengths)
    with pytest.raises(ValueError, match=r"\[Hkv, Np, pg, 1\]"):
        paged_decode_attention(qd, quant, {"q": quant["q"],
                                           "s": quant["s"][..., 0]},
                               tables, lengths)
    with pytest.raises(TypeError, match="int8"):
        paged_decode_attention(qd, quant, {"q": quant["q"].to(torch.uint8),
                                           "s": quant["s"]}, tables, lengths)
    qc = torch.zeros(2, 5, 4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.ones(1, 3, 8, 2, device=dev)[..., :1]
        paged_chunk_attention(qc, quant, {"q": quant["q"], "s": strided},
                              tables, lengths, lengths)


def _leaves(pool):
    return [pool["q"], pool["s"]] if isinstance(pool, dict) else [pool]


def _clone(pool):
    if isinstance(pool, dict):
        return {k: t.clone() for k, t in pool.items()}
    return pool.clone()


def _assert_pools_equal(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w)


# (Hq, Hkv, hd): GQA groups 1, 3 and 4 (the write sees only Hkv and hd)
@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 64), (12, 4, 64), (32, 8, 64),
                                      (8, 8, 128), (12, 4, 128),
                                      (32, 8, 128)])
@pytest.mark.parametrize("rows", [(8,), (4, 16)])      # decode N = B, chunk
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_kv_write_kernel_matches_plain(dev, hq, hkv, d, rows, form):
    gen = torch.Generator(device=dev).manual_seed(5)
    n_layers, n_pages, pg = 2, 12, 16
    n = 1
    for r in rows:
        n *= r
    shape = (n_layers, hkv, n_pages, pg, d)
    k_pool = _randn(gen, dev, *shape)
    v_pool = _randn(gen, dev, *shape)
    if form == "int8":
        k_pool, v_pool = quantize_pool(k_pool), quantize_pool(v_pool)
    # distinct (page, offset) targets; a quarter of the rows out of range
    # (Np, Np + 3 and -1), which must be dropped
    flat = torch.randperm(n_pages * pg, generator=torch.Generator()
                          .manual_seed(n))[:n]
    pids, offs = (flat // pg).int(), (flat % pg).int()
    pids[::4] = torch.tensor([n_pages, -1, n_pages + 3],
                             dtype=torch.int32).repeat(n)[:len(pids[::4])]
    pids, offs = pids.reshape(rows).to(dev), offs.reshape(rows).to(dev)
    k_rows = _randn(gen, dev, *rows, hkv, d) * 3
    v_rows = _randn(gen, dev, *rows, hkv, d) / 5
    want_k, want_v = kv_write_plain(_clone(k_pool), _clone(v_pool), 1, pids,
                                    offs, k_rows, v_rows)
    before = kv_write.launches_int8 if form == "int8" else kv_write.launches
    got_k, got_v = kv_write(_clone(k_pool), _clone(v_pool), 1, pids, offs,
                            k_rows, v_rows)
    torch.cuda.synchronize()
    after = kv_write.launches_int8 if form == "int8" else kv_write.launches
    assert after == before + 1
    _assert_pools_equal(got_k, want_k)
    _assert_pools_equal(got_v, want_v)
    # K alone through pool_write's CUDA path
    _assert_pools_equal(pool_write(_clone(k_pool), 1, pids, offs, k_rows),
                        want_k)
    # the in-range rows landed and nothing else moved
    changed = (_leaves(got_v)[0] != _leaves(v_pool)[0]).any(-1).any(1)[1]
    assert 0 < int(changed.sum()) <= int(((pids >= 0)
                                         & (pids < n_pages)).sum())
    for g, w in zip(_leaves(got_k), _leaves(k_pool)):
        assert torch.equal(g[0], w[0])                  # the other layer


def test_kv_write_raises_on_what_the_kernel_does_not_take(dev):
    pool = torch.zeros(2, 2, 4, 8, 64, device=dev, dtype=torch.bfloat16)
    pids = torch.zeros(3, dtype=torch.int32, device=dev)
    rows = torch.zeros(3, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        kv_write(pool, pool, 0, pids, pids, rows.float(), rows.float())
    with pytest.raises(ValueError, match="plain or both quantized"):
        kv_write(pool, quantize_pool(pool), 0, pids, pids, rows, rows)
    with pytest.raises(ValueError, match="layer"):
        kv_write(pool, pool, 2, pids, pids, rows, rows)
    with pytest.raises(TypeError, match="bfloat16"):
        kv_write(pool.double(), pool.double(), 0, pids, pids, rows, rows)



@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_scatter_chunk_kernel_matches_plain(dev, form):
    # a group prefill's slab [L, P, S, Hkv, hd]: row 0 full, row 1 ragged,
    # row 2 a padded row (length 1, all-OOB table), row 3 a walk chunk at
    # an offset whose table ends in OOB pages, so rows past its pages drop;
    # K and V in one launch a layer (the engine's form), and K alone
    gen = torch.Generator(device=dev).manual_seed(9)
    n_layers, hkv, d, n_pages, pg, mp = 3, 4, 64, 24, 16, 6
    shape = (n_layers, hkv, n_pages, pg, d)
    pool, v_pool = _randn(gen, dev, *shape), _randn(gen, dev, *shape)
    if form == "int8":
        pool, v_pool = quantize_pool(pool), quantize_pool(v_pool)
    p, width = 4, 64
    tables = torch.full((p, mp), n_pages, dtype=torch.int32)
    tables[0, :4] = torch.tensor([3, 7, 1, 20])
    tables[1, :3] = torch.tensor([0, 5, 9])
    tables[3, :4] = torch.tensor([11, 2, 14, 17])      # 4 of 6 pages held
    tables = tables.to(dev)
    offsets = torch.tensor([0, 0, 0, 40], dtype=torch.int32, device=dev)
    lens = torch.tensor([64, 37, 1, 64], dtype=torch.int32, device=dev)
    slab = _randn(gen, dev, n_layers, p, width, hkv, d) * 2
    v_slab = _randn(gen, dev, n_layers, p, width, hkv, d) * 2
    args = (tables, slab, v_slab, offsets, lens)
    want = scatter_chunk_kv_plain(_clone(pool), _clone(v_pool), *args)
    attr = "launches_int8" if form == "int8" else "launches"
    before = getattr(scatter_chunk_kv, attr)
    got = scatter_chunk_kv(_clone(pool), _clone(v_pool), *args)
    torch.cuda.synchronize()
    assert getattr(scatter_chunk_kv, attr) == before + 1   # every layer
    for g, w in zip(got, want):
        _assert_pools_equal(g, w)
    before = getattr(kv_write, attr)
    one = scatter_chunk(_clone(pool), tables, slab, offsets, lens)
    assert getattr(kv_write, attr) == before + n_layers    # K: one a layer
    _assert_pools_equal(one, scatter_chunk_plain(_clone(pool), tables, slab,
                                                 offsets, lens))
    _assert_pools_equal(one, want[0])
    # rows landed, and the padded row's and the OOB pages' rows did not
    for g, before_pool in zip(got, (pool, v_pool)):
        changed = (_leaves(g)[0] != _leaves(before_pool)[0]).any(-1).any(1)[0]
        assert int(changed.sum()) == 64 + 37 + 24   # row 3: positions 40-63

@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_kv_write_slab_kernel_matches_plain_at_other_head_dims(dev, d, form):
    # two KV heads (one 16-byte vector row block shorter than a warp at d
    # 32), a slot crossing pages, a ragged one, a dummy row
    gen = torch.Generator(device=dev).manual_seed(d)
    n_layers, hkv, n_pages, pg = 3, 2, 10, 16
    shape = (n_layers, hkv, n_pages, pg, d)
    pools = [_randn(gen, dev, *shape) for _ in range(2)]
    if form == "int8":
        pools = [quantize_pool(p) for p in pools]
    tables = torch.tensor([[4, 1, 7], [0, 9, n_pages],
                           [n_pages] * 3], dtype=torch.int32, device=dev)
    offsets = torch.tensor([5, 0, 0], dtype=torch.int32, device=dev)
    lens = torch.tensor([40, 21, 1], dtype=torch.int32, device=dev)
    slabs = [_randn(gen, dev, n_layers, 3, 48, hkv, d) * 4 for _ in range(2)]
    args = (tables, *slabs, offsets, lens)
    want = scatter_chunk_kv_plain(*[_clone(p) for p in pools], *args)
    got = scatter_chunk_kv(*[_clone(p) for p in pools], *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_pools_equal(g, w)


#: Llama-3.2's rope_scaling (its checkpoints' config.json)
LLAMA32_SCALING = {"factor": 32.0, "low_freq_factor": 1.0,
                   "high_freq_factor": 4.0, "original_max_position": 8192}


def _rope_case(dev, gen, mode, hq, hkv, d, n_pages, pg):
    """(q, k, v, positions, pids, offs) of one fused write: decode, 8
    rows at positions up to 8191; chunk, 4 x 16 rows at ``offset + i``;
    tree, the same rows RoPE'd at ``offset + depth``. The write
    coordinates are distinct (page, offset) draws; a quarter of the rows
    is dropped (page ids Np, -1 and Np + 3), and one more by an offset
    past the page."""
    lead = (8,) if mode == "decode" else (4, 16)
    n = 1
    for r in lead:
        n *= r
    cpu = torch.Generator().manual_seed(n + len(mode))
    if mode == "decode":
        positions = torch.randint(0, 8192, lead, generator=cpu)
    else:
        base = torch.randint(0, 8000, (4, 1), generator=cpu)
        step = (torch.arange(16) if mode == "chunk"
                else torch.tensor([0, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6,
                                   6, 7]))
        positions = base + step[None, :]
    flat = torch.randperm(n_pages * pg, generator=cpu)[:n]
    pids, offs = (flat // pg).int(), (flat % pg).int()
    pids[::4] = torch.tensor([n_pages, -1, n_pages + 3],
                             dtype=torch.int32).repeat(n)[:len(pids[::4])]
    offs[1] = pg + 1
    q, k, v = (_randn(gen, dev, *lead, h, d) * 2 for h in (hq, hkv, hkv))
    return (q, k, v, positions.int().to(dev), pids.reshape(lead).to(dev),
            offs.reshape(lead).to(dev))


@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 64), (12, 4, 64), (8, 8, 128),
                                      (32, 8, 128)])
@pytest.mark.parametrize("mode", ["decode", "chunk", "tree"])
@pytest.mark.parametrize("scaling", [None, LLAMA32_SCALING],
                         ids=["plain_rope", "llama32_scaling"])
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_rope_kv_write_kernel_matches_plain(dev, hq, hkv, d, mode, scaling,
                                            form):
    gen = torch.Generator(device=dev).manual_seed(d + hq)
    n_layers, n_pages, pg, li = 2, 12, 16, 1
    shape = (n_layers, hkv, n_pages, pg, d)
    k_pool, v_pool = _randn(gen, dev, *shape), _randn(gen, dev, *shape)
    if form == "int8":
        k_pool, v_pool = quantize_pool(k_pool), quantize_pool(v_pool)
    q, k, v, positions, pids, offs = _rope_case(dev, gen, mode, hq, hkv, d,
                                                n_pages, pg)
    inv_freq = rope_frequencies(d, 500000.0, scaling, device=dev)

    def run(fn, pos=positions, inv=inv_freq):
        kp, vp = _clone(k_pool), _clone(v_pool)
        q_rot = fn(q, k, v, pos, inv, kp, vp, li, pids, offs)
        torch.cuda.synchronize()
        return q_rot, kp, vp

    want = run(rope_kv_write_plain)
    attr = "launches_int8" if form == "int8" else "launches"
    before = (getattr(rope_kv_write, attr), getattr(kv_write, attr))
    got = run(rope_kv_write)
    assert (getattr(rope_kv_write, attr),
            getattr(kv_write, attr)) == (before[0] + 1, before[1])
    assert got[0].shape == q.shape and got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], want[0])
    _assert_pools_equal(got[1], want[1])
    _assert_pools_equal(got[2], want[2])
    # the in-range rows landed, the dropped ones did not
    live = int(((pids >= 0) & (pids < n_pages) & (offs < pg)).sum())
    changed = (_leaves(got[2])[0] != _leaves(v_pool)[0]).any(-1).any(1)[li]
    assert 0 < int(changed.sum()) == live
    # planted faults: positions one late, the rotation's sign flipped
    for pos, inv in ((positions + 1, inv_freq), (positions, -inv_freq)):
        fault = run(rope_kv_write, pos, inv)
        assert not torch.equal(fault[0], want[0])
        assert not all(torch.equal(a, b) for a, b in
                       zip(_leaves(fault[1]), _leaves(want[1])))


def test_rope_kv_write_raises_on_what_the_kernel_does_not_take(dev):
    pool = torch.zeros(2, 2, 4, 8, 64, device=dev, dtype=torch.bfloat16)
    ids = torch.zeros(3, dtype=torch.int32, device=dev)
    q = torch.zeros(3, 4, 64, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(3, 2, 64, device=dev, dtype=torch.bfloat16)
    inv = rope_frequencies(64, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        rope_kv_write(q.float(), kv, kv, ids, inv, pool, pool, 0, ids, ids)
    with pytest.raises(ValueError, match="multiple of 4"):
        wide = torch.zeros(2, 2, 4, 8, 98, device=dev, dtype=torch.bfloat16)
        rope_kv_write(q, kv, kv, ids, inv, wide, wide, 0, ids, ids)
    with pytest.raises(ValueError, match="inv_freq"):
        rope_kv_write(q, kv, kv, ids, inv[:16], pool, pool, 0, ids, ids)
    with pytest.raises(ValueError, match="one entry per row"):
        rope_kv_write(q, kv, kv, ids[:2], inv, pool, pool, 0, ids, ids)
    with pytest.raises(ValueError, match="layer"):
        rope_kv_write(q, kv, kv, ids, inv, pool, pool, 2, ids, ids)
    with pytest.raises(ValueError, match="plain or both quantized"):
        rope_kv_write(q, kv, kv, ids, inv, pool, quantize_pool(pool), 0, ids,
                      ids)


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_decode_step_writes_through_the_fused_kernel_only(dev, form):
    # a replay of K = 4 steps over a 2-layer model: 8 fused launches, no
    # per-layer write
    eng = _graph_engine(dev, form, 1)
    eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_new_tokens=50))
    eng._admit()
    eng._decode_step()                   # captures, then replays
    attr = "launches_int8" if form == "int8" else "launches"
    before = (getattr(rope_kv_write, attr), getattr(kv_write, attr))
    eng._decode_step()
    assert (getattr(rope_kv_write, attr) - before[0],
            getattr(kv_write, attr) - before[1]) == (2 * 4, 0)


def _graph_engine(dev, form, m, quantize=None, tie=False, **cfg_kw):
    """A 2-layer bf16 model (hd 64) behind an engine of 4 slots, K = 4
    and ``m`` passes a dispatch, on a pool of the given form, its
    weights quantized with ``quantize``."""
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_dim=512, max_seq=256,
                      tie_embeddings=tie)
    params = llama_init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return llama_engine(params, cfg, EngineConfig(
        max_batch=4, max_seq=256, page_size=16, decode_steps_per_pass=4,
        decode_passes_per_dispatch=m, kv_dtype=form, seed=0, **cfg_kw),
        device=dev, quantize=quantize)


def _grow(eng, dispatches=1):
    """Pages for the next ``dispatches`` dispatches of every slot, as the
    engine's growth before each would allocate them, uploaded."""
    for i, req in enumerate(eng.active):
        if req is not None:
            eng._alloc_pages(i, int(eng.lengths[i])
                             + dispatches * eng._tokens_per_pass)
    eng._sync_tables()


@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("temps", [(0.0, 0.0, 0.0), (0.0, 0.9, 0.0)])
def test_decode_graph_replay_equals_the_uncaptured_pass(dev, form, temps):
    _replay_equals_uncaptured(_graph_engine(dev, form, 2), temps)


@pytest.mark.parametrize("quantize,tie", [("int8", False), ("int4", True)])
def test_decode_graph_replay_with_quantized_weights(dev, quantize, tie):
    before = quant.wq_gemm.launches + quant.wq_gemm.launches_int4
    _replay_equals_uncaptured(
        _graph_engine(dev, "bf16", 2, quantize=quantize, tie=tie),
        (0.0, 0.0, 0.0))
    assert quant.wq_gemm.launches + quant.wq_gemm.launches_int4 > before


def _replay_equals_uncaptured(eng, temps):
    rng = torch.Generator().manual_seed(3)
    reqs = [eng.submit(torch.randint(0, 512, (n,), generator=rng).tolist(),
                       SamplingParams(temperature=t, top_p=0.9, top_k=20,
                                      max_new_tokens=200))
            for n, t in zip((5, 40, 17), temps)]           # one idle row
    eng._admit()
    assert all(r.error is None and not r.pending_prefill for r in reqs)
    eng._decode_step()                   # captures, then replays
    _grow(eng)
    graph, greedy = eng._decode_graph, max(temps) == 0.0
    assert graph.captures == 1 and graph.replays == 1
    saved, pools = graph.save(), (_clone(eng.k_cache), _clone(eng.v_cache))
    graph.body(eng.k_cache, eng.v_cache, greedy)
    want = graph.save()
    want_pools = (_clone(eng.k_cache), _clone(eng.v_cache))
    graph.restore(saved)
    for live, old in zip((eng.k_cache, eng.v_cache), pools):
        for a, b in zip(_leaves(live), _leaves(old)):
            a.copy_(b)
    graph.run(eng.k_cache, eng.v_cache, greedy)
    torch.cuda.synchronize()
    got = graph.save()
    for name, value in want.items():
        if name != "generator":
            assert torch.equal(got[name], value), name
    _assert_pools_equal(eng.k_cache, want_pools[0])
    _assert_pools_equal(eng.v_cache, want_pools[1])
    if not greedy:   # the replay drew fresh noise from the generator
        assert torch.equal(got["generator"], want["generator"])


def test_decode_graph_replay_on_a_reassigned_pool_raises(dev):
    eng = _graph_engine(dev, "bf16", 1)
    eng.submit([1, 2, 3], SamplingParams(temperature=0.0,
                                         max_new_tokens=50))
    eng._admit()
    eng._decode_step()
    eng.k_cache = eng.k_cache.clone()
    with pytest.raises(RuntimeError, match="captured"):
        eng._decode_step()


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_pipelined_ring_equals_sequential_runs(dev, form):
    # depth 1: two dispatches in flight, collected in order, against the
    # same two dispatches run one after the other from the same state
    eng = _graph_engine(dev, form, 1, pipeline_depth=1)
    rng = torch.Generator().manual_seed(4)
    for n, t in zip((5, 40, 17), (0.0, 0.9, 0.0)):
        eng.submit(torch.randint(0, 512, (n,), generator=rng).tolist(),
                   SamplingParams(temperature=t, top_p=0.9, top_k=20,
                                  max_new_tokens=200))
    eng._admit()
    eng._collect_prefills()
    eng._decode_step()                   # captures; one dispatch in flight
    eng._drain_pending()
    _grow(eng, dispatches=2)
    graph = eng._decode_graph
    saved, pools = graph.save(), (_clone(eng.k_cache), _clone(eng.v_cache))
    want = [graph.run(eng.k_cache, eng.v_cache, False) for _ in range(2)]
    want_state = graph.save()
    want_pools = (_clone(eng.k_cache), _clone(eng.v_cache))
    graph.restore(saved)
    for live, old in zip((eng.k_cache, eng.v_cache), pools):
        for a, b in zip(_leaves(live), _leaves(old)):
            a.copy_(b)
    handles = [graph.launch(eng.k_cache, eng.v_cache, False)
               for _ in range(2)]
    got = [graph.collect(h) for h in handles]
    for g, w in zip(got, want):
        assert (g == w).all()
    for name, value in want_state.items():
        assert torch.equal(graph.save()[name], value), name
    _assert_pools_equal(eng.k_cache, want_pools[0])
    _assert_pools_equal(eng.v_cache, want_pools[1])


def test_launch_into_an_uncollected_ring_buffer_raises(dev):
    eng = _graph_engine(dev, "bf16", 1, pipeline_depth=1)
    eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_new_tokens=50))
    eng._admit()
    eng._collect_prefills()
    eng._sync_decode_state()
    _grow(eng, dispatches=3)
    graph = eng._decode_graph
    first = graph.launch(eng.k_cache, eng.v_cache, True)
    graph.launch(eng.k_cache, eng.v_cache, True)
    replays = graph.replays
    with pytest.raises(RuntimeError, match="uncollected"):
        graph.launch(eng.k_cache, eng.v_cache, True)
    assert graph.replays == replays       # refused before it replayed
    tokens = graph.collect(first)
    assert graph.launch(eng.k_cache, eng.v_cache, True) == first
    assert tokens.shape == (4, 4)


#: (K, N, head) of the weight-dequantizing GEMM's cases, every matrix
#: [N, K]: llama3_1b's products (wq, wk, w1, w2, the head) and ragged
#: ones (N not a multiple of the 64-channel tile, K not of a stage)
WQ_CASES = [(2048, 2048, False), (2048, 512, False), (2048, 8192, False),
            (8192, 2048, False), (2048, 128256, True), (2048, 1000, False),
            (224, 136, False), (128, 40, True), (256, 8, True)]
WQ_ROWS = (1, 3, 8, 16, 17, 40, 64, 128, 200)


def _wq_pair(dev, gen, form, k, n):
    qfn = quant.quantize_int8 if form == "int8" else quant.quantize_int4
    return qfn(_randn(gen, dev, n, k), axis=1)


@pytest.mark.parametrize("form", ["int8", "int4"])
@pytest.mark.parametrize("k,n,head", WQ_CASES)
def test_wq_gemm_kernel_matches_plain(dev, form, k, n, head):
    gen = torch.Generator(device=dev).manual_seed(k + n)
    w = _wq_pair(dev, gen, form, k, n)
    out_dtype = torch.float32 if head else None
    for m in WQ_ROWS:
        x = _randn(gen, dev, m, k)
        got = quant.wq_gemm(x, w, out_dtype=out_dtype)
        want = quant.wq_gemm_plain(x, w, out_dtype=out_dtype)
        assert got.dtype == want.dtype and got.shape == (m, n)
        if head:
            limit = ATOL_F32 + RTOL_F32 * want.abs()
            # a head rounded to bf16 (its accumulator or its output) fails
            rounded = got.bfloat16().float()
            assert not ((rounded - want).abs() <= limit).all(), m
        else:
            limit = ATOL + 2 * RTOL * want.float().abs()
        assert ((got.float() - want.float()).abs() <= limit).all(), m
        again = quant.wq_gemm(x, w, out_dtype=out_dtype)
        assert torch.equal(got, again)            # deterministic merge
        if form == "int8" and k == n and m in (8, 128):
            # the codes read transposed ([K, N] taken for [N, K]) fail
            bad = {"q": w["q"].t().contiguous(), "s": w["s"]}
            wrong = quant.wq_gemm(x, bad, out_dtype=out_dtype)
            assert not ((wrong.float() - want.float()).abs()
                        <= limit).all(), m


def test_wq_gemm_raises_on_what_the_kernel_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    w = _wq_pair(dev, gen, "int8", 64, 32)               # [N 32, K 64]
    x = _randn(gen, dev, 4, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        quant.wq_gemm(x.float(), w)
    with pytest.raises(ValueError, match="contract"):
        quant.wq_gemm(_randn(gen, dev, 4, 48), w)
    with pytest.raises(ValueError, match="multiple"):
        quant.wq_gemm(_randn(gen, dev, 4, 40),
                      _wq_pair(dev, gen, "int8", 40, 32))
    with pytest.raises(ValueError, match="contiguous"):
        quant.wq_gemm(_randn(gen, dev, 64, 8).t(), w)
    with pytest.raises(TypeError, match="scales"):
        quant.wq_gemm(x, {"q": w["q"], "s": w["s"].half()})
    # a quantized [K, N] leaf is JAX's layout: no product on the card
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        quant.qmatmul(x, quant.quantize_int8(_randn(gen, dev, 64, 32),
                                             axis=0))


# ------------------------------------- every head dim and float type
#: (head dim, activation type): OpenLLaMA-3B's 100 in float16, JAX's demo
#: width 16 in float32, 256 in bf16, float16 at 64 (beside the bf16
#: kernels' width), 80 / 96 between them, and 132 / 160 in the wgmma
#: kernels' 192-column class (132: 8-byte copies of 16-bit rows, 4-byte
#: copies of int8 rows)
SHAPES = [(100, torch.float16), (16, torch.float32), (256, torch.bfloat16),
          (64, torch.float16), (80, torch.float32), (96, torch.bfloat16),
          (132, torch.bfloat16), (160, torch.float16)]
SHAPE_IDS = [f"d{d}-{str(t)[6:]}" for d, t in SHAPES]


def _randn_t(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _within(out, ref, dtype, abs_v_ref=None):
    """Per element |out - ref| <= atol + rtol |ref| (+ the P-rounding
    term): float32 against the float32 plain version differs by summation
    order only (ATOL_F32, RTOL_F32); a 16-bit output is rounded on both
    sides (ATOL, RTOL). The wgmma kernels (16-bit flash, chunk and tree)
    round P to the 16-bit type before P·V, 2^-8 relative in bf16 and
    2^-11 in float16, which moves the output by at most that share of
    the attention average of |V| (``abs_v_ref``: the plain version over
    |V|); the split-KV decode and the float32 kernel keep P in float32."""
    atol, rtol = (ATOL_F32, RTOL_F32) if dtype == torch.float32 \
        else (ATOL, RTOL)
    ref = ref.float()
    limit = atol + rtol * ref.abs()
    if abs_v_ref is not None and dtype != torch.float32:
        p_round = P_ROUND if dtype == torch.bfloat16 else 2.0 ** -11
        limit = limit + p_round * abs_v_ref.float()
    excess = ((out.float() - ref).abs() / limit).max()
    assert out.dtype == dtype and excess.item() <= 1.0, \
        f"worst err / limit {excess.item()}"


def _cast_pools(kp, vp, dtype, form):
    kp, vp = kp.to(dtype), vp.to(dtype)
    return (kp, vp) if form == "plain" else (quantize_pool(kp),
                                              quantize_pool(vp))


@pytest.mark.parametrize("d,dtype", SHAPES, ids=SHAPE_IDS)
def test_flash_kernel_matches_plain_at_every_shape(dev, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(d)
    for p, s, hq, hkv, lens in ((3, 200, 8, 2, [1, 130, 200]),
                                (2, 33, 4, 4, [33, 0]),
                                (1, 300, 12, 4, [290])):
        q = _randn_t(gen, dev, dtype, p, s, hq, d)
        k, v = (_randn_t(gen, dev, dtype, p, s, hkv, d) for _ in range(2))
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        before = flash_attention.launches
        out = flash_attention(q, k, v, kv_lengths=kv_len)
        assert flash_attention.launches == before + 1
        live = kv_len > 0     # a kv_len 0 row: zeros here, uniform in plain
        _within(out[live], flash_attention_plain(
            q, k, v, kv_lengths=kv_len)[live], dtype,
            flash_attention_plain(q, k, v.abs(), kv_lengths=kv_len)[live])
        if (~live).any():
            assert out[~live].abs().max().item() == 0.0


@pytest.mark.parametrize("d,dtype", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("form", ["plain", "int8"])
def test_paged_kernels_match_plain_at_every_shape(dev, d, dtype, form):
    """Decode, chunk and tree, over groups 1, 3 and 4, pages of 16 and 64
    rows, lengths 0 to 1500, padding rows zero."""
    gen = torch.Generator(device=dev).manual_seed(d + 1)
    attr = "launches_int8" if form == "int8" else "launches"
    for b, hq, hkv, pg, n_pages, lens in (
            (4, 32, 8, 64, 64, [0, 1, 65, 1500]),
            (3, 12, 4, 16, 40, [0, 33, 300]),
            (2, 8, 8, 16, 24, [17, 200])):
        q, kp, vp, tables, lengths = _paged_case(gen, dev, b, hq, hkv, d, pg,
                                                 n_pages, lens)
        q = q.to(dtype)
        kp, vp = _cast_pools(kp, vp, dtype, form)
        before = getattr(paged_decode_attention, attr)
        out = paged_decode_attention(q, kp, vp, tables, lengths)
        assert getattr(paged_decode_attention, attr) == before + 1
        _within(out, paged_decode_attention_plain(q, kp, vp, tables,
                                                  lengths), dtype)
        if (lengths == 0).any():
            assert out[lengths == 0].abs().max().item() == 0.0
    for case in ((70, 32, 8, d, 64, 32, [0, 130, 64, 0], [70, 37, 1, 0]),
                 (30, 12, 4, d, 16, 60, [100, 0], [30, 21]),
                 (40, 4, 4, d, 16, 64, [37, 5], [40, 19])):
        q, kp, vp, tables, hist, clen = _chunk_case(dev, *case)
        q = q.to(dtype)
        kp, vp = _cast_pools(kp, vp, dtype, form)
        before = getattr(paged_chunk_attention, attr)
        out = paged_chunk_attention(q, kp, vp, tables, hist, clen)
        assert getattr(paged_chunk_attention, attr) == before + 1
        _within(out, paged_chunk_attention_plain(q, kp, vp, tables, hist,
                                                 clen), dtype,
                paged_chunk_attention_plain(q, kp, _abs_pool(vp), tables,
                                            hist, clen))
        pad = torch.arange(q.shape[1], device=dev)[None, :] >= clen[:, None]
        if pad.any():
            assert out[pad].abs().max().item() == 0.0
    for width, hq, hkv, pg, branches, hists in (
            (16, 32, 8, 64, 2, [0, 1, 63, 1000]),
            (32, 12, 4, 16, 4, [17, 0, 300])):
        q, kp, vp, tables, hist, clen, masks = _tree_case(
            dev, width, hq, hkv, d, pg, branches, hists)
        q = q.to(dtype)
        kp, vp = _cast_pools(kp, vp, dtype, form)
        before = getattr(paged_tree_attention, attr)
        out = paged_tree_attention(q, kp, vp, tables, hist, clen, masks)
        assert getattr(paged_tree_attention, attr) == before + 1
        _within(out, paged_tree_attention_plain(q, kp, vp, tables, hist,
                                                clen, masks), dtype,
                paged_tree_attention_plain(q, kp, _abs_pool(vp), tables,
                                           hist, clen, masks))
        causal = torch.cumsum(1 << torch.arange(width, device=dev), 0)
        causal = causal.to(torch.int32)[None].expand(len(hists), width)
        chain = paged_tree_attention(q, kp, vp, tables, hist, clen,
                                     causal.contiguous())
        # a tree on causal masks walks as a chunk, on every route
        assert torch.equal(chain, paged_chunk_attention(q, kp, vp, tables,
                                                        hist, clen))


#: (head dim, type) at GQA groups 32 and 48 (sub-groups of 16 heads a
#: block; 8 in decode at head dims above 128)
WIDE = [(64, torch.bfloat16), (16, torch.float32), (256, torch.float16)]


@pytest.mark.parametrize("d,dtype", WIDE,
                         ids=[f"d{d}-{str(t)[6:]}" for d, t in WIDE])
@pytest.mark.parametrize("hq,hkv", [(64, 2), (48, 1)], ids=["g32", "g48"])
@pytest.mark.parametrize("form", ["plain", "int8"])
def test_kernels_match_plain_at_wide_groups(dev, d, dtype, hq, hkv, form):
    gen = torch.Generator(device=dev).manual_seed(hq + d)
    q = _randn_t(gen, dev, dtype, 2, 150, hq, d)
    k, v = (_randn_t(gen, dev, dtype, 2, 150, hkv, d) for _ in range(2))
    kv_len = torch.tensor([150, 77], dtype=torch.int32, device=dev)
    _within(flash_attention(q, k, v, kv_lengths=kv_len),
            flash_attention_plain(q, k, v, kv_lengths=kv_len), dtype,
            flash_attention_plain(q, k, v.abs(), kv_lengths=kv_len))
    q, kp, vp, tables, lengths = _paged_case(gen, dev, 3, hq, hkv, d, 16, 40,
                                             [0, 33, 300])
    kp, vp = _cast_pools(kp, vp, dtype, form)
    q = q.to(dtype)
    out = paged_decode_attention(q, kp, vp, tables, lengths)
    _within(out, paged_decode_attention_plain(q, kp, vp, tables, lengths),
            dtype)
    assert out[0].abs().max().item() == 0.0
    q, kp, vp, tables, hist, clen = _chunk_case(dev, 30, hq, hkv, d, 16, 60,
                                                [100, 0], [30, 21])
    q = q.to(dtype)
    kp, vp = _cast_pools(kp, vp, dtype, form)
    _within(paged_chunk_attention(q, kp, vp, tables, hist, clen),
            paged_chunk_attention_plain(q, kp, vp, tables, hist, clen), dtype,
            paged_chunk_attention_plain(q, kp, _abs_pool(vp), tables, hist,
                                        clen))
    q, kp, vp, tables, hist, clen, masks = _tree_case(dev, 16, hq, hkv, d, 64,
                                                      2, [0, 700])
    q = q.to(dtype)
    kp, vp = _cast_pools(kp, vp, dtype, form)
    _within(paged_tree_attention(q, kp, vp, tables, hist, clen, masks),
            paged_tree_attention_plain(q, kp, vp, tables, hist, clen, masks),
            dtype, paged_tree_attention_plain(q, kp, _abs_pool(vp), tables,
                                              hist, clen, masks))


@pytest.mark.parametrize("d,dtype", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("form", ["plain", "int8"])
def test_kv_writes_match_plain_at_every_shape(dev, d, dtype, form):
    """The fused RoPE write (decode and tree positions), the slab write
    and the per-layer write give their plain versions' bits."""
    gen = torch.Generator(device=dev).manual_seed(d + 2)
    n_layers, hkv, n_pages, pg, li = 2, 4, 12, 16, 1
    shape = (n_layers, hkv, n_pages, pg, d)
    k_pool, v_pool = _cast_pools(_randn(gen, dev, *shape),
                                 _randn(gen, dev, *shape), dtype, form)
    inv_freq = rope_frequencies(d, 10000.0, device=dev)
    for mode in ("decode", "tree"):
        q, k, v, positions, pids, offs = (
            t.to(dtype) if t.is_floating_point() else t
            for t in _rope_case(dev, gen, mode, 12, hkv, d, n_pages, pg))

        def run(fn, pos=positions, inv=inv_freq):
            kp, vp = _clone(k_pool), _clone(v_pool)
            q_rot = fn(q, k, v, pos, inv, kp, vp, li, pids, offs)
            torch.cuda.synchronize()
            return q_rot, kp, vp

        want = run(rope_kv_write_plain)
        got = run(rope_kv_write)
        assert got[0].dtype == dtype and torch.equal(got[0], want[0])
        _assert_pools_equal(got[1], want[1])
        _assert_pools_equal(got[2], want[2])
        for pos, inv in ((positions + 1, inv_freq), (positions, -inv_freq)):
            fault = run(rope_kv_write, pos, inv)
            assert not torch.equal(fault[0], want[0])
    tables = torch.tensor([[4, 1, 7], [0, 9, n_pages], [n_pages] * 3],
                          dtype=torch.int32, device=dev)
    offsets = torch.tensor([5, 0, 0], dtype=torch.int32, device=dev)
    lens = torch.tensor([40, 21, 1], dtype=torch.int32, device=dev)
    slabs = [_randn_t(gen, dev, dtype, n_layers, 3, 48, hkv, d) * 4
             for _ in range(2)]
    args = (tables, *slabs, offsets, lens)
    want = scatter_chunk_kv_plain(_clone(k_pool), _clone(v_pool), *args)
    got = scatter_chunk_kv(_clone(k_pool), _clone(v_pool), *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_pools_equal(g, w)
    pids = torch.tensor([3, n_pages, 5, -1, 0], dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 1, 15, 2, 7], dtype=torch.int32, device=dev)
    rows = [_randn_t(gen, dev, dtype, 5, hkv, d) for _ in range(2)]
    want = kv_write_plain(_clone(k_pool), _clone(v_pool), li, pids, offs,
                          *rows)
    got = kv_write(_clone(k_pool), _clone(v_pool), li, pids, offs, *rows)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_pools_equal(g, w)
