"""Parity of the port's int8 KV pool with the JAX package, on the CPU.

The quantized pool is ``{"q": int8 codes, "s": float32 [..., 1]
scales}`` with JAX's keys, so pools convert leaf by leaf through numpy.

- ``quantize_rows`` gives JAX's codes and scales bit for bit (zero rows
  included), and ``quantize_pool`` / ``pool_shape`` / ``pool_row_bytes``
  agree with JAX's.
- ``pool_write``, ``scatter_chunk`` (and ``scatter_chunk_kv``, both
  pools at once) and ``pool_move_rows`` on int8 pools give JAX's pools
  leaf for leaf, exactly, with out-of-range
  writes dropped; ``make_pool(..., "int8")`` is ``quantize_pool`` of
  zeros, and an unknown ``kv_dtype`` raises.
- The three paged attentions on quantized pools (CPU tensors: their
  plain versions over the float32 dequantized view) against JAX's
  ``paged_*_attention_pallas(interpret=True)`` and ``_xla``, pages of 8
  and 16 rows, GQA groups 1 and 4, within atol = rtol = 2e-5 (float32,
  JAX's own tolerance for its int8 kernels: the two sides sum in
  another order), zero-length slots exact zeros.
- ``llama_decode_step_paged`` and ``llama_prefill_chunk_paged`` (chunk
  and tree mode) on int8 pools against JAX's, logits within 1e-4 and
  the written pools leaf for leaf (codes equal, scales within 1e-5
  relative: a K row computed in another order moves its amax by a few
  float32 ulps).
- The port's engine with ``kv_dtype="int8"`` against the JAX engine
  with ``kv_dtype="int8", paged_attention="interpret"`` on the same
  weights: equal tokens and ``request_digest`` in a plain run, in two
  waves through the prefix cache and the chunk walk (``prefix_hits``
  equal), and in a speculative run (spec counters equal); the pool's
  page count equal to JAX's with and without ``kv_pool_bytes``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jllama
from gofr_tpu.ops import paged_kv as jkv
from gofr_tpu.ops.paged_attention import (paged_chunk_attention_pallas,
                                          paged_chunk_attention_xla,
                                          paged_decode_attention_pallas,
                                          paged_decode_attention_xla,
                                          paged_tree_attention_pallas,
                                          paged_tree_attention_xla)
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.integrity import request_digest
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.ops import paged_kv as tkv
from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                paged_decode_attention,
                                                paged_tree_attention)
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.spec import build_draft_tree

torch.set_num_threads(2)

ATOL = RTOL = 2e-5
LOGITS_ATOL = 1e-4


def _to_torch(pool):
    """A JAX pool (either form) as the port's, leaf by leaf."""
    if isinstance(pool, dict):
        return {k: torch.from_numpy(np.array(pool[k])) for k in tkv.QUANT_KEYS}
    return torch.from_numpy(np.array(pool))


def _assert_pool_equal(got, want, scale_rtol=0.0):
    """Leaf for leaf: codes exactly, scales within ``scale_rtol``."""
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]),
                               rtol=scale_rtol, atol=0)


# ------------------------------------------------------------- the pool

@pytest.mark.parametrize("magnitude", [1e-3, 1.0, 1e3])
def test_quantize_rows_matches_jax(magnitude):
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((40, 3, 16)) * magnitude).astype(np.float32)
    rows[0] = 0.0                        # zero rows: codes 0, the scale floor
    rows[5, 1] = 0.0
    rows[7, 2, 3] = 200 * magnitude      # one outlier dominates its row
    jq, js = jkv.quantize_rows(jnp.asarray(rows))
    tq, ts = tkv.quantize_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.shape == (40, 3, 1)
    assert not tq[0].any() and not tq[5, 1].any()
    # bf16 rows quantize from their float32 values, on both sides
    tb = torch.from_numpy(rows).bfloat16()
    jq, js = jkv.quantize_rows(jnp.asarray(tb.float().numpy()).astype(
        jnp.bfloat16))
    tq, ts = tkv.quantize_rows(tb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and dequantize to JAX's values
    np.testing.assert_array_equal(
        tkv.dequantize_rows(tq, ts).numpy(),
        np.asarray(jkv.dequantize_rows(jq, js, jnp.float32)))


def test_quantize_pool_shape_and_row_bytes_match_jax():
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((2, 2, 5, 8, 16)).astype(np.float32)
    jpool = jkv.quantize_pool(jnp.asarray(pool))
    tpool = tkv.quantize_pool(torch.from_numpy(pool))
    _assert_pool_equal(tpool, jpool)
    assert tkv.is_quantized_pool(tpool) and not tkv.is_quantized_pool(
        torch.from_numpy(pool))
    assert tkv.pool_shape(tpool) == tuple(jkv.pool_shape(jpool))
    assert tkv.pool_row_bytes(tpool) == jkv.pool_row_bytes(jpool) \
        == 2 * 2 * (16 + 4)
    assert tkv.pool_row_bytes(torch.from_numpy(pool)) == \
        jkv.pool_row_bytes(jnp.asarray(pool))
    layer = tkv.pool_layer(tpool, 1)
    assert layer["q"].shape == (2, 5, 8, 16) and layer["s"].shape == (2, 5, 8, 1)
    assert layer["q"].data_ptr() == tpool["q"][1].data_ptr()   # a view


def _quant_pools(seed, n_layers=2, hkv=2, n_pages=6, pg=8, hd=16):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((n_layers, hkv, n_pages, pg, hd)).astype(
        np.float32)
    return jkv.quantize_pool(jnp.asarray(pool))


@pytest.mark.parametrize("shape", ["decode", "chunk"])
def test_pool_write_matches_jax_and_drops_oob(shape):
    # page ids 6 (= Np, unallocated) and 9 are out of range: dropped
    jpool = _quant_pools(2)
    rng = np.random.default_rng(3)
    if shape == "decode":
        pids = np.array([4, 6, 0, 9], np.int32)
        offs = np.array([7, 1, 0, 3], np.int32)
    else:
        pids = np.array([[1, 1, 6], [9, 2, 3]], np.int32)
        offs = np.array([[2, 3, 0], [0, 5, 7]], np.int32)
    rows = rng.standard_normal((*pids.shape, 2, 16)).astype(np.float32)
    want = jkv.pool_write(jpool, 1, jnp.asarray(pids), jnp.asarray(offs),
                          jnp.asarray(rows))
    got = tkv.pool_write(_to_torch(jpool), 1, torch.from_numpy(pids).long(),
                         torch.from_numpy(offs).long(), torch.from_numpy(rows))
    _assert_pool_equal(got, want)
    # the in-range rows landed, quantized
    changed = (got["q"].numpy() != np.asarray(jpool["q"])).any(axis=(0, 1, 4))
    assert 0 < changed.sum() <= (pids < 6).sum()


def test_scatter_chunk_matches_jax_and_drops_oob():
    # slot 0: 10 rows from offset 3 (crosses a page); slot 1: 4 rows
    # from offset 14, its table ends at 2 pages (rows past 16 drop);
    # slot 2: a pad row (length 0, all-OOB table)
    jpool = _quant_pools(4)
    rng = np.random.default_rng(5)
    tables = np.array([[2, 5], [0, 3], [6, 6]], np.int32)
    offsets = np.array([3, 14, 0], np.int32)
    lens = np.array([10, 4, 0], np.int32)
    slab = rng.standard_normal((2, 3, 12, 2, 16)).astype(np.float32)
    want = jkv.scatter_chunk(jpool, jnp.asarray(tables), jnp.asarray(slab),
                             jnp.asarray(offsets), jnp.asarray(lens))
    got = tkv.scatter_chunk(_to_torch(jpool), torch.from_numpy(tables),
                            torch.from_numpy(slab), torch.from_numpy(offsets),
                            torch.from_numpy(lens))
    _assert_pool_equal(got, want)


def test_scatter_chunk_kv_is_jax_scatter_chunk_on_each_pool():
    # the engine's form: K and V slabs into their pools through one
    # in-range selection; each pool equals JAX's scatter_chunk of its slab
    jk, jv = _quant_pools(4), _quant_pools(7)
    rng = np.random.default_rng(6)
    tables = np.array([[2, 5], [0, 3], [6, 6]], np.int32)
    offsets = np.array([3, 14, 0], np.int32)
    lens = np.array([10, 4, 0], np.int32)
    k_slab, v_slab = (rng.standard_normal((2, 3, 12, 2, 16)).astype(np.float32)
                      for _ in range(2))
    wants = [jkv.scatter_chunk(jp, jnp.asarray(tables), jnp.asarray(slab),
                               jnp.asarray(offsets), jnp.asarray(lens))
             for jp, slab in ((jk, k_slab), (jv, v_slab))]
    got = tkv.scatter_chunk_kv(_to_torch(jk), _to_torch(jv),
                               torch.from_numpy(tables),
                               torch.from_numpy(k_slab),
                               torch.from_numpy(v_slab),
                               torch.from_numpy(offsets),
                               torch.from_numpy(lens))
    for g, w in zip(got, wants):
        _assert_pool_equal(g, w)


def test_pool_move_rows_moves_raw_codes_and_scales_like_jax():
    # overlapping source and destination sets, a destination past the
    # table and the engine's max_seq sentinel (both dropped)
    jpool = _quant_pools(6, n_pages=8, pg=4, hd=3)
    tables = np.array([[3, 6, 1], [0, 5, 8]], np.int32)   # 8 = OOB id
    src = np.array([[4, 5, 7, 8], [9, 10, 3, 40]], np.int32)
    dst = np.array([[4, 5, 6, 7], [1, 9, 12, 12]], np.int32)
    want = jkv.pool_move_rows(jpool, jnp.asarray(tables), jnp.asarray(src),
                              jnp.asarray(dst))
    got = tkv.pool_move_rows(_to_torch(jpool), torch.from_numpy(tables),
                             torch.from_numpy(src).long(),
                             torch.from_numpy(dst).long())
    _assert_pool_equal(got, want)
    # slot 0's old row 8 (page 1, row 0) is now at logical 7 (page 6,
    # row 3): its codes and its scale, unchanged
    for leaf in tkv.QUANT_KEYS:
        np.testing.assert_array_equal(got[leaf].numpy()[:, :, 6, 3],
                                      np.asarray(jpool[leaf])[:, :, 1, 0])


def test_make_pool_int8_is_quantize_pool_of_zeros():
    c = tllama.LlamaConfig.tiny()
    kp, vp = tllama.make_pool(c, 5, 8, "cpu", "int8")
    zeros = torch.zeros(c.n_layers, c.n_kv_heads, 5, 8, c.head_dim)
    want = tkv.quantize_pool(zeros)
    jwant = jkv.quantize_pool(jnp.zeros(zeros.shape, jnp.float32))
    for pool in (kp, vp):
        for leaf in tkv.QUANT_KEYS:
            assert torch.equal(pool[leaf], want[leaf])
            assert pool[leaf].is_contiguous()
        _assert_pool_equal(pool, jwant)
    assert kp["q"].data_ptr() != vp["q"].data_ptr()
    assert not tkv.slot_view(tkv.pool_layer(kp, 0),
                             torch.zeros(1, 2, dtype=torch.int32)).any()
    with pytest.raises(ValueError, match="kv_dtype"):
        tllama.make_pool(c, 5, 8, "cpu", "fp8")


# ------------------------------------------------------------ attention

def _paged_tables(rng, rows, page, n_pages, max_pages):
    tables = np.full((len(rows), max_pages), n_pages, np.int32)
    for i, n in enumerate(rows):
        need = -(-n // page)
        if need:
            tables[i, :need] = rng.choice(n_pages, size=need, replace=False)
    return tables


def _quant_case(seed, page, hq, hkv, hd=16, n_pages=32, max_pages=8):
    rng = np.random.default_rng(seed)
    kp = jkv.quantize_pool(jnp.asarray(rng.standard_normal(
        (hkv, n_pages, page, hd)).astype(np.float32)))
    vp = jkv.quantize_pool(jnp.asarray(rng.standard_normal(
        (hkv, n_pages, page, hd)).astype(np.float32)))
    return rng, kp, vp


def _assert_rows(got, pallas, xla, live):
    got = got.numpy()
    for want in (pallas, xla):
        np.testing.assert_allclose(got[live], np.asarray(want)[live],
                                   atol=ATOL, rtol=RTOL)
    assert not got[~live].any()          # padding rows, empty slots: zeros


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])     # groups 1, 4
def test_int8_decode_matches_pallas_interpret_and_xla(page, hq, hkv):
    rng, kp, vp = _quant_case(10 + page + hq, page, hq, hkv)
    lens = np.array([5, 17, 0, 40], np.int32)       # mid-page, empty, long
    tables = _paged_tables(rng, lens, page, 32, 8)
    q = rng.standard_normal((4, hq, 16)).astype(np.float32)
    jargs = (jnp.asarray(q), kp, vp, jnp.asarray(tables), jnp.asarray(lens))
    pallas = paged_decode_attention_pallas(*jargs, interpret=True)
    xla = paged_decode_attention_xla(*jargs)
    got = paged_decode_attention(torch.from_numpy(q), _to_torch(kp),
                                 _to_torch(vp), torch.from_numpy(tables),
                                 torch.from_numpy(lens))
    live = np.broadcast_to((lens > 0)[:, None], got.shape[:2])
    _assert_rows(got, pallas, xla, live)


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_int8_chunk_matches_pallas_interpret_and_xla(page, hq, hkv):
    rng, kp, vp = _quant_case(20 + page + hq, page, hq, hkv)
    hists = np.array([0, 11, 16, 0], np.int32)
    clens = np.array([13, 9, 5, 0], np.int32)
    tables = _paged_tables(rng, hists + clens, page, 32, 8)
    q = rng.standard_normal((4, 16, hq, 16)).astype(np.float32)
    jargs = (jnp.asarray(q), kp, vp, jnp.asarray(tables), jnp.asarray(hists),
             jnp.asarray(clens))
    pallas = paged_chunk_attention_pallas(*jargs, interpret=True)
    xla = paged_chunk_attention_xla(*jargs)
    got = paged_chunk_attention(
        torch.from_numpy(q), _to_torch(kp), _to_torch(vp),
        torch.from_numpy(tables), torch.from_numpy(hists),
        torch.from_numpy(clens))
    live = np.arange(16)[None, :] < clens[:, None]
    _assert_rows(got, pallas, xla, live)


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_int8_tree_matches_pallas_interpret_and_xla(page, hq, hkv):
    rng, kp, vp = _quant_case(30 + page + hq, page, hq, hkv)
    trees = [build_draft_tree(1, [[2, 3, 4], [2, 5]]),
             build_draft_tree(6, [[7, 8], [9, 10], [11]]),
             build_draft_tree(12, [[13, 14, 15, 16]])]
    width = 8
    hists = np.array([0, 11, 16, 0], np.int32)
    clens = np.array([trees[0].n_nodes, trees[1].n_nodes,
                      trees[2].n_nodes - 2, 0], np.int32)
    masks = np.ones((4, width), np.int32)
    for i, t in enumerate(trees):
        masks[i, :t.n_nodes] = t.masks
    tables = _paged_tables(rng, hists + clens, page, 32, 8)
    q = rng.standard_normal((4, width, hq, 16)).astype(np.float32)
    jargs = (jnp.asarray(q), kp, vp, jnp.asarray(tables), jnp.asarray(hists),
             jnp.asarray(clens), jnp.asarray(masks))
    pallas = paged_tree_attention_pallas(*jargs, interpret=True)
    xla = paged_tree_attention_xla(*jargs)
    got = paged_tree_attention(
        torch.from_numpy(q), _to_torch(kp), _to_torch(vp),
        torch.from_numpy(tables), torch.from_numpy(hists),
        torch.from_numpy(clens), torch.from_numpy(masks))
    live = np.arange(width)[None, :] < clens[:, None]
    _assert_rows(got, pallas, xla, live)


# ---------------------------------------------------------------- model

def _converted():
    jc = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.key(0), jc)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              tllama.LlamaConfig.tiny(), "cpu")
    return jc, jparams, tllama.LlamaConfig.tiny(), tparams


def test_int8_paged_decode_steps_match_jax():
    # three slots over a quantized pool holding a history: mid-page,
    # page-aligned, and one whose 4 steps run past its 2 pages (those
    # writes drop on both sides)
    jc, jparams, tc, tparams = _converted()
    rng = np.random.default_rng(40)
    pg, n_pages = 8, 12
    jkp, jvp = (jkv.quantize_pool(jnp.asarray(rng.standard_normal(
        (2, 2, n_pages, pg, 16)).astype(np.float32))) for _ in range(2))
    tables = np.full((3, 4), n_pages, np.int32)
    pages = rng.permutation(n_pages)
    tables[0, :4], tables[1, :3], tables[2, :2] = pages[:4], pages[4:7], \
        pages[7:9]
    lens = np.array([13, 16, 14], np.int32)
    tkp, tvp = _to_torch(jkp), _to_torch(jvp)
    jtok = jnp.asarray([3, 77, 200], jnp.int32)
    ttok = torch.tensor([3, 77, 200])
    jlen, tlen = jnp.asarray(lens), torch.from_numpy(lens)
    tt = torch.from_numpy(tables)
    for _ in range(4):
        jl, jkp, jvp = jllama.llama_decode_step_paged(
            jparams, jtok, jkp, jvp, jnp.asarray(tables), jlen, jc,
            implementation="xla")
        tl, tkp, tvp = tllama.llama_decode_step_paged(
            tparams, ttok, tkp, tvp, tt, tlen, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(-1)
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jlen, tlen = jlen + 1, tlen + 1
    _assert_pool_equal(tkp, jkp, scale_rtol=1e-5)
    _assert_pool_equal(tvp, jvp, scale_rtol=1e-5)


@pytest.mark.parametrize("mode", ["chunk", "tree"])
def test_int8_prefill_chunk_paged_matches_jax_interpret(mode):
    # row 0: a fresh chunk (or tree); row 1: after a mid-page 21-row
    # history; row 2: a pad row whose writes must drop
    jc, jparams, tc, tparams = _converted()
    rng = np.random.default_rng(41)
    pg, n_pages, mp, s = 8, 16, 5, 8
    jkp, jvp = (jkv.quantize_pool(jnp.asarray(rng.standard_normal(
        (2, 2, n_pages, pg, 16)).astype(np.float32))) for _ in range(2))
    tables = np.full((3, mp), n_pages, np.int32)
    pages = rng.permutation(n_pages)
    tables[0, :2], tables[1, :4] = pages[:2], pages[2:6]
    offsets = np.array([0, 21, 0], np.int32)
    tokens = rng.integers(0, 256, size=(3, s)).astype(np.int32)
    jkw, tkw = {}, {}
    if mode == "tree":
        trees = [build_draft_tree(5, [[1, 2, 3], [1, 7, 8, 9]]),
                 build_draft_tree(6, [[4, 4], [5]])]
        lens = np.array([trees[0].n_nodes, trees[1].n_nodes, 0], np.int32)
        depths = np.zeros((3, s), np.int32)
        masks = np.ones((3, s), np.int32)
        for i, t in enumerate(trees):
            tokens[i, :t.n_nodes] = t.tokens
            depths[i, :t.n_nodes] = t.depths
            masks[i, :t.n_nodes] = t.masks
        jkw = dict(return_all_logits=True, tree_depths=jnp.asarray(depths),
                   tree_masks=jnp.asarray(masks))
        tkw = dict(return_all_logits=True, tree_depths=torch.from_numpy(depths),
                   tree_masks=torch.from_numpy(masks))
    else:
        lens = np.array([8, 6, 0], np.int32)
    tkp, tvp = _to_torch(jkp), _to_torch(jvp)
    jl, jkp2, jvp2 = jllama.llama_prefill_chunk_paged(
        jparams, jnp.asarray(tokens), jkp, jvp, jnp.asarray(tables),
        jnp.asarray(offsets), jnp.asarray(lens), jc,
        implementation="interpret", **jkw)
    tl, tkp, tvp = tllama.llama_prefill_chunk_paged(
        tparams, torch.from_numpy(tokens).long(), tkp, tvp,
        torch.from_numpy(tables), torch.from_numpy(offsets),
        torch.from_numpy(lens), tc, **tkw)
    if mode == "tree":
        live = np.arange(s)[None, :] < lens[:, None]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=LOGITS_ATOL)
    else:
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   atol=LOGITS_ATOL)
    _assert_pool_equal(tkp, jkp2, scale_rtol=1e-5)
    _assert_pool_equal(tvp, jvp2, scale_rtol=1e-5)
    # one quantized row per live position landed; nothing else moved
    written = tkp["q"].numpy() != np.asarray(jkp["q"])
    assert written.any(axis=(0, 1, 4)).sum() == lens.sum()


# --------------------------------------------------------------- engine

def _converted_engines(**common):
    jc, jparams, tc, tparams = _converted()
    jeng = jax_llama_engine(
        jparams, jc,
        JaxEngineConfig(kv_layout="paged", kv_dtype="int8",
                        paged_attention="interpret", compile_cache_dir=None,
                        **common),
        implementation="xla")
    teng = llama_engine(tparams, tc, EngineConfig(kv_dtype="int8", **common),
                        device="cpu")
    assert teng._n_pages == jeng._n_pages
    assert teng._prefix_budget == jeng._prefix_budget
    return jeng, teng


def _serve(engine, params, *waves):
    """Each wave once the one before it has finished; all requests in
    order, and the stats after each wave."""
    engine.start()
    reqs, stats = [], []
    try:
        for wave in waves:
            batch = [engine.submit(p, params) for p in wave]
            deadline = time.time() + 120
            while time.time() < deadline and any(
                    r.finished_at is None and r.error is None for r in batch):
                time.sleep(0.005)
            reqs += batch
            stats.append(dict(engine.stats))
    finally:
        engine.stop()
    assert all(r.error is None and r.finished_at is not None for r in reqs), \
        [r.error for r in reqs]
    return reqs, stats


def _assert_same_requests(got, want, n_new):
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == n_new for r in got)
    for g, w in zip(got, want):
        assert g.prompt_tokens == w.prompt_tokens
        assert request_digest(g.prompt_tokens, g.params, g.generated) == \
            request_digest(w.prompt_tokens, w.params, w.generated)


def _both(jeng, teng, n_new, *waves):
    want, jstats = _serve(jeng, JaxSamplingParams(temperature=0.0,
                                                  max_new_tokens=n_new), *waves)
    got, tstats = _serve(teng, SamplingParams(temperature=0.0,
                                              max_new_tokens=n_new), *waves)
    _assert_same_requests(got, want, n_new)
    # every page is free or pinned by the prefix cache, never both
    pinned = {p for pages in teng._prefix_cache.values() for p in pages}
    assert len(teng._free_pages) + len(pinned) == teng._n_pages
    assert sorted(set(teng._free_pages) | pinned) == list(range(teng._n_pages))
    return jstats, tstats


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in sizes]


def test_int8_engine_matches_jax_engine():
    jeng, teng = _converted_engines(max_batch=4, max_seq=128, page_size=16,
                                    seed=0, decode_steps_per_pass=4,
                                    prefix_cache=False)
    _both(jeng, teng, 13, _prompts(11, (5, 20, 40, 70)))
    assert sorted(teng._free_pages) == list(range(teng._n_pages))
    assert tkv.is_quantized_pool(teng.k_cache)


def test_int8_engine_prefix_cache_and_chunk_walk_match_jax_engine():
    # a single 16-row bucket, so prompts past it walk in chunks; the
    # second wave shares page-aligned prefixes of 16, 32 and 64 rows
    jeng, teng = _converted_engines(max_batch=4, max_seq=128, page_size=16,
                                    seed=0, decode_steps_per_pass=4,
                                    prefill_batch=4, prefill_buckets=(16,),
                                    prefix_cache=True)
    first = _prompts(11, (5, 20, 40, 70))
    tail = _prompts(12, (10, 12, 20, 30))
    second = [first[1][:16] + tail[0], first[2][:35] + tail[1],
              first[3][:66] + tail[2], tail[3]]
    jstats, tstats = _both(jeng, teng, 13, first, second)
    assert tstats[-1]["prefix_hits"] == jstats[-1]["prefix_hits"] == 3


def test_int8_speculative_engine_matches_jax_engine():
    jeng, teng = _converted_engines(max_batch=2, max_seq=128, page_size=16,
                                    seed=0, decode_steps_per_pass=4,
                                    prefix_cache=False, speculative=True,
                                    spec_adaptive=False, spec_ngram=1)
    jstats, tstats = _both(jeng, teng, 24, [[11, 22, 33, 44] * 12],
                           [[5, 6, 7] * 9, [40, 41, 42, 43, 44] * 6])
    keys = ("spec_passes", "spec_drafted", "spec_accepted")
    assert [{k: s[k] for k in keys} for s in tstats] == \
        [{k: s[k] for k in keys} for s in jstats]
    assert tstats[0]["spec_drafted"] > 0 and tstats[0]["spec_accepted"] > 0
    assert sorted(teng._free_pages) == list(range(teng._n_pages))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kv_pool_bytes", [None, 150_000])
def test_pool_pages_match_jax_engine(kv_dtype, kv_pool_bytes):
    jc, jparams, tc, tparams = _converted()
    common = dict(max_batch=3, max_seq=100, page_size=16, seed=0,
                  kv_dtype=kv_dtype, kv_pool_bytes=kv_pool_bytes)
    jeng = jax_llama_engine(jparams, jc, JaxEngineConfig(
        kv_layout="paged", compile_cache_dir=None, **common),
        implementation="xla")
    teng = llama_engine(tparams, tc, EngineConfig(**common), device="cpu")
    assert teng._n_pages == jeng._n_pages
    assert teng._prefix_budget == jeng._prefix_budget
    assert tkv.pool_shape(teng.k_cache)[2] == teng._n_pages
    # tiny: 2 layers x 2 KV heads, hd 16, float32: a 16-row page costs
    # 2 * 16 * 2 * 2 * 16 * 4 = 8192 bytes, or 2 * 16 * 2 * 2 * 20 =
    # 2560 quantized
    per_page = 8192 if kv_dtype == "bf16" else 2560
    budget = kv_pool_bytes if kv_pool_bytes is not None else 3 * 7 * 8192
    assert teng._n_pages == (3 * 7 if kv_pool_bytes is None
                             and kv_dtype == "bf16" else budget // per_page)


def test_unknown_kv_dtype_raises():
    c = tllama.LlamaConfig.tiny()
    params = tllama.llama_init(c, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        llama_engine(params, c, EngineConfig(kv_dtype="fp8"), device="cpu")
