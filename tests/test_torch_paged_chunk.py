"""Parity of the port's paged chunk attention with the JAX package, on
the CPU.

The port's ``paged_chunk_attention`` (CPU tensors: its plain version)
is held against JAX's ``paged_chunk_attention_pallas`` in interpret
mode and against ``paged_chunk_attention_xla``, on the cases of
``tests/test_paged_prefill.py``: fresh prompts, page-aligned and
mid-page histories, a zero-length tail slot, GQA groups 1 and 4,
several q-blocks and several 128-row KV chunks, and pool rows past each
query's horizon poisoned. Inputs come from numpy with a seed. Only rows
below each slot's chunk length are compared (the rest are padding the
caller discards); the port gives zeros there, so a zero-length slot is
exact zeros. Tolerance: atol = rtol = 1e-5 in float32, as in
``test_torch_ops.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.paged_attention import (paged_chunk_attention_pallas,
                                          paged_chunk_attention_xla)
from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                paged_chunk_attention_plain)

torch.set_num_threads(2)

ATOL = RTOL = 1e-5


def _chunk_case(seed, *, hq=4, hkv=2, hd=16, page=8, max_pages=10,
                n_pages=32, hists=(0, 11, 16), clens=(13, 5, 0), sq=16):
    """q, pools and per-slot tables covering history + chunk rows (the
    rest of each table is the OOB id), as numpy arrays."""
    rng = np.random.default_rng(seed)
    b = len(hists)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_pages, page, hd)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_pages, page, hd)).astype(np.float32)
    tables = np.full((b, max_pages), n_pages, np.int32)
    for i, (h, c) in enumerate(zip(hists, clens)):
        need = -(-(h + c) // page)
        if need:
            tables[i, :need] = rng.choice(n_pages, size=need, replace=False)
    return (q, kp, vp, tables, np.asarray(hists, np.int32),
            np.asarray(clens, np.int32))


def _port(case):
    return paged_chunk_attention(*(torch.from_numpy(a) for a in case))


def _jax(case, **kw):
    args = [jnp.asarray(a) for a in case]
    return (np.asarray(paged_chunk_attention_pallas(*args, interpret=True,
                                                    **kw)),
            np.asarray(paged_chunk_attention_xla(*args)))


def _assert_matches(got, want, clens):
    got = got.numpy()
    valid = np.arange(got.shape[1])[None, :] < np.asarray(clens)[:, None]
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=RTOL)
    assert not got[~valid].any()        # padding rows: zeros


@pytest.mark.parametrize("hists,clens", [
    ((0, 0, 0), (16, 9, 1)),          # fresh prompts, chunk ends mid-page
    ((8, 16, 24), (16, 13, 5)),       # page-aligned histories
    ((3, 11, 21), (16, 13, 7)),       # mid-page histories
    ((0, 19, 40), (16, 16, 0)),       # zero-length tail slot
])
def test_chunk_matches_pallas_interpret_and_xla(hists, clens):
    case = _chunk_case(0, hists=hists, clens=clens)
    got = _port(case)
    pallas, xla = _jax(case)
    _assert_matches(got, pallas, clens)
    _assert_matches(got, xla, clens)
    for i, c in enumerate(clens):
        if c == 0:
            assert not got[i].any()     # zero-length slot: exact zeros


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])   # GQA groups 1, 4
def test_chunk_gqa_groups_match(hq, hkv):
    case = _chunk_case(1, hq=hq, hkv=hkv, hists=(0, 11, 16),
                       clens=(13, 16, 7))
    pallas, xla = _jax(case)
    got = _port(case)
    _assert_matches(got, pallas, case[5])
    _assert_matches(got, xla, case[5])


def test_chunk_several_q_blocks_and_kv_chunks():
    # Sq = 64 in four 16-row q-blocks on the JAX side; 200- and 77-row
    # histories span several of its 128-row KV chunks
    case = _chunk_case(2, page=16, max_pages=24, n_pages=64,
                       hists=(200, 77), clens=(64, 37), sq=64)
    pallas, xla = _jax(case, block_q=16)
    got = _port(case)
    _assert_matches(got, pallas, case[5])
    _assert_matches(got, xla, case[5])


def test_chunk_ignores_rows_past_each_horizon():
    # poison every pool row at logical position >= history + chunk (13),
    # through the slot's table: the valid rows must not move
    case = _chunk_case(3, hists=(8,), clens=(5,), sq=8)
    q, kp, vp, tables, h, c = case
    page = kp.shape[2]
    poisoned = kp.copy()
    for logical in range(13, tables.shape[1] * page):
        pid = tables[0, logical // page]
        if pid < kp.shape[1]:
            poisoned[:, pid, logical % page] = 1e6
    clean_pallas, _ = _jax(case)
    got = _port((q, poisoned, vp, tables, h, c))
    _assert_matches(got, clean_pallas, c)
    # and the chunk's own future rows: poisoning positions 9.. (after
    # chunk row 0, at position 8) must leave row 0 as it was
    for logical in range(9, 13):
        poisoned[:, tables[0, logical // page], logical % page] = 1e6
    row0 = _port((q, poisoned, vp, tables, h, c))[0, 0].numpy()
    np.testing.assert_allclose(row0, clean_pallas[0, 0], atol=ATOL,
                               rtol=RTOL)


def test_wrapper_on_cpu_is_the_plain_version():
    case = _chunk_case(4)
    args = [torch.from_numpy(a) for a in case]
    before = paged_chunk_attention.launches
    torch.testing.assert_close(paged_chunk_attention(*args),
                               paged_chunk_attention_plain(*args),
                               atol=0, rtol=0)
    assert paged_chunk_attention.launches == before   # no kernel on CPU
