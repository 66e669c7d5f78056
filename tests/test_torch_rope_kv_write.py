"""Parity of the port's fused RoPE + K/V write with the JAX package, on
the CPU.

``ops/paged_kv.rope_kv_write`` on CPU tensors is its plain version
(``apply_rope`` on q and k, then the plain write); on the card it is one
kernel launch a layer, held bit for bit to that plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Here it goes against
the JAX package's ``apply_rope`` + ``pool_write`` (what the JAX model
steps run, ``gofr_tpu/models/llama.py``) on the same numpy inputs from a
seed, over:

- decode ([B] rows at their lengths), chunk ([B, S] rows at ``offsets +
  i``) and tree positions (RoPE at ``offsets + depth``, rows at
  ``offsets + i``);
- a plain pool in the rows' dtype and an int8 ``{q, s}`` pool;
- ``rope_scaling`` off and on (Llama-3.2's factor 32);
- head_dim 64 and 128;
- rows dropped by page id ``Np``, page id -1 and an offset past the
  page.

The rows are bf16, the dtype the kernel takes: rotated q and k are
rounded to bf16 on both sides, and must agree within the tolerance of
``test_torch_ops.py::test_rope_matches_jax`` (atol = rtol = 1e-5); the
plain pool's rows and the int8 pool's codes and scales must be equal.
(In float32 the two packages' ``cos`` / ``sin`` differ by one ulp on
about 5 % of the angles, which would move int8 scales.)

Page id -1: JAX's ``.at[].set(mode="drop")`` wraps a negative index
(-1 writes the last page) where the port drops every id outside ``[0,
Np)``, as its kernels do; the JAX side is therefore given ``Np`` for it,
and a separate assertion records that JAX would have written the last
page.

Also here: ``scatter_chunk_kv`` on the CPU against JAX's
``scatter_chunk`` of each slab, both pool forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu.ops.paged_kv as jkv
import gofr_tpu.ops.rope as jrope
from gofr_tpu_torch.ops import paged_kv as tkv
from gofr_tpu_torch.ops import rope as trope

torch.set_num_threads(2)

ATOL = RTOL = 1e-5
LLAMA32_SCALING = {"factor": 32.0, "low_freq_factor": 1.0,
                   "high_freq_factor": 4.0, "original_max_position": 8192}
N_LAYERS, HQ, HKV, N_PAGES, PG, LI = 2, 4, 2, 6, 8, 1


def _f32(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pools(rng, d, form):
    """(JAX pool, port pool): bf16 [L, Hkv, Np, pg, d], or its int8
    ``{q, s}`` form from JAX's ``quantize_pool`` (leaf for leaf)."""
    pool = rng.standard_normal((N_LAYERS, HKV, N_PAGES, PG, d)).astype(
        np.float32)
    if form == "int8":
        jpool = jkv.quantize_pool(jnp.asarray(pool))
        return jpool, {k: torch.from_numpy(np.array(jpool[k]))
                       for k in tkv.QUANT_KEYS}
    return (jnp.asarray(pool).astype(jnp.bfloat16),
            torch.from_numpy(pool).bfloat16())


def _assert_pool_equal(got, want):
    if isinstance(got, dict):
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    else:
        np.testing.assert_array_equal(_f32(got), _f32(want))


def _coords(rng, mode):
    """(lead shape, RoPE positions, page ids, offsets) for one step of
    ``mode``: decode, 5 slots at lengths up to 8191; chunk, 3 slots x 6
    rows at ``offsets + i``; tree, the same rows RoPE'd at ``offsets +
    depth`` (depths of a two-branch tree, distinct from the node index).
    The write coordinates are distinct (page, offset) draws, apart from
    the positions, as the kernel takes them; three rows are then dropped:
    page id Np, page id -1, and an in-range page with an offset past the
    page."""
    if mode == "decode":
        lead = (5,)
        positions = rng.integers(0, 8192, size=lead)
    else:
        lead = (3, 6)
        offsets = rng.integers(0, 8000, size=(3, 1))
        depth = np.array([0, 1, 1, 2, 2, 3])[None, :]
        positions = offsets + (np.arange(6)[None, :] if mode == "chunk"
                               else depth)
    n = int(np.prod(lead))
    flat = rng.permutation(N_PAGES * PG)[:n]
    pids = (flat // PG).astype(np.int32)
    offs = (flat % PG).astype(np.int32)
    pids[0], pids[2] = N_PAGES, -1
    offs[3] = PG + 3
    return (lead, positions.astype(np.int32), pids.reshape(lead),
            offs.reshape(lead))


def _rows(rng, lead, heads, d):
    x = rng.standard_normal((*lead, heads, d)).astype(np.float32) * 2
    return (jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scaling", [None, LLAMA32_SCALING],
                         ids=["plain_rope", "llama32_scaling"])
@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["decode", "chunk", "tree"])
def test_rope_kv_write_matches_jax_rope_and_pool_write(mode, form, scaling,
                                                       d):
    rng = np.random.default_rng([3, d, len(mode), int(form == "int8"),
                                 int(scaling is not None)])
    lead, positions, pids, offs = _coords(rng, mode)
    (jq, tq), (jk, tk), (jv, tv) = (_rows(rng, lead, h, d)
                                    for h in (HQ, HKV, HKV))
    (jk_pool, tk_pool), (jv_pool, tv_pool) = (_pools(rng, d, form)
                                              for _ in range(2))
    inv_t = trope.rope_frequencies(d, 500000.0, scaling)
    inv_j = jrope.rope_frequencies(d, 500000.0, scaling)

    before = (tkv.rope_kv_write.launches, tkv.rope_kv_write.launches_int8)
    q_rot = tkv.rope_kv_write(tq, tk, tv, torch.from_numpy(positions), inv_t,
                              tk_pool, tv_pool, LI, torch.from_numpy(pids),
                              torch.from_numpy(offs))
    # CPU tensors run the plain version: no kernel launch is counted
    assert (tkv.rope_kv_write.launches,
            tkv.rope_kv_write.launches_int8) == before

    jpos = jnp.asarray(positions)
    want_q = jrope.apply_rope(jq, jpos, inv_j)
    want_k = jrope.apply_rope(jk, jpos, inv_j)
    assert q_rot.dtype == torch.bfloat16 and q_rot.shape == tq.shape
    np.testing.assert_allclose(_f32(q_rot), _f32(want_q), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(
        _f32(trope.apply_rope(tk, torch.from_numpy(positions), inv_t)),
        _f32(want_k), atol=ATOL, rtol=RTOL)

    jpids = jnp.asarray(np.where(pids < 0, N_PAGES, pids))   # see docstring
    joffs = jnp.asarray(offs)
    _assert_pool_equal(tk_pool, jkv.pool_write(jk_pool, LI, jpids, joffs,
                                               want_k))
    _assert_pool_equal(tv_pool, jkv.pool_write(jv_pool, LI, jpids, joffs, jv))
    # the three dropped rows left their pages alone; the rest landed
    kept = (pids >= 0) & (pids < N_PAGES) & (offs < PG)
    assert kept.sum() == pids.size - 3
    leaf = tv_pool["q"] if form == "int8" else tv_pool
    before_leaf = jv_pool["q"] if form == "int8" else jv_pool
    changed = (_f32(leaf) != _f32(before_leaf)).any(axis=(0, 1, 4))
    assert changed.sum() == kept.sum()


def test_jax_pool_write_wraps_a_negative_page_id_the_port_drops():
    # the deliberate difference behind the -1 row above: JAX writes the
    # last page, the port (plain version and kernel alike) writes nothing
    rng = np.random.default_rng(4)
    jpool, tpool = _pools(rng, 64, "bf16")
    rows = rng.standard_normal((1, HKV, 64)).astype(np.float32)
    pids, offs = np.array([-1], np.int32), np.array([2], np.int32)
    jgot = jkv.pool_write(jpool, 0, jnp.asarray(pids), jnp.asarray(offs),
                          jnp.asarray(rows).astype(jnp.bfloat16))
    assert (_f32(jgot)[0, :, N_PAGES - 1, 2] != _f32(jpool)[0, :, N_PAGES - 1,
                                                           2]).any()
    tgot = tkv.pool_write(tpool.clone(), 0, torch.from_numpy(pids),
                          torch.from_numpy(offs),
                          torch.from_numpy(rows).bfloat16())
    assert torch.equal(tgot, tpool)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_scatter_chunk_kv_matches_jax_scatter_chunk(form, d):
    # slot 0: 10 rows from offset 3 (crosses a page); slot 1: 6 rows from
    # offset 12, its table ends at 2 pages (rows past 16 drop); slot 2: a
    # dummy row (length 1, all-OOB table), as a group prefill pads
    rng = np.random.default_rng([5, d, int(form == "int8")])
    (jk, tk), (jv, tv) = (_pools(rng, d, form) for _ in range(2))
    tables = np.array([[2, 5], [0, 3], [N_PAGES, N_PAGES]], np.int32)
    offsets = np.array([3, 12, 0], np.int32)
    lens = np.array([10, 6, 1], np.int32)
    slabs = [rng.standard_normal((N_LAYERS, 3, 12, HKV, d)).astype(np.float32)
             for _ in range(2)]
    before = (tkv.scatter_chunk_kv.launches,
              tkv.scatter_chunk_kv.launches_int8)
    got = tkv.scatter_chunk_kv(
        tk, tv, torch.from_numpy(tables),
        *(torch.from_numpy(s).bfloat16() for s in slabs),
        torch.from_numpy(offsets), torch.from_numpy(lens))
    assert (tkv.scatter_chunk_kv.launches,
            tkv.scatter_chunk_kv.launches_int8) == before
    for g, jp, slab in zip(got, (jk, jv), slabs):
        _assert_pool_equal(g, jkv.scatter_chunk(
            jp, jnp.asarray(tables), jnp.asarray(slab).astype(jnp.bfloat16),
            jnp.asarray(offsets), jnp.asarray(lens)))
