"""Parity of the port's speculative tree-verify pieces with the JAX
package, on the CPU.

- ``paged_tree_attention`` (CPU tensors: its plain version) and
  ``tree_attention`` against JAX's ``paged_tree_attention_pallas`` in
  interpret mode and ``paged_tree_attention_xla``, over draft trees of 1,
  2 and 4 branches (from ``build_draft_tree``), GQA groups 1 and 4 and
  pages of 8 and 16 rows, each case holding a fresh slot, a mid-page
  history, a topological prefix of a tree (a shorter chunk) and a
  zero-length slot. Only rows below each slot's chunk length are
  compared (the rest are padding the caller discards); the port gives
  zeros there. Tolerance: atol = rtol = 2e-5 in float32 (the two sides
  sum in another order).
- A chain-shaped tree gives the chunk attention's output, and poisoning
  a sibling branch's pool rows leaves every node outside it bit for bit
  unchanged.
- ``pool_move_rows`` against JAX's, exactly, with overlapping source and
  destination sets and dropped out-of-table destinations.
- The port's copy of ``serving/spec.py`` against the JAX package's: the
  same ``DraftTree`` arrays, ``NgramIndex.propose`` results and
  ``SpecController.plan`` sequence on seeded streams.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.attention import tree_attention as jax_tree_attention
from gofr_tpu.ops.paged_attention import (paged_tree_attention_pallas,
                                          paged_tree_attention_xla)
from gofr_tpu.ops.paged_kv import pool_move_rows as jax_pool_move_rows
from gofr_tpu.serving import spec as jspec
from gofr_tpu_torch.ops.attention import tree_attention
from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention_plain,
                                                paged_tree_attention,
                                                paged_tree_attention_plain)
from gofr_tpu_torch.ops.paged_kv import pool_move_rows
from gofr_tpu_torch.serving import spec as tspec

torch.set_num_threads(2)

ATOL = RTOL = 2e-5


def _trees(rng, branches, depth=4):
    """Four draft trees from seeded chains: continuations sharing a
    first token (so the trie merges them) for the first, disjoint ones
    for the rest."""
    trees = []
    for t in range(4):
        chains = [list(rng.integers(0, 50, size=depth))
                  for _ in range(branches)]
        if t == 0 and branches > 1:
            for c in chains[1:]:
                c[0] = chains[0][0]
        trees.append(tspec.build_draft_tree(int(rng.integers(0, 50)), chains))
    return trees


def _tree_case(seed, *, branches=2, hq=4, hkv=2, hd=16, page=8,
               hists=(0, 11, 16, 0)):
    """q, pools, tables, history/chunk lengths and tree masks for four
    slots: a fresh tree, a tree after a mid-page history, a topological
    prefix of a tree (two nodes short) after a page-aligned history, and
    a zero-length slot. Numpy arrays; the width is the pow-2 bucket of
    the widest tree, as the engine pads it."""
    rng = np.random.default_rng(seed)
    trees = _trees(rng, branches)
    width = 2
    while width < max(t.n_nodes for t in trees):
        width *= 2
    clens = [trees[0].n_nodes, trees[1].n_nodes,
             max(1, trees[2].n_nodes - 2), 0]
    b = len(hists)
    masks = np.ones((b, width), np.int32)
    for i, t in enumerate(trees):
        masks[i, :t.n_nodes] = t.masks
    n_pages = 4 * (-(-(max(hists) + width) // page)) + 4
    max_pages = -(-(max(hists) + width) // page) + 1
    q = rng.standard_normal((b, width, hq, hd)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_pages, page, hd)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_pages, page, hd)).astype(np.float32)
    tables = np.full((b, max_pages), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    used = 0
    for i, (h, c) in enumerate(zip(hists, clens)):
        need = -(-(h + c) // page)
        tables[i, :need] = perm[used:used + need]
        used += need
    return (q, kp, vp, tables, np.asarray(hists, np.int32),
            np.asarray(clens, np.int32), masks), trees


def _port(case):
    return paged_tree_attention(*(torch.from_numpy(a) for a in case))


def _jax(case):
    args = [jnp.asarray(a) for a in case]
    return (np.asarray(paged_tree_attention_pallas(*args, interpret=True)),
            np.asarray(paged_tree_attention_xla(*args)))


def _assert_matches(got, want, clens):
    got = got.numpy()
    live = np.arange(got.shape[1])[None, :] < np.asarray(clens)[:, None]
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=RTOL)
    assert not got[~live].any()        # padding rows and empty slots: zeros


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])   # GQA groups 1, 4
@pytest.mark.parametrize("branches", [1, 2, 4])
def test_tree_matches_pallas_interpret_and_xla(branches, hq, hkv, page):
    case, _ = _tree_case(branches * 10 + hq + page, branches=branches,
                         hq=hq, hkv=hkv, page=page)
    got = _port(case)
    pallas, xla = _jax(case)
    clens = case[5]
    _assert_matches(got, pallas, clens)
    _assert_matches(got, xla, clens)
    assert not got[3].any()            # the zero-length slot: exact zeros


def test_dense_tree_attention_matches_jax():
    # the dense function alone, on contiguous history + tree rows, with
    # a padding row that sees nothing (no history, chunk 0): zeros
    case, _ = _tree_case(5, branches=2, hists=(3, 9, 0, 0))
    q, kp, vp, tables, hist, clen, masks = case
    rng = np.random.default_rng(6)
    skv = 48
    k = rng.standard_normal((4, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((4, skv, 2, 16)).astype(np.float32)
    got = tree_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v),
                         history_lens=torch.from_numpy(hist),
                         chunk_lens=torch.from_numpy(clen),
                         tree_masks=torch.from_numpy(masks)).numpy()
    want = np.asarray(jax_tree_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        history_lens=jnp.asarray(hist), chunk_lens=jnp.asarray(clen),
        tree_masks=jnp.asarray(masks)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert not got[3].any()


def test_chain_tree_is_the_chunk_attention():
    # a chain's ancestor masks are the causal prefix: row i sees 0..i
    case, _ = _tree_case(7, branches=1, hists=(0, 13, 16, 5))
    q, kp, vp, tables, hist, clen, _ = case
    chain = np.cumsum(1 << np.arange(q.shape[1]), dtype=np.int64)
    masks = np.broadcast_to(chain.astype(np.int32), clen.shape + chain.shape)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (q, kp, vp, tables, hist, clen)]
    tree = paged_tree_attention_plain(*args, torch.from_numpy(masks.copy()))
    chunk = paged_chunk_attention_plain(*args)
    torch.testing.assert_close(tree, chunk, atol=0, rtol=0)


def test_sibling_poison_leaves_other_nodes_unchanged():
    # overwrite the pool rows of the root's last child and its
    # descendants with large finite values: every node that does not
    # descend from it must come back bit for bit the same
    case, trees = _tree_case(8, branches=4, hists=(0, 11, 16, 0))
    q, kp, vp, tables, hist, clen, masks = case
    page = kp.shape[2]
    clean = _port(case).numpy()
    kp2, vp2 = kp.copy(), vp.copy()
    poisoned = []
    for b in range(3):
        tree = trees[b]
        fork = max(j for j in range(1, clen[b]) if tree.parents[j] == 0)
        sub = [j for j in range(clen[b]) if (tree.masks[j] >> fork) & 1]
        for j in sub:
            pos = hist[b] + j
            pid = tables[b, pos // page]
            kp2[:, pid, pos % page] = 3e4
            vp2[:, pid, pos % page] = -3e4
        poisoned.append(set(sub))
    dirty = _port((q, kp2, vp2, tables, hist, clen, masks)).numpy()
    for b in range(3):
        keep = [i for i in range(clen[b]) if i not in poisoned[b]]
        assert poisoned[b] and keep
        np.testing.assert_array_equal(dirty[b, keep], clean[b, keep])
        # and the poisoned branch did move
        assert not np.array_equal(dirty[b, sorted(poisoned[b])],
                                  clean[b, sorted(poisoned[b])])


def test_pool_move_rows_matches_jax():
    # two slots of 3 pages of 4 rows; slot 0 moves rows 5, 7, 8 to 4, 5,
    # 6 (sources and destinations overlap: all reads precede writes),
    # slot 1 moves 2 rows and drops the rest (dst past its table, and
    # the engine's max_seq sentinel), reading a clamped source for them
    rng = np.random.default_rng(9)
    pool = rng.standard_normal((2, 2, 8, 4, 3)).astype(np.float32)
    tables = np.array([[3, 6, 1], [0, 5, 8]], np.int32)   # 8 = OOB id
    src = np.array([[4, 5, 7, 8], [9, 10, 3, 40]], np.int32)
    dst = np.array([[4, 5, 6, 7], [1, 9, 12, 12]], np.int32)
    want = np.asarray(jax_pool_move_rows(jnp.asarray(pool),
                                         jnp.asarray(tables),
                                         jnp.asarray(src), jnp.asarray(dst)))
    got = pool_move_rows(torch.from_numpy(pool.copy()),
                         torch.from_numpy(tables), torch.from_numpy(src).long(),
                         torch.from_numpy(dst).long())
    np.testing.assert_array_equal(got.numpy(), want)
    # slot 0's old row 8 is now at logical 7 (page 6, row 3)
    np.testing.assert_array_equal(got.numpy()[:, :, 6, 3], pool[:, :, 1, 0])


def _tree_arrays(tree):
    return (tree.tokens, tree.parents, tree.depths, tree.masks)


def test_spec_copy_matches_jax_spec():
    rng = np.random.default_rng(10)
    for _ in range(20):
        n_chains = int(rng.integers(1, 5))
        chains = [list(rng.integers(0, 4, size=int(rng.integers(1, 6))))
                  for _ in range(n_chains)]
        root = int(rng.integers(0, 4))
        cap = int(rng.integers(2, 33))
        assert _tree_arrays(tspec.build_draft_tree(root, chains, cap)) == \
            _tree_arrays(jspec.build_draft_tree(root, chains, cap))
    # the n-gram index, extended in seeded bursts over a small alphabet
    for n in (1, 2, 3):
        ti, ji = tspec.NgramIndex(n), jspec.NgramIndex(n)
        for _ in range(30):
            burst = rng.integers(0, 5, size=int(rng.integers(1, 4))).tolist()
            ti.extend(burst)
            ji.extend(burst)
            depth, branches = int(rng.integers(0, 5)), int(rng.integers(0, 4))
            assert ti.propose(depth, branches) == ji.propose(depth, branches)
    # the controller: the same seeded measurements give the same plans
    kw = dict(draft=4, branches=2, accept_floor=0.3, probe_interval=3)
    tc, jc = tspec.SpecController(2, **kw), jspec.SpecController(2, **kw)
    plans = []
    for step in range(60):
        slot = step % 2
        busy = float(rng.uniform(0.01, 0.02))
        verify = float(rng.uniform(0.001, 0.01))
        drafted = int(rng.integers(1, 5))
        accepted = int(rng.integers(0, drafted + 1)) if step < 30 else 0
        for ctrl in (tc, jc):
            ctrl.note_decode(busy, 8)
            ctrl.note_verify(verify, 2, 16)
            ctrl.note_result(slot, drafted, accepted)
        plans.append((tc.plan(slot), jc.plan(slot)))
        if step == 40:
            tc.reset_slot(1)
            jc.reset_slot(1)
    assert all(a == b for a, b in plans)
    assert tc.state() == jc.state()
    assert {p for p, _ in plans} >= {(0, 0), (1, 1)}   # disabled, probed
