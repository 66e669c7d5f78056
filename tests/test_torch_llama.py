"""Parity of the port's Llama with the JAX package on the tiny config
(float32, 2 layers, head_dim 16), on the CPU.

The JAX weights (``llama_init(jax.random.key(0), tiny)``) go through
``params_from_jax``; prefill logits and 8 chained paged decode steps
must agree within atol 1e-4 (float32, a few ulps of the ~1e0 logits
after two layers of differently ordered sums), and the greedy token
sequences must be identical. The JAX side runs its plain paths here;
the Pallas kernels are held against them in test_torch_ops.py and
test_torch_paged_chunk.py. The paged chunk step is held against JAX's
with its chunk kernel interpreted (logits and both pools), and a
two-chunk walk against the whole-prompt prefill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gofr_tpu.models import llama as jllama
from gofr_tpu.ops.paged_kv import scatter_chunk as jscatter
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.ops.paged_kv import scatter_chunk as tscatter

torch.set_num_threads(2)

ATOL = 1e-4


def _converted():
    jc = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.key(0), jc)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              tllama.LlamaConfig.tiny(), "cpu")
    return jc, jparams, tllama.LlamaConfig.tiny(), tparams


def test_params_from_jax_keeps_layout():
    jc, jparams, tc, tparams = _converted()
    assert tparams["layers"]["wq"].shape == (2, 64, 64)
    assert tparams["layers"]["w2"].shape == (2, 128, 64)
    np.testing.assert_array_equal(tparams["embed"].numpy(),
                                  np.asarray(jparams["embed"]))


def test_prefill_and_paged_decode_match_jax():
    jc, jparams, tc, tparams = _converted()
    rng = np.random.default_rng(0)
    b, s, pg, n_pages = 3, 24, 8, 20
    lens = np.array([24, 9, 1], np.int32)
    tokens = rng.integers(0, 256, size=(b, s)).astype(np.int32)

    jl, (jk, jv) = jllama.llama_prefill_last(
        jparams, jnp.asarray(tokens), jc, kv_lengths=jnp.asarray(lens),
        implementation="xla")
    tl, (tk, tv) = tllama.llama_prefill_last(
        tparams, torch.from_numpy(tokens), tc,
        kv_lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)

    # tables: row 0 owns 5 pages, rows 1 and 2 two each; the rest OOB.
    # 8 steps take row 1 from 9 to 17 rows, past its second page into
    # unallocated space (writes dropped on both sides).
    mp = 5
    tables = np.full((b, mp), n_pages, np.int32)
    pages = rng.permutation(n_pages)
    tables[0, :5], tables[1, :2], tables[2, :2] = pages[:5], pages[5:7], \
        pages[7:9]
    jkp = jnp.zeros((2, 2, n_pages, pg, 16), jnp.float32)
    jvp = jnp.zeros_like(jkp)
    zeros = jnp.zeros(b, jnp.int32)
    jkp = jscatter(jkp, jnp.asarray(tables), jk, zeros, jnp.asarray(lens))
    jvp = jscatter(jvp, jnp.asarray(tables), jv, zeros, jnp.asarray(lens))
    tkp, tvp = tllama.make_pool(tc, n_pages, pg, "cpu")
    tz = torch.zeros(b, dtype=torch.int32)
    tt, tlens = torch.from_numpy(tables), torch.from_numpy(lens)
    tscatter(tkp, tt, tk, tz, tlens)
    tscatter(tvp, tt, tv, tz, tlens)

    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = tl.argmax(-1)
    jlen, tlen = jnp.asarray(lens), tlens.clone()
    jseq, tseq = [np.asarray(jtok).tolist()], [ttok.tolist()]
    for _ in range(8):
        jl, jkp, jvp = jllama.llama_decode_step_paged(
            jparams, jtok, jkp, jvp, jnp.asarray(tables), jlen, jc,
            implementation="xla")
        tl, tkp, tvp = tllama.llama_decode_step_paged(
            tparams, ttok, tkp, tvp, tt, tlen, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(-1)
        jlen, tlen = jlen + 1, tlen + 1
        jseq.append(np.asarray(jtok).tolist())
        tseq.append(ttok.tolist())
    assert tseq == jseq
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), atol=ATOL)


def _history_pools(rng, n_layers, hkv, n_pages, pg, hd):
    """Random pools: rows the chunk does not write stand for history."""
    kp = rng.standard_normal((n_layers, hkv, n_pages, pg, hd)).astype(
        np.float32)
    vp = rng.standard_normal((n_layers, hkv, n_pages, pg, hd)).astype(
        np.float32)
    return kp, vp


def test_prefill_chunk_paged_matches_jax_interpret():
    # row 0: a fresh 12-token chunk; row 1: 9 tokens after a 21-row
    # (mid-page) history; row 2: a pad row (offset 0, length 0, all-OOB
    # table) whose writes must drop
    jc, jparams, tc, tparams = _converted()
    rng = np.random.default_rng(1)
    pg, n_pages, mp, s = 8, 16, 5, 12
    kp, vp = _history_pools(rng, 2, 2, n_pages, pg, 16)
    tables = np.full((3, mp), n_pages, np.int32)
    pages = rng.permutation(n_pages)
    tables[0, :2], tables[1, :4] = pages[:2], pages[2:6]
    offsets = np.array([0, 21, 0], np.int32)
    lens = np.array([12, 9, 0], np.int32)
    tokens = rng.integers(0, 256, size=(3, s)).astype(np.int32)

    jl, jkp, jvp = jllama.llama_prefill_chunk_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(offsets), jnp.asarray(lens), jc,
        implementation="interpret")
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tkp, tvp = tllama.llama_prefill_chunk_paged(
        tparams, torch.from_numpy(tokens).long(), tkp, tvp,
        torch.from_numpy(tables), torch.from_numpy(offsets),
        torch.from_numpy(lens), tc)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=ATOL)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), atol=ATOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), atol=ATOL)
    # the chunk's rows landed; nothing else moved
    written = tkp.numpy() != kp
    assert written.any(axis=(0, 1, 4)).sum() == 12 + 9


def test_two_chunk_walk_equals_whole_prompt_prefill():
    jc, jparams, tc, tparams = _converted()
    rng = np.random.default_rng(2)
    n, first, pg = 40, 24, 8
    prompt = torch.from_numpy(rng.integers(0, 256, size=(1, n))).long()
    want, (k, _) = tllama.llama_prefill_last(
        tparams, prompt, tc, kv_lengths=torch.tensor([n], dtype=torch.int32))
    kp, vp = tllama.make_pool(tc, 6, pg, "cpu")
    tables = torch.tensor([[3, 0, 5, 1, 4]], dtype=torch.int32)
    for off, width in ((0, first), (first, n - first)):
        got, kp, vp = tllama.llama_prefill_chunk_paged(
            tparams, prompt[:, off:off + width], kp, vp, tables,
            torch.tensor([off], dtype=torch.int32),
            torch.tensor([width], dtype=torch.int32), tc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    # the walk left the whole prompt's K in the slot's pages
    view = kp[:, :, tables[0].long()].permute(0, 2, 3, 1, 4).reshape(
        2, 5 * pg, 2, 16)[:, :n]
    np.testing.assert_allclose(view.numpy(), k[:, 0].numpy(), atol=ATOL)


def test_prefill_chunk_paged_tree_mode_matches_jax_interpret():
    # speculative verify: row 0 verifies a 2-branch tree after a
    # mid-page 21-row history, row 1 a chain after 8 rows, row 2 a lone
    # root at position 0 (a slot that did not draft); width 8, all
    # logits returned, tree kernel interpreted on the JAX side
    from gofr_tpu_torch.serving.spec import build_draft_tree
    jc, jparams, tc, tparams = _converted()
    rng = np.random.default_rng(3)
    pg, n_pages, mp, s = 8, 16, 5, 8
    kp, vp = _history_pools(rng, 2, 2, n_pages, pg, 16)
    trees = [build_draft_tree(5, [[1, 2, 3], [1, 7, 8, 9]]),
             build_draft_tree(6, [[4, 4, 4, 4]]),
             build_draft_tree(9, [])]
    tables = np.full((3, mp), n_pages, np.int32)
    pages = rng.permutation(n_pages)
    tables[0, :4], tables[1, :2], tables[2, :1] = pages[:4], pages[4:6], \
        pages[6:7]
    offsets = np.array([21, 8, 0], np.int32)
    lens = np.array([t.n_nodes for t in trees], np.int32)
    tokens = np.zeros((3, s), np.int32)
    depths = np.zeros((3, s), np.int32)
    masks = np.ones((3, s), np.int32)
    for i, t in enumerate(trees):
        tokens[i, :t.n_nodes] = t.tokens
        depths[i, :t.n_nodes] = t.depths
        masks[i, :t.n_nodes] = t.masks

    jl, jkp, jvp = jllama.llama_prefill_chunk_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(offsets), jnp.asarray(lens), jc,
        implementation="interpret", return_all_logits=True,
        tree_depths=jnp.asarray(depths), tree_masks=jnp.asarray(masks))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tkp, tvp = tllama.llama_prefill_chunk_paged(
        tparams, torch.from_numpy(tokens).long(), tkp, tvp,
        torch.from_numpy(tables), torch.from_numpy(offsets),
        torch.from_numpy(lens), tc, return_all_logits=True,
        tree_depths=torch.from_numpy(depths), tree_masks=torch.from_numpy(masks))
    assert tl.shape == (3, s, 256)
    live = np.arange(s)[None, :] < lens[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), atol=ATOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), atol=ATOL)
    # one K/V row per node landed at offsets + node index; nothing else
    written = tkp.numpy() != kp
    assert written.any(axis=(0, 1, 4)).sum() == lens.sum()
    # a chain in tree mode is the chunk step
    chain = slice(1, 2)
    cl, _, _ = tllama.llama_prefill_chunk_paged(
        tparams, torch.from_numpy(tokens[chain]).long(),
        torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
        torch.from_numpy(tables[chain]), torch.from_numpy(offsets[chain]),
        torch.from_numpy(lens[chain]), tc, return_all_logits=True)
    np.testing.assert_allclose(cl.numpy()[0, :5], tl.numpy()[1, :5],
                               atol=ATOL)
