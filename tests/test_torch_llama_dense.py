"""Parity of the port's dense Llama functions with the JAX package on the
tiny config (float32, 2 layers, head_dim 16), on the CPU.

The JAX weights (``llama_init(jax.random.key(0), tiny)``) go through
``params_from_jax``; inputs come from numpy with a seed. Held against
JAX within atol 1e-4 (float32, as ``test_torch_llama.py``):
``llama_prefill`` (every position's logits and the stacked K/V),
``llama_decode_step`` on dense caches — three chained steps, with a row
at the cache's end whose write drops, and with ``attn_window``, which
must equal the full step bit for bit —, ``llama_prefill_chunk`` plain
and in tree mode (trees of 1, 2 and 4 branches; logits and both caches),
``param_count`` of plain, int8 and int4 trees and of the 8B shape,
the presets, and
``layer_norm``; ``sample_tokens`` exactly: greedy with its lowest-index
tie rule, and sampled from JAX's own uniform draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jllama
from gofr_tpu.ops import norms as jnorms
from gofr_tpu.ops import quant as jquant
from gofr_tpu.ops import sampling as jsampling
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.ops import norms as tnorms
from gofr_tpu_torch.ops import sampling as tsampling
from gofr_tpu_torch.serving.spec import build_draft_tree

from .torch_parity import assert_close

torch.set_num_threads(2)

ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jc = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.key(0), jc)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              tllama.LlamaConfig.tiny(), "cpu")
    return jc, jparams, tllama.LlamaConfig.tiny(), tparams


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _history(rng, b, smax):
    """Dense caches [L, b, smax, Hkv, hd] of random history rows."""
    shape = (2, b, smax, 2, 16)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def test_presets_match_jax():
    for name in ("llama3_8b", "llama3_70b", "llama3_1b", "tiny"):
        j, t = getattr(jllama.LlamaConfig, name)(), \
            getattr(tllama.LlamaConfig, name)()
        for field in ("vocab_size", "dim", "n_layers", "n_heads",
                      "n_kv_heads", "ffn_dim", "max_seq", "rope_theta",
                      "norm_eps", "tie_embeddings"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert t.head_dim == j.head_dim
    assert tllama.LlamaConfig.llama3_8b().head_dim == 128


def test_llama_prefill_matches_jax(weights):
    jc, jparams, tc, tparams = weights
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(3, 20)).astype(np.int32)
    lens = np.array([20, 11, 1], np.int32)
    jl, (jk, jv) = jllama.llama_prefill(jparams, jnp.asarray(tokens), jc,
                                        kv_lengths=jnp.asarray(lens),
                                        implementation="xla")
    tl, (tk, tv) = tllama.llama_prefill(tparams, _t(tokens).long(), tc,
                                        kv_lengths=_t(lens))
    assert tl.shape == (3, 20, 256)
    live = np.arange(20)[None, :] < lens[:, None]
    assert_close(tl.numpy()[live], np.asarray(jl)[live], ATOL)
    assert_close(tk, jk, ATOL)
    assert_close(tv, jv, ATOL)


def test_llama_decode_step_matches_jax(weights):
    # three chained steps; row 2 sits at the cache's last row, so its
    # second and third writes drop on both sides
    jc, jparams, tc, tparams = weights
    rng = np.random.default_rng(1)
    b, smax = 3, 64
    kc, vc = _history(rng, b, smax)
    lens = np.array([5, 30, smax - 1], np.int32)
    tokens = rng.integers(0, 256, size=b).astype(np.int32)
    jk, jv, jt, jlen = jnp.asarray(kc), jnp.asarray(vc), \
        jnp.asarray(tokens), jnp.asarray(lens)
    tk, tv = _t(kc), _t(vc)
    tt, tlen = _t(tokens).long(), _t(lens)
    for _ in range(3):
        jl, jk, jv = jllama.llama_decode_step(jparams, jt, jk, jv, jlen, jc)
        tl, tk, tv = tllama.llama_decode_step(tparams, tt, tk, tv, tlen, tc)
        assert_close(tl, jl, ATOL)
        assert_close(tk, jk, ATOL)
        assert_close(tv, jv, ATOL)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1)
        assert tt.tolist() == np.asarray(jt).tolist()
        jlen, tlen = jlen + 1, tlen + 1


@pytest.mark.parametrize("window", [None, 256, 512])
def test_a_decode_window_gives_the_full_step_bit_for_bit(weights, window):
    # windows are multiples of the step's attention block: the rows past
    # them are masked, and a block of masked rows moves nothing
    _, _, tc, tparams = weights
    rng = np.random.default_rng(2)
    b, smax = 3, 768
    kc, vc = _history(rng, b, smax)
    lens = _t(np.array([3, 200, 255], np.int32))
    tokens = _t(rng.integers(0, 256, size=b)).long()
    full = tllama.llama_decode_step(tparams, tokens, _t(kc), _t(vc), lens,
                                    tc)
    got = tllama.llama_decode_step(tparams, tokens, _t(kc), _t(vc), lens,
                                   tc, attn_window=window)
    for g, f in zip(got, full):
        assert torch.equal(g, f)


def test_llama_prefill_chunk_matches_jax(weights):
    # row 0 continues a 13-row history with a full chunk, row 1 a short
    # chunk from 40 (padding rows drop), row 2 runs past the cache's end
    # (its rows at and past smax drop), row 3 is a pad row (length 0)
    jc, jparams, tc, tparams = weights
    rng = np.random.default_rng(3)
    b, s, smax = 4, 16, 64
    kc, vc = _history(rng, b, smax)
    tokens = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    offsets = np.array([13, 40, 56, 0], np.int32)
    lens = np.array([16, 5, 16, 0], np.int32)
    jl, jk, jv = jllama.llama_prefill_chunk(
        jparams, jnp.asarray(tokens), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(offsets), jnp.asarray(lens), jc, implementation="xla")
    tl, tk, tv = tllama.llama_prefill_chunk(
        tparams, _t(tokens).long(), _t(kc), _t(vc), _t(offsets), _t(lens),
        tc)
    assert_close(tl[:3], np.asarray(jl)[:3], ATOL)
    assert_close(tk, jk, ATOL)
    assert_close(tv, jv, ATOL)
    # the rows written: each live row's chunk, nothing past smax
    written = (tk.numpy() != kc).any(axis=(0, 3, 4))
    assert written.sum(axis=1).tolist() == [16, 5, 8, 0]


@pytest.mark.parametrize("branches", [1, 2, 4])
def test_llama_prefill_chunk_tree_mode_matches_jax(weights, branches):
    jc, jparams, tc, tparams = weights
    rng = np.random.default_rng(4 + branches)
    chains = [[int(x) for x in rng.integers(0, 256, size=3)]
              for _ in range(branches)]
    for i in range(1, branches):
        chains[i][0] = chains[0][0]          # a shared first draft token
    trees = [build_draft_tree(5, chains), build_draft_tree(6, chains[:1]),
             build_draft_tree(9, [])]
    b, s, smax = 3, 16, 64
    kc, vc = _history(rng, b, smax)
    offsets = np.array([21, 8, 0], np.int32)
    lens = np.array([t.n_nodes for t in trees], np.int32)
    tokens = np.zeros((b, s), np.int32)
    depths = np.zeros((b, s), np.int32)
    masks = np.ones((b, s), np.int32)
    for i, t in enumerate(trees):
        tokens[i, :t.n_nodes] = t.tokens
        depths[i, :t.n_nodes] = t.depths
        masks[i, :t.n_nodes] = t.masks
    jl, jk, jv = jllama.llama_prefill_chunk(
        jparams, jnp.asarray(tokens), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(offsets), jnp.asarray(lens), jc, implementation="xla",
        return_all_logits=True, tree_depths=jnp.asarray(depths),
        tree_masks=jnp.asarray(masks))
    tl, tk, tv = tllama.llama_prefill_chunk(
        tparams, _t(tokens).long(), _t(kc), _t(vc), _t(offsets), _t(lens),
        tc, return_all_logits=True, tree_depths=_t(depths),
        tree_masks=_t(masks))
    assert tl.shape == (b, s, 256)
    live = np.arange(s)[None, :] < lens[:, None]
    assert_close(tl.numpy()[live], np.asarray(jl)[live], ATOL)
    assert_close(tk, jk, ATOL)
    assert_close(tv, jv, ATOL)
    assert trees[0].n_nodes == 1 + 3 * branches - (branches - 1)


@pytest.mark.parametrize("form", ["plain", "int8", "int4"])
def test_param_count_matches_jax(form):
    jc = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.key(0), jc)
    if form == "int8":
        jparams = jquant.quantize_llama_int8(jparams)
    elif form == "int4":
        jparams = jquant.quantize_llama_int4(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              tllama.LlamaConfig.tiny(), "cpu")
    assert tllama.param_count(tparams) == jllama.param_count(jparams)


def test_param_count_of_the_8b_shape():
    # shapes only (JAX's eval_shape, meta tensors): 8.03 B parameters,
    # 16.06 GB in bf16
    c8 = jllama.LlamaConfig.llama3_8b()
    jshapes = jax.eval_shape(lambda key: jllama.llama_init(key, c8),
                             jax.random.key(0))
    meta = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"),
                        jshapes)
    assert tllama.param_count(meta) == jllama.param_count(jshapes) \
        == 8_030_261_248
    assert 2 * tllama.param_count(meta) == 16_060_522_496


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 7, 48)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype is np.float32
                else (jnp.bfloat16, torch.bfloat16))
    want = jnorms.layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(bias, jdt), eps=1e-5)
    got = tnorms.layer_norm(_t(x).to(tdt), _t(w).to(tdt), _t(bias).to(tdt),
                            eps=1e-5)
    assert got.dtype == tdt
    assert_close(got.float(), np.asarray(want.astype(jnp.float32)),
                 1e-5 if dtype is np.float32 else 1e-2)


def test_greedy_sample_tokens_breaks_ties_toward_the_lowest_index():
    logits = np.zeros((3, 10), np.float32)
    logits[0, [4, 7]] = 2.0
    logits[1] = -2.0
    logits[1, [1, 2, 9]] = -0.5
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(logits),
                                              jax.random.key(0),
                                              temperature=0.0))
    got = tsampling.sample_tokens(_t(logits), temperature=0.0)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist() == [4, 1, 0]


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.6), (0.9, 20, 0.8)])
def test_sample_tokens_matches_jax_with_shared_noise(temperature, top_k,
                                                     top_p):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    for seed in range(4):
        key = jax.random.key(seed)
        want = jsampling.sample_tokens(jnp.asarray(logits), key,
                                       temperature=temperature, top_k=top_k,
                                       top_p=top_p)
        noise = jax.random.uniform(key, logits.shape, minval=1e-20,
                                   maxval=1.0)
        got = tsampling.sample_tokens(_t(logits), temperature=temperature,
                                      top_k=top_k, top_p=top_p,
                                      uniform=_t(noise))
        assert got.tolist() == np.asarray(want).tolist()
