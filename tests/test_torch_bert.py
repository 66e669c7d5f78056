"""The port's BERT encoder (``gofr_tpu_torch/models/bert.py``) against the
JAX package's at ``BertConfig.tiny()`` in float32, on the CPU: weights
carried across by ``bert_params_from_jax``, token ids drawn with numpy,
some past the vocabulary (JAX's gather clamps them; so does the port).

Tolerance: 1e-5 absolute on hidden states, pooled outputs and
embeddings (float32 on both sides; the two differ by summation order,
measured ≤ 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import bert as jbert
from gofr_tpu_torch.models import bert as tbert
from gofr_tpu_torch.models.convert import bert_params_from_jax
from gofr_tpu_torch.ops import attention as tattn

from .torch_parity import HostTensors

torch.set_num_threads(2)

ATOL = 1e-5
JCFG = jbert.BertConfig.tiny()
TCFG = tbert.BertConfig.tiny()
JPARAMS = jbert.bert_init(jax.random.key(0), JCFG)
TPARAMS = bert_params_from_jax(jax.tree.map(np.asarray, JPARAMS), TCFG, "cpu")


def _inputs(seed, b=3, s=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 2 * JCFG.vocab_size, (b, s)).astype(np.int32)
    lengths = rng.integers(1, s + 1, b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    types = rng.integers(0, JCFG.type_vocab, (b, s)).astype(np.int32)
    return tokens, mask, types


def test_the_tiny_config_matches_the_reference():
    assert TCFG.vocab_size == JCFG.vocab_size and TCFG.dim == JCFG.dim
    assert TCFG.n_layers == JCFG.n_layers and TCFG.head_dim == JCFG.head_dim
    assert TCFG.norm_eps == JCFG.norm_eps == 1e-12
    base = tbert.BertConfig.base()
    assert (base.dim, base.n_layers, base.n_heads, base.ffn_dim,
            base.vocab_size) == (768, 12, 12, 3072, 30522)
    assert base.dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_types", [False, True])
def test_bert_encode_matches_jax(seed, with_types):
    tokens, mask, types = _inputs(seed)
    kw_j = {"token_types": jnp.asarray(types)} if with_types else {}
    kw_t = {"token_types": torch.from_numpy(types)} if with_types else {}
    hidden, pooled = jbert.bert_encode(JPARAMS, jnp.asarray(tokens), JCFG,
                                       attention_mask=jnp.asarray(mask),
                                       **kw_j)
    t_hidden, t_pooled = tbert.bert_encode(
        TPARAMS, torch.from_numpy(tokens), TCFG,
        attention_mask=torch.from_numpy(mask), **kw_t)
    assert t_hidden.shape == (3, 16, TCFG.dim) and t_pooled.shape == (3, 32)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(hidden),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(pooled),
                               atol=ATOL, rtol=0)
    emb = jbert.mean_pool_embed(hidden, jnp.asarray(mask))
    t_emb = tbert.mean_pool_embed(t_hidden, torch.from_numpy(mask))
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(emb), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(np.linalg.norm(t_emb.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_bert_encode_without_a_mask_matches_jax():
    tokens, _, _ = _inputs(5)
    hidden, pooled = jbert.bert_encode(JPARAMS, jnp.asarray(tokens), JCFG)
    t_hidden, t_pooled = tbert.bert_encode(TPARAMS, torch.from_numpy(tokens),
                                           TCFG)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(hidden),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(pooled),
                               atol=ATOL, rtol=0)


def test_the_mask_blocks_the_padding():
    # the counterpart of tests/test_models.py's padding test: tokens past
    # the mask change nothing at the valid positions
    tokens, _, _ = _inputs(3, b=1, s=8)
    mask = np.ones((1, 8), np.int32)
    hidden_a, _ = tbert.bert_encode(TPARAMS, torch.from_numpy(tokens), TCFG,
                                    attention_mask=torch.from_numpy(mask))
    padded = np.pad(tokens, ((0, 0), (0, 4)), constant_values=3)
    padded_mask = np.pad(mask, ((0, 0), (0, 4)))
    hidden_b, _ = tbert.bert_encode(
        TPARAMS, torch.from_numpy(padded), TCFG,
        attention_mask=torch.from_numpy(padded_mask))
    np.testing.assert_allclose(hidden_b[:, :8].numpy(), hidden_a.numpy(),
                               atol=1e-6, rtol=0)
    # and a dropped mask does change them
    hidden_c, _ = tbert.bert_encode(TPARAMS, torch.from_numpy(padded), TCFG)
    assert np.abs(hidden_c[:, :8].numpy() - hidden_a.numpy()).max() > 1e-3


def test_the_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(
        tbert._gelu(x).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), atol=1e-6, rtol=0)
    assert (tbert._gelu(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_param_count_and_init():
    n_jax = sum(x.size for x in jax.tree.leaves(JPARAMS))
    assert tbert.param_count(TPARAMS) == n_jax
    gen = torch.Generator().manual_seed(0)
    own = tbert.bert_init(TCFG, gen, "cpu")
    assert tbert.param_count(own) == n_jax
    assert jax.tree.structure(jax.tree.map(lambda _: 0, JPARAMS)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, dict(own)))
    for key in ("wqkv", "w1", "w2"):
        assert own["layers"][key].shape == tuple(JPARAMS["layers"][key].shape)
    # N(0, 1/fan_in) matrices, as JAX draws them
    assert abs(float(own["layers"]["w2"].std()) * TCFG.ffn_dim ** 0.5
               - 1.0) < 0.1
    # BERT-base: the tree's count per layer and outside, at 768 wide
    one_layer = tbert.BertConfig(
        vocab_size=1, max_positions=1, type_vocab=1, n_layers=1, dim=768,
        n_heads=12, ffn_dim=3072, dtype=torch.float32)
    per_layer = tbert.param_count(
        tbert.bert_init(one_layer, gen, "cpu")["layers"])
    base = tbert.BertConfig.base()
    total = (per_layer * base.n_layers
             + (base.vocab_size + base.max_positions + base.type_vocab + 2)
             * base.dim + base.dim * base.dim + base.dim)
    assert 109e6 < total < 110e6


def test_the_encode_makes_no_tensor_from_host_data():
    tokens, mask, _ = _inputs(0)
    tokens, mask = torch.from_numpy(tokens), torch.from_numpy(mask)
    q, k = torch.randn(2, 3, 4, 8), torch.randn(2, 5, 2, 8)
    lengths, chunks = torch.tensor([3, 5]), torch.tensor([3, 3])
    masks = torch.tensor([[1, 3, 7]] * 2)
    with HostTensors() as host:
        tbert.bert_encode(TPARAMS, tokens, TCFG, attention_mask=mask)
        tattn.xla_attention(q, k, k, causal=True, kv_lengths=lengths)
        tattn.decode_attention(q[:, :1], k, k, lengths)
        tattn.tree_attention(q, k, k, history_lens=lengths - 3,
                             chunk_lens=chunks, tree_masks=masks)
    assert host.count == 0
