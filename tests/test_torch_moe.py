"""The port's MoE family and dense-view KV primitives against the JAX
package, on the CPU.

- ``top_k_routing`` (both weightings), ``moe_layer`` and
  ``load_balancing_loss`` against JAX's, float32, atol 1e-5. The router
  logits are seeded normals: no two of a row are equal, so
  ``torch.topk`` and ``lax.top_k`` (which breaks ties toward the lowest
  index) pick the same experts in the same order.
- ``moe_prefill``, ``moe_prefill_last`` and ``moe_decode_step`` (with
  and without ``attn_window``, and a write past the cache dropped) on
  ``MoEConfig.tiny()`` with the JAX weights through ``params_from_jax``:
  logits within 1e-4 (as ``test_torch_llama.py``), caches and router
  logits within 1e-5; ``moe_decode_flops`` against ``FlopCounterMode``.
- ``decode_attention(block=)``: a window of whole blocks gives the full
  cache's bits, and the blocked softmax is the one-shot one to float32
  rounding.
- ``gather_view``, ``scatter_prefill``, ``scatter_decode`` (and the K/V
  form ``scatter_decode_kv``) and ``pool_from_cache_shape`` on plain and
  int8 pools, bit for bit against JAX's, with out-of-range table ids,
  a slot at the view's end and one parked past it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gofr_tpu.models import moe as jmoe
from gofr_tpu.models.llama import make_empty_cache as jax_make_empty_cache
from gofr_tpu.ops import moe as jmoe_ops
from gofr_tpu.ops import paged_kv as jkv
from gofr_tpu_torch.models import moe as tmoe
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import make_empty_cache
from gofr_tpu_torch.ops import moe as tmoe_ops
from gofr_tpu_torch.ops import paged_kv as tkv
from gofr_tpu_torch.ops.attention import decode_attention

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("renormalize", [True, False])
def test_top_k_routing_matches_jax(renormalize):
    logits = np.random.default_rng(0).normal(size=(12, 8)).astype(np.float32)
    jw, ji = jmoe_ops.top_k_routing(jnp.asarray(logits), 2, renormalize)
    tw, ti = tmoe_ops.top_k_routing(_t(logits), 2, renormalize)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def _layer_inputs(seed, t=10, d=16, e=4, f=24):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * scale for s, scale in (
        ((t, d), 1.0), ((d, e), d ** -0.5), ((e, d, f), d ** -0.5),
        ((e, d, f), d ** -0.5), ((e, f, d), f ** -0.5))]


@pytest.mark.parametrize("num_selected", [1, 2, 3])
def test_moe_layer_matches_jax(num_selected):
    args = _layer_inputs(1)
    jout, jrouter = jmoe_ops.moe_layer(*map(jnp.asarray, args),
                                       num_selected=num_selected)
    tout, trouter = tmoe_ops.moe_layer(*map(_t, args),
                                       num_selected=num_selected)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(trouter.numpy(), np.asarray(jrouter),
                               atol=1e-5)


def test_moe_layer_combines_only_the_routed_experts():
    x, gate, w1, w3, w2 = map(_t, _layer_inputs(2))
    out, router = tmoe_ops.moe_layer(x, gate, w1, w3, w2, num_selected=2)
    weights, idx = tmoe_ops.top_k_routing(router, 2)
    want = torch.zeros_like(out)
    for t in range(x.shape[0]):
        for k in range(2):
            e = int(idx[t, k])
            h = torch.nn.functional.silu(x[t] @ w1[e]) * (x[t] @ w3[e])
            want[t] += weights[t, k] * (h @ w2[e])
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(7, 4), (40, 8)])
def test_load_balancing_loss_matches_jax(shape):
    logits = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = jmoe_ops.load_balancing_loss(jnp.asarray(logits), 2)
    got = tmoe_ops.load_balancing_loss(_t(logits), 2)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)


def _tied_router(case):
    """(x [4, 16], gate [16, 8]) whose router logits tie: "all" — a zero
    gate, every expert tied; "second" — expert 5 first, experts 2, 3 and
    6 tied for second (small integers times powers of two: every logit
    is exact, whatever the product's order of summation)."""
    rng = np.random.default_rng(0)
    if case == "all":
        return (rng.normal(size=(4, 16)).astype(np.float32),
                np.zeros((16, 8), np.float32))
    x = rng.integers(0, 4, size=(4, 16)).astype(np.float32)
    x[:, 0] = 1.0                        # every row's logits nonzero
    scale = np.array([0.125, 0.125, 0.5, 0.5, 0.125, 1.0, 0.5, 0.125],
                     np.float32)
    return x, np.ones((16, 1), np.float32) * scale[None, :]


@pytest.mark.parametrize("case,want", [("all", [0, 1]), ("second", [5, 2])])
def test_a_tied_router_breaks_ties_toward_the_lowest_expert(case, want):
    x, gate = _tied_router(case)
    rng = np.random.default_rng(0)
    d, f, e = 16, 32, 8
    w1, w3 = (rng.normal(size=(e, d, f)).astype(np.float32) * 0.1
              for _ in range(2))
    w2 = rng.normal(size=(e, f, d)).astype(np.float32) * 0.1
    args = (x, gate, w1, w3, w2)
    _, idx = tmoe_ops.top_k_routing(_t(x) @ _t(gate), 2)
    assert idx.tolist() == [want] * 4
    _, jidx = jmoe_ops.top_k_routing(jnp.asarray(x) @ jnp.asarray(gate), 2)
    assert np.asarray(jidx).tolist() == [want] * 4
    jout, _ = jmoe_ops.moe_layer(*map(jnp.asarray, args), num_selected=2)
    tout, _ = tmoe_ops.moe_layer(*map(_t, args), num_selected=2)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)


@pytest.mark.parametrize("case", ["all", "second"])
def test_load_balancing_loss_on_a_tied_router_matches_jax(case):
    x, gate = _tied_router(case)
    logits = x @ gate
    want = jmoe_ops.load_balancing_loss(jnp.asarray(logits), 2)
    got = tmoe_ops.load_balancing_loss(_t(logits), 2)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)


# ----------------------------------------------------------------- model
@pytest.fixture(scope="module")
def params():
    jparams = jmoe.moe_init(jax.random.key(0), jmoe.MoEConfig.tiny())
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    tmoe.MoEConfig.tiny(), "cpu")


def test_params_from_jax_keeps_the_moe_layout(params):
    jparams, tparams = params
    c = tmoe.MoEConfig.tiny()
    L, D, E, F = c.n_layers, c.dim, c.n_experts, c.ffn_dim
    shapes = {"gate": (L, D, E), "w1": (L, E, D, F), "w3": (L, E, D, F),
              "w2": (L, E, F, D)}
    for name, shape in shapes.items():
        assert tuple(tparams["layers"][name].shape) == shape
        np.testing.assert_array_equal(tparams["layers"][name].numpy(),
                                      np.asarray(jparams["layers"][name]))
    # a freshly drawn port tree has the same structure and shapes
    fresh = tmoe.moe_init(c, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in fresh["layers"].items()} == \
        {k: tuple(v.shape) for k, v in tparams["layers"].items()}
    assert set(fresh) == set(tparams)


def _prompt(b=2, s=16, seed=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(b, s)), np.array([16, 9], np.int32)


def test_moe_prefill_matches_jax(params):
    jparams, tparams = params
    tokens, lens = _prompt()
    jlogits, (jk, jv), jrouter = jmoe.moe_prefill(
        jparams, jnp.asarray(tokens), jmoe.MoEConfig.tiny(),
        kv_lengths=jnp.asarray(lens), implementation="xla")
    tlogits, (tk, tv), trouter = tmoe.moe_prefill(
        tparams, _t(tokens), tmoe.MoEConfig.tiny(), kv_lengths=_t(lens))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(trouter.numpy(), np.asarray(jrouter),
                               atol=1e-5)


def test_moe_prefill_last_matches_jax(params):
    jparams, tparams = params
    tokens, lens = _prompt()
    jlogits, _, _ = jmoe.moe_prefill_last(
        jparams, jnp.asarray(tokens), jmoe.MoEConfig.tiny(),
        kv_lengths=jnp.asarray(lens), implementation="xla")
    tlogits, _, _ = tmoe.moe_prefill_last(
        tparams, _t(tokens), tmoe.MoEConfig.tiny(), kv_lengths=_t(lens))
    assert tlogits.shape == (2, 256)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4)


@pytest.mark.parametrize("window", [None, 32, 64])
def test_moe_decode_step_matches_jax(params, window):
    jparams, tparams = params
    jc, tc = jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()
    tokens, lens = _prompt()
    logits, (k, v), _ = jmoe.moe_prefill(
        jparams, jnp.asarray(tokens), jc, kv_lengths=jnp.asarray(lens),
        implementation="xla")
    jk, jv = jax_make_empty_cache(jc, 2, max_seq=64)
    jk, jv = jk.at[:, :, :16].set(k), jv.at[:, :, :16].set(v)
    tk, tv = make_empty_cache(tc, 2, 64, "cpu")
    tk[:, :, :16] = _t(np.asarray(k))
    tv[:, :, :16] = _t(np.asarray(v))
    jlen, tlen = jnp.asarray(lens), _t(lens)
    step = np.asarray(jnp.argmax(logits[jnp.arange(2), jlen - 1], -1))
    for _ in range(3):
        jl, jk, jv = jmoe.moe_decode_step(jparams, jnp.asarray(step), jk, jv,
                                          jlen, jc, attn_window=window)
        tl, tk, tv = tmoe.moe_decode_step(tparams, _t(step), tk, tv, tlen,
                                          tc, attn_window=window)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        step = np.asarray(jnp.argmax(jl, -1))
        jlen, tlen = jlen + 1, tlen + 1


def test_moe_decode_step_drops_a_write_past_the_cache(params):
    jparams, tparams = params
    jc, tc = jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()
    rng = np.random.default_rng(5)
    cache = rng.normal(size=(2, 2, 8, 2, 16)).astype(np.float32)
    lens = np.array([8, 3], np.int32)      # row 0 sits at the ceiling
    tk, tv = _t(cache), _t(cache * 2)
    _, jk, jv = jmoe.moe_decode_step(jparams, jnp.array([1, 2]),
                                     jnp.asarray(cache),
                                     jnp.asarray(cache * 2),
                                     jnp.asarray(lens), jc)
    tmoe.moe_decode_step(tparams, torch.tensor([1, 2]), tk, tv, _t(lens), tc)
    np.testing.assert_array_equal(tk[:, 0].numpy(), cache[:, 0])
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_moe_decode_flops_formula_matches_the_flop_counter(params):
    # the step's products are plain torch ops, so the counter sees them
    c = tmoe.MoEConfig.tiny()
    _, tparams = params
    width = 64
    k, v = make_empty_cache(c, 3, width, "cpu")
    with FlopCounterMode(display=False) as counter:
        tmoe.moe_decode_step(tparams, torch.tensor([1, 2, 3]), k, v,
                             torch.tensor([3, 40, 60], dtype=torch.int32), c)
    assert counter.get_total_flops() == 3 * tmoe.moe_decode_flops(c, width)


# ------------------------------------------------------- blocked decode
def test_blocked_decode_attention_is_window_invariant():
    rng = np.random.default_rng(6)
    q = _t(rng.normal(size=(3, 1, 8, 16)).astype(np.float32))
    k = _t(rng.normal(size=(3, 64, 2, 16)).astype(np.float32))
    v = _t(rng.normal(size=(3, 64, 2, 16)).astype(np.float32))
    lens = torch.tensor([1, 17, 32], dtype=torch.int32)
    full = decode_attention(q, k, v, lens, block=16)
    for window in (32, 48):
        windowed = decode_attention(q, k[:, :window], v[:, :window], lens,
                                    block=16)
        assert torch.equal(windowed, full)
    torch.testing.assert_close(full, decode_attention(q, k, v, lens),
                               atol=1e-6, rtol=1e-5)


# ------------------------------------------------- dense-view primitives
L_, H_, NP_, PG_, D_ = 2, 2, 6, 4, 8


def _pools(seed):
    """A plain float32 pool and its quantized form, as numpy trees."""
    rng = np.random.default_rng(seed)
    plain = rng.normal(size=(L_, H_, NP_, PG_, D_)).astype(np.float32)
    quant = jax.tree.map(np.asarray, jkv.quantize_pool(jnp.asarray(plain)))
    return {"plain": plain, "int8": quant}


def _to_port(pool):
    return ({k: _t(v) for k, v in pool.items()} if isinstance(pool, dict)
            else _t(pool))


def _to_jax(pool):
    return ({k: jnp.asarray(v) for k, v in pool.items()}
            if isinstance(pool, dict) else jnp.asarray(pool))


def _assert_pools_equal(got, want):
    if isinstance(want, dict):
        for key in ("q", "s"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


#: three slots over 3-page tables: a full one, one with an unallocated
#: (out-of-range) page, one all out of range
TABLES = np.array([[4, 0, 2], [1, 5, NP_], [NP_, NP_, NP_]], np.int32)


@pytest.mark.parametrize("form", ["plain", "int8"])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_gather_view_matches_jax(form, dtype):
    pool = _pools(7)[form]
    jview = jkv.gather_view(_to_jax(pool), jnp.asarray(TABLES),
                            dtype=None if dtype is None else jnp.float32)
    tview = tkv.gather_view(_to_port(pool), _t(TABLES),
                            dtype=None if dtype is None else torch.float32)
    assert tuple(tview.shape) == (L_, 3, 3 * PG_, H_, D_)
    assert str(tview.dtype) == f"torch.{jview.dtype}"
    np.testing.assert_array_equal(_np(tview), _np(jview))


@pytest.mark.parametrize("form", ["plain", "int8"])
def test_scatter_prefill_matches_jax(form):
    pool = _pools(8)[form]
    slab = np.random.default_rng(9).normal(
        size=(L_, 3, 10, H_, D_)).astype(np.float32)
    want = jkv.scatter_prefill(_to_jax(pool), jnp.asarray(TABLES),
                               jnp.asarray(slab))
    got = tkv.scatter_prefill(_to_port(pool), _t(TABLES), _t(slab))
    _assert_pools_equal(got, want)


@pytest.mark.parametrize("form", ["plain", "int8"])
@pytest.mark.parametrize("lengths", [(0, 2, 5), (10, 6, 0), (12, 11, 3)])
def test_scatter_decode_matches_jax(form, lengths):
    # (10, ..): two of slot 0's three rows past the view drop; (12, ..):
    # slot 0 parked at the view's end writes nothing
    pool = _pools(10)[form]
    view = np.random.default_rng(11).normal(
        size=(L_, 3, 3 * PG_, H_, D_)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    want = jkv.scatter_decode(_to_jax(pool), jnp.asarray(TABLES),
                              jnp.asarray(view), jnp.asarray(lens), 3)
    got = tkv.scatter_decode(_to_port(pool), _t(TABLES), _t(view), _t(lens),
                             3)
    _assert_pools_equal(got, want)
    # the K/V form the engine writes back with: both pools, one call
    k_pool, v_pool = _to_port(pool), _to_port(_pools(12)[form])
    v_view = view * 3
    tkv.scatter_decode_kv(k_pool, v_pool, _t(TABLES), _t(view), _t(v_view),
                          _t(lens), 3)
    _assert_pools_equal(k_pool, want)
    _assert_pools_equal(v_pool, jkv.scatter_decode(
        _to_jax(_pools(12)[form]), jnp.asarray(TABLES), jnp.asarray(v_view),
        jnp.asarray(lens), 3))


def test_pool_from_cache_shape_matches_jax():
    cache = np.random.default_rng(13).normal(
        size=(L_, NP_, PG_, H_, D_)).astype(np.float32)
    got = tkv.pool_from_cache_shape(_t(cache))
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jkv.pool_from_cache_shape(
            jnp.asarray(cache))))
