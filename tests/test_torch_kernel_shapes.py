"""The attention and K/V-write kernels at every head dim and float type
the JAX package's kernels take, on the CPU.

The JAX kernels read the head dim from the shapes and compute in float32
whatever the input type; the port's take any head dim that is a multiple
of 4 from 16 to 256, in bf16, float16 or float32 (plain pools in the
model's dtype, int8 ``{q, s}`` pools dequantized to it). Here:

- the wrappers' checks (flash, paged decode / chunk / tree, the fused
  RoPE + K/V write, the prefill slab write) take D in {16, 80, 96, 100,
  256} in float16 and float32 and refuse D = 98 and D = 260 with a
  ``ValueError`` that names the rule, and the paged checks take any GQA
  group that divides Hq (32 and 48 among them, where the kernels cut the
  group into sub-groups of 16); the checks run on CPU tensors and launch
  nothing;
- the route each attention call takes (``_build.attention_route``) for
  every type, head dim and kernel, and the split count the paged
  wrappers launch with, ``kv_splits`` of their shapes in every type;
- each plain version (what a CPU tensor runs, and what the card's kernel
  is held against) against JAX's Pallas kernel in interpret mode, at
  (D 100, float16), (D 16, float32) and (D 256, bfloat16), both pool
  forms, on the same seeded numpy inputs, and the paged ones at GQA
  groups 32 and 48 (D 16 float32, D 64 bfloat16). Per element ``|port - jax| <=
  atol + rtol |jax|``: float16 atol 1e-3, rtol 2^-9 (each side rounds
  its output to float16, 2^-11 relative, and the JAX kernel rounds P
  to float16 before P·V); float32 atol 1e-5, rtol 0 (summation order);
  bf16 atol 1e-3, rtol 2^-7 (as ``chip_smoke.py``'s kernel rows: both
  outputs round to bf16, 2^-8 relative each side, and the JAX kernel's
  P rounds to bf16 too, up to 2^-8 of the average |V|, here < 3e-3);
- a reduced OpenLLaMA-3B v2 (2 layers, dim 400, 4 heads of 100, ffn
  1080, vocabulary 512, float16) served by the port's engine and by the
  JAX engine on the same weights (``params_from_jax``), paged, prefix
  cache on, a 16-row bucket so that prompts walk: the same greedy tokens
  and digests, and the same prefix hits;
- ``demo_config`` gives JAX's demo model on every device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.ops.flash_attention import flash_attention as jax_flash
from gofr_tpu.ops.paged_attention import (paged_chunk_attention_pallas,
                                          paged_decode_attention_pallas,
                                          paged_tree_attention_pallas)
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.ops import _build
from gofr_tpu_torch.ops import flash_attention as flash_mod
from gofr_tpu_torch.ops import paged_attention as paged_mod
from gofr_tpu_torch.ops import paged_kv
from gofr_tpu_torch.ops.flash_attention import flash_attention
from gofr_tpu_torch.ops.paged_attention import (kv_splits,
                                                paged_chunk_attention,
                                                paged_decode_attention,
                                                paged_tree_attention)
from gofr_tpu_torch.ops.paged_kv import quantize_pool
from gofr_tpu_torch.ops.rope import rope_frequencies
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import demo_config, llama_engine
from .torch_parity import assert_parity, serve_waves

torch.set_num_threads(2)

DTYPES = {"float16": torch.float16, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
JNP = {"float16": jnp.float16, "float32": jnp.float32,
       "bfloat16": jnp.bfloat16}
#: (atol, rtol) of the plain versions against JAX's kernels
TOLS = {"float16": (1e-3, 2.0 ** -9), "float32": (1e-5, 0.0),
        "bfloat16": (1e-3, 2.0 ** -7)}
TAKEN = [16, 80, 96, 100, 256]
REFUSED = [98, 260]


# ------------------------------------------------------ the wrappers' checks
def _check_all(d: int, dtype: torch.dtype) -> list:
    """Every wrapper's check on CPU tensors at head dim ``d``: the dtype
    codes they return (or the raise), nothing launched."""
    hq, hkv, n_pages, pg, b = 8, 2, 6, 16, 2
    q = torch.zeros(b, 8, hq, d, dtype=dtype)
    kv = torch.zeros(b, 8, hkv, d, dtype=dtype)
    q1, kv1 = q[:, 0].contiguous(), kv[:, 0].contiguous()
    lens = torch.full((b,), 8, dtype=torch.int32)
    codes = [flash_mod._check(q, kv, kv, lens)]
    pool = torch.zeros(hkv, n_pages, pg, d, dtype=dtype)
    tables = torch.zeros(b, 3, dtype=torch.int32)
    for pools in ((pool, pool), (quantize_pool(pool), quantize_pool(pool))):
        paged_mod._check("paged_decode_attention", q1, *pools, tables, lens)
        paged_mod._check("paged_chunk_attention", q, *pools, tables, lens,
                         lens)
        paged_mod._check("paged_tree_attention", q, *pools, tables, lens,
                         lens)
    layers = torch.zeros(2, hkv, n_pages, pg, d, dtype=dtype)
    ids = torch.zeros(b, dtype=torch.int32)
    for k_pool in (layers, quantize_pool(layers)):
        _, _, ints = paged_kv._rope_args(q1, kv1, kv1, ids,
                                         rope_frequencies(d), k_pool, k_pool,
                                         1, ids, ids)
        codes.append(ints[-1])
        slab = torch.zeros(2, b, 8, hkv, d, dtype=dtype)
        _, _, ints = paged_kv._slab_args(k_pool, k_pool, tables, slab, slab,
                                         ids, ids)
        codes.append(ints[-1])
    return codes


@pytest.mark.parametrize("dtype", ["float16", "float32"])
@pytest.mark.parametrize("d", TAKEN)
def test_wrapper_checks_take_every_head_dim_and_type(d, dtype):
    code = {"float16": 1, "float32": 2}[dtype]
    assert _check_all(d, DTYPES[dtype]) == [code] * 5


@pytest.mark.parametrize("d", REFUSED)
def test_wrapper_checks_refuse_other_head_dims(d):
    hq, hkv, pg = 4, 2, 16
    q = torch.zeros(1, 8, hq, d, dtype=torch.float16)
    kv = torch.zeros(1, 8, hkv, d, dtype=torch.float16)
    q1, kv1 = q[:, 0].contiguous(), kv[:, 0].contiguous()
    lens = torch.full((1,), 8, dtype=torch.int32)
    pool = torch.zeros(hkv, 4, pg, d, dtype=torch.float16)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    layers = torch.zeros(2, hkv, 4, pg, d, dtype=torch.float16)
    ids = torch.zeros(1, dtype=torch.int32)
    slab = torch.zeros(2, 1, 8, hkv, d, dtype=torch.float16)
    calls = [
        lambda: flash_mod._check(q, kv, kv, lens),
        lambda: paged_mod._check("paged_decode_attention", q1, pool, pool,
                                 tables, lens),
        lambda: paged_mod._check("paged_chunk_attention", q, pool, pool,
                                 tables, lens, lens),
        lambda: paged_mod._check("paged_tree_attention", q, pool, pool,
                                 tables, lens, lens),
        lambda: paged_kv._rope_args(q1, kv1, kv1, ids, torch.zeros(d // 2),
                                    layers, layers, 0, ids, ids),
        lambda: paged_kv._slab_args(layers, layers, tables, slab, slab, ids,
                                    ids)]
    for call in calls:
        with pytest.raises(ValueError, match="a multiple of 4 from 16 to 256"):
            call()


# (Hq, Hkv): GQA groups 32 and 48, above the 16 heads a block holds
WIDE_GROUPS = [(64, 2), (48, 1)]


@pytest.mark.parametrize("hq,hkv", WIDE_GROUPS + [(12, 8)],
                         ids=["g32", "g48", "g1.5"])
def test_paged_checks_take_any_group_that_divides(hq, hkv):
    d, pg, b = 64, 16, 2
    q = torch.zeros(b, 8, hq, d, dtype=torch.bfloat16)
    q1 = q[:, 0].contiguous()
    lens = torch.full((b,), 8, dtype=torch.int32)
    pool = torch.zeros(hkv, 6, pg, d, dtype=torch.bfloat16)
    tables = torch.zeros(b, 3, dtype=torch.int32)
    calls = [
        lambda pools: paged_mod._check("paged_decode_attention", q1, *pools,
                                       tables, lens),
        lambda pools: paged_mod._check("paged_chunk_attention", q, *pools,
                                       tables, lens, lens),
        lambda pools: paged_mod._check("paged_tree_attention", q, *pools,
                                       tables, lens, lens)]
    for pools in ((pool, pool), (quantize_pool(pool), quantize_pool(pool))):
        for call in calls:
            if hq % hkv:
                with pytest.raises(ValueError, match="group must divide"):
                    call(pools)
            else:   # (K, V), or codes and scales
                assert len(call(pools)) == (4 if isinstance(pools[0], dict)
                                            else 2)


# ------------------------------------------------------------- the routes
def _route_want(kernel: str, dtype: str) -> str:
    if kernel == "decode":
        return "split_kv"
    return "simt" if dtype == "float32" else "wgmma"


@pytest.mark.parametrize("kernel", _build.ATTENTION_KERNELS)
@pytest.mark.parametrize("d", TAKEN + [64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_route_of_every_type_head_dim_and_kernel(kernel, d, dtype):
    """Decode runs the split-KV kernel in every type; flash, chunk and
    tree run the wgmma kernels in bf16 and float16 and the float32 FMA
    kernel in float32, at every head dim (16-bit never reaches
    attn_simt.cuh)."""
    assert _build.attention_route(kernel, DTYPES[dtype], d) \
        == _route_want(kernel, dtype)


def test_attention_route_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="a multiple of 4 from 16 to 256"):
        _build.attention_route("decode", torch.float16, 98)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        _build.attention_route("flash", torch.float64, 64)
    with pytest.raises(ValueError, match="unknown kernel"):
        _build.attention_route("prefill", torch.float16, 64)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_wrappers_split_in_every_type(dtype):
    """The split count a launch takes is kv_splits of its shapes in every
    type (before, 1 off the bf16 64 / 128 route)."""
    for mode, b, sq, hq, hkv, mp, pg, d in (
            ("decode", 8, 1, 32, 32, 24, 64, 100),
            ("decode", 1, 1, 64, 2, 40, 16, 256),
            ("decode", 2, 1, 4, 2, 8, 64, 16),
            ("chunk", 4, 1024, 32, 32, 32, 64, 100),
            ("chunk", 1, 16, 48, 1, 32, 64, 64),
            ("tree", 8, 16, 8, 2, 32, 64, 256)):
        q = torch.zeros(b, sq, hq, d, dtype=DTYPES[dtype])
        got = paged_mod._splits(mode, q, b, sq, hq, hkv, mp, pg)
        assert got == kv_splits(mode, b, sq, hq, hkv, mp, pg, head_dim=d)
        # a one-slot decode walk and a one-slot tree verify do split
        if b == 1 and mode == "decode":
            assert got == 8


# ------------------------------------- the plain versions against JAX's kernels
SHAPES = [(100, "float16"), (16, "float32"), (256, "bfloat16")]
SHAPE_IDS = [f"d{d}-{t}" for d, t in SHAPES]


def _pair(x: np.ndarray, dtype: str):
    """The same values as a port tensor and a JAX array of ``dtype``
    (both round float32 to nearest even)."""
    return torch.from_numpy(x).to(DTYPES[dtype]), jnp.asarray(x, JNP[dtype])


def _pools(rng, shape, dtype: str, form: str):
    """A K or V pool in both packages: ``dtype``, or int8 codes and
    float32 scales quantized from it by the port (JAX's ``{q, s}`` keys)."""
    t, j = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    if form == "plain":
        return t, j
    qp = quantize_pool(t)
    return qp, {"q": jnp.asarray(qp["q"].numpy()),
                "s": jnp.asarray(qp["s"].numpy())}


def _assert_close(got: torch.Tensor, want, dtype: str, rows=None):
    assert got.dtype == DTYPES[dtype]
    atol, rtol = TOLS[dtype]
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _tables(rng, rows: list, pg: int, n_pages: int, mp: int) -> np.ndarray:
    """Distinct random pages covering each slot's rows, the rest of each
    table the out-of-range id."""
    t = np.full((len(rows), mp), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    used = 0
    for i, n in enumerate(rows):
        need = -(-n // pg)
        t[i, :need] = perm[used:used + need]
        used += need
    return t


def _tree_masks(rng, b: int, width: int) -> np.ndarray:
    """Ancestor masks of random trees: node i's parent is an earlier
    node, and its mask is the parent's with bit i set."""
    masks = np.zeros((b, width), np.int64)
    for s in range(b):
        masks[s, 0] = 1
        for i in range(1, width):
            masks[s, i] = masks[s, rng.integers(0, i)] | (1 << i)
    return masks.astype(np.int32)


@pytest.mark.parametrize("d,dtype", SHAPES, ids=SHAPE_IDS)
def test_flash_plain_matches_jax_pallas_interpret(d, dtype):
    rng = np.random.default_rng(d)
    b, s, hq, hkv = 2, 40, 4, 2
    q, jq = _pair(rng.standard_normal((b, s, hq, d)).astype(np.float32),
                  dtype)
    k, jk = _pair(rng.standard_normal((b, s, hkv, d)).astype(np.float32),
                  dtype)
    v, jv = _pair(rng.standard_normal((b, s, hkv, d)).astype(np.float32),
                  dtype)
    lens = np.asarray([40, 23], np.int32)
    got = flash_attention(q, k, v, kv_lengths=torch.from_numpy(lens))
    want = jax_flash(jq, jk, jv, kv_lengths=jnp.asarray(lens),
                     interpret=True)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("form", ["plain", "int8"])
@pytest.mark.parametrize("d,dtype", SHAPES, ids=SHAPE_IDS)
def test_paged_plain_versions_match_jax_pallas_interpret(d, dtype, form):
    """Decode, chunk and tree over one pair of pools: GQA group 2, 16-row
    pages, ragged lengths with a mid-page end, a zero-length slot."""
    rng = np.random.default_rng(d + 1)
    hq, hkv, pg, n_pages, mp = 4, 2, 16, 24, 6
    kp, jkp = _pools(rng, (hkv, n_pages, pg, d), dtype, form)
    vp, jvp = _pools(rng, (hkv, n_pages, pg, d), dtype, form)

    # decode
    lens = [37, 1, 0, 80]
    tables = _tables(rng, lens, pg, n_pages, mp)
    q, jq = _pair(rng.standard_normal((4, hq, d)).astype(np.float32), dtype)
    got = paged_decode_attention(q, kp, vp, torch.from_numpy(tables),
                                 torch.tensor(lens, dtype=torch.int32))
    want = paged_decode_attention_pallas(jq, jkp, jvp, jnp.asarray(tables),
                                         jnp.asarray(lens, jnp.int32),
                                         interpret=True)
    _assert_close(got, want, dtype, rows=np.asarray(lens) > 0)
    assert not got[2].float().abs().sum()

    # chunk: (history, chunk) = (20, 13), (0, 16), (33, 0)
    hists, clens, sq = [20, 0, 33], [13, 16, 0], 16
    tables = _tables(rng, [h + c for h, c in zip(hists, clens)], pg,
                     n_pages, mp)
    q, jq = _pair(rng.standard_normal((3, sq, hq, d)).astype(np.float32),
                  dtype)
    args = (torch.from_numpy(tables), torch.tensor(hists, dtype=torch.int32),
            torch.tensor(clens, dtype=torch.int32))
    jargs = (jnp.asarray(tables), jnp.asarray(hists, jnp.int32),
             jnp.asarray(clens, jnp.int32))
    got = paged_chunk_attention(q, kp, vp, *args)
    want = paged_chunk_attention_pallas(jq, jkp, jvp, *jargs, interpret=True)
    live = np.arange(sq)[None, :] < np.asarray(clens)[:, None]
    _assert_close(got, want, dtype, rows=live)
    assert not got[torch.from_numpy(~live)].float().abs().sum()

    # tree: 8 nodes after histories of 17 and 0 rows
    hists, width = [17, 0], 8
    tables = _tables(rng, [h + width for h in hists], pg, n_pages, mp)
    masks = _tree_masks(rng, 2, width)
    q, jq = _pair(rng.standard_normal((2, width, hq, d)).astype(np.float32),
                  dtype)
    clens = [width, width]
    got = paged_tree_attention(q, kp, vp, torch.from_numpy(tables),
                               torch.tensor(hists, dtype=torch.int32),
                               torch.tensor(clens, dtype=torch.int32),
                               torch.from_numpy(masks))
    want = paged_tree_attention_pallas(
        jq, jkp, jvp, jnp.asarray(tables), jnp.asarray(hists, jnp.int32),
        jnp.asarray(clens, jnp.int32), jnp.asarray(masks), interpret=True)
    _assert_close(got, want, dtype)


GROUP_SHAPES = [(16, "float32"), (64, "bfloat16")]


@pytest.mark.parametrize("form", ["plain", "int8"])
@pytest.mark.parametrize("d,dtype", GROUP_SHAPES,
                         ids=[f"d{d}-{t}" for d, t in GROUP_SHAPES])
@pytest.mark.parametrize("hq,hkv", WIDE_GROUPS, ids=["g32", "g48"])
def test_paged_plain_versions_at_wide_groups_match_jax_pallas_interpret(
        hq, hkv, d, dtype, form):
    """Decode, chunk and tree at GQA groups 32 and 48 (the kernels cut
    them into sub-groups of 16 heads; JAX's kernels pad the group): a
    mid-page end, a zero-length slot, a tree over a history."""
    rng = np.random.default_rng(hq + d)
    pg, n_pages, mp = 16, 12, 4
    kp, jkp = _pools(rng, (hkv, n_pages, pg, d), dtype, form)
    vp, jvp = _pools(rng, (hkv, n_pages, pg, d), dtype, form)

    lens = [21, 0]
    tables = _tables(rng, lens, pg, n_pages, mp)
    q, jq = _pair(rng.standard_normal((2, hq, d)).astype(np.float32), dtype)
    got = paged_decode_attention(q, kp, vp, torch.from_numpy(tables),
                                 torch.tensor(lens, dtype=torch.int32))
    want = paged_decode_attention_pallas(jq, jkp, jvp, jnp.asarray(tables),
                                         jnp.asarray(lens, jnp.int32),
                                         interpret=True)
    _assert_close(got, want, dtype, rows=np.asarray(lens) > 0)
    assert not got[1].float().abs().sum()

    hists, clens, sq = [9, 0], [5, 0], 6
    tables = _tables(rng, [h + c for h, c in zip(hists, clens)], pg,
                     n_pages, mp)
    q, jq = _pair(rng.standard_normal((2, sq, hq, d)).astype(np.float32),
                  dtype)
    args = (torch.from_numpy(tables), torch.tensor(hists, dtype=torch.int32),
            torch.tensor(clens, dtype=torch.int32))
    jargs = (jnp.asarray(tables), jnp.asarray(hists, jnp.int32),
             jnp.asarray(clens, jnp.int32))
    got = paged_chunk_attention(q, kp, vp, *args)
    want = paged_chunk_attention_pallas(jq, jkp, jvp, *jargs, interpret=True)
    live = np.arange(sq)[None, :] < np.asarray(clens)[:, None]
    _assert_close(got, want, dtype, rows=live)
    assert not got[torch.from_numpy(~live)].float().abs().sum()

    hists, width = [13], 4
    tables = _tables(rng, [h + width for h in hists], pg, n_pages, mp)
    masks = _tree_masks(rng, 1, width)
    q, jq = _pair(rng.standard_normal((1, width, hq, d)).astype(np.float32),
                  dtype)
    got = paged_tree_attention(q, kp, vp, torch.from_numpy(tables),
                               torch.tensor(hists, dtype=torch.int32),
                               torch.tensor([width], dtype=torch.int32),
                               torch.from_numpy(masks))
    want = paged_tree_attention_pallas(
        jq, jkp, jvp, jnp.asarray(tables), jnp.asarray(hists, jnp.int32),
        jnp.asarray([width], jnp.int32), jnp.asarray(masks), interpret=True)
    _assert_close(got, want, dtype)


# --------------------------------------- a reduced OpenLLaMA-3B v2, float16
def _openllama(jax_side: bool):
    """OpenLLaMA-3B v2's shape cut to 2 layers of dim 400 (4 heads of
    100, MHA), ffn 1080, vocabulary 512, float16, rope_theta 10000 and
    norm eps 1e-6 as its config.json gives them."""
    kw = dict(vocab_size=512, dim=400, n_layers=2, n_heads=4, n_kv_heads=4,
              ffn_dim=1080, max_seq=128, rope_theta=10000.0, norm_eps=1e-6,
              tie_embeddings=False)
    if jax_side:
        return JaxLlamaConfig(dtype=jnp.float16, **kw)
    return LlamaConfig(dtype=torch.float16, **kw)


def test_reduced_openllama_engine_matches_jax_engine():
    jcfg, cfg = _openllama(True), _openllama(False)
    assert cfg.head_dim == 100
    jparams = jax_llama_init(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    assert tparams["layers"]["wq"].dtype == torch.float16
    rng = np.random.default_rng(30)
    first = [rng.integers(0, 512, size=n).tolist() for n in (5, 20, 40, 70)]
    tail = [rng.integers(0, 512, size=n).tolist() for n in (10, 12, 30)]
    # page-aligned shared prefixes of 16, 32 and 64 rows, and a new prompt
    second = [first[1][:16] + tail[0], first[2][:35] + tail[1],
              first[3][:66] + tail[2][:20], tail[2]]
    common = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
                  decode_steps_per_pass=4, prefill_batch=4,
                  prefill_buckets=(16,), prefix_cache=True)
    jeng = jax_llama_engine(
        jparams, jcfg,
        JaxEngineConfig(kv_layout="paged", paged_attention="interpret",
                        compile_cache_dir=None, **common),
        implementation="xla")
    teng = llama_engine(tparams, cfg, EngineConfig(**common), device="cpu")
    want = serve_waves(jeng, [first, second],
                       JaxSamplingParams(temperature=0.0, max_new_tokens=12),
                       timeout_s=600)
    got = serve_waves(teng, [first, second],
                      SamplingParams(temperature=0.0, max_new_tokens=12),
                      timeout_s=600)
    assert_parity(got, want, 12)
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 3
    assert teng.k_cache.dtype == torch.float16
    # the 70-token prompt walked in 16-row chunks on both
    assert teng.stats["prefill_calls"] >= 5


def test_demo_config_is_jax_demo_model_on_every_device():
    for device in ("cpu", "cuda"):
        assert demo_config(device) == LlamaConfig.tiny()
