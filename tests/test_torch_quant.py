"""Weight-only quantization in the port (``gofr_tpu_torch/ops/quant.py``)
against the JAX package's (``gofr_tpu/ops/quant.py``), on the CPU.

- ``quantize_int8`` / ``quantize_int4`` give JAX's codes and scales bit
  for bit (float32 and bf16 weights, a zero row, the int4 +amax pin);
  int4 codes round-trip through the two-per-byte packing.
- ``qmatmul`` / ``qmatmul_t`` / ``qgather`` agree with JAX's: float32
  within atol 1e-5 (the same products summed in another order), the
  gather bit for bit (the same two exact operands and one rounding);
  ``qmatmul_t`` of the port's ``[N, K]`` leaf gives JAX's ``qmatmul`` of
  the ``[K, N]`` one, and ``qmatmul`` of a quantized leaf raises on a
  tensor that is not on the CPU.
- ``quantize_llama_*`` lays every quantized matrix out ``[N, K]``: the
  codes are JAX's transposed bit for bit (int4 packed along K), the
  scales JAX's transposed.
- ``quantized_bytes`` counts what JAX's counts, int4 at half a byte.
- ``params_from_jax`` carries JAX's quantized trees leaf for leaf as
  the port's own quantizer lays them out.
- The model functions on quantized trees (tied and untied heads) match
  JAX's within the tiny config's atol 1e-4, and the port's engine with
  ``quantize="int8"`` / ``"int4"`` gives the JAX engine's greedy tokens
  and ``request_digest`` (once with an int8 KV pool, once with
  speculation).

The wrapper's kernel (``csrc/wq_gemm.cu``) runs only on the card
(``tests/test_torch_cuda.py``); here ``wq_gemm`` takes its plain version
because the tensors lie on the CPU.
"""

import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jllama
from gofr_tpu.ops import quant as jq
from gofr_tpu.ops.paged_kv import quantize_pool as jquantize_pool
from gofr_tpu.ops.paged_kv import scatter_chunk as jscatter
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.integrity import request_digest
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.ops import quant as tq
from gofr_tpu_torch.ops.paged_kv import scatter_chunk as tscatter
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import kernel_rows, llama_engine

torch.set_num_threads(2)

ATOL = 1e-4
FORMS = ("int8", "int4")


def _weights(dtype):
    """Random [3, 10, 12] weights with a zero row and a zero column, as
    (jax array, torch tensor) holding the same values."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 10, 12)).astype(np.float32) * 0.3
    w[:, 3, :] = 0.0
    w[0, :, 5] = 0.0
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32)).copy())
    return jw, tw.to(torch.bfloat16 if dtype == jnp.bfloat16 else
                     torch.float32)


def _jax_codes(q) -> np.ndarray:
    return np.asarray(q).astype(np.int8)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_quantize_is_bit_equal_to_jax(form, dtype, axis):
    jw, tw = _weights(dtype)
    j = getattr(jq, f"quantize_{form}")(jw, axis=axis)
    t = getattr(tq, f"quantize_{form}")(tw, axis=axis)
    np.testing.assert_array_equal(tq.codes_of(t).numpy(), _jax_codes(j["q"]))
    assert t["s"].dtype == torch.float32
    np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))
    if form == "int4":
        assert t["q"].dtype == torch.uint8
        assert t["q"].shape[-1] * 2 == tw.shape[-1]


def test_int4_pins_plus_amax_to_seven_and_zero_rows_to_zero():
    # column 0 reaches +amax, column 1 -amax, columns 2-3 are zero
    w = np.array([[1.0, -1.0, 0.0, 0.0], [0.5, 0.0, 0.0, 0.0],
                  [0.25, 0.5, 0.0, 0.0], [-0.125, 0.0, 0.0, 0.0]],
                 np.float32)
    j = jq.quantize_int4(jnp.asarray(w), axis=0)
    t = tq.quantize_int4(torch.from_numpy(w), axis=0)
    codes = tq.codes_of(t).numpy()
    np.testing.assert_array_equal(codes, _jax_codes(j["q"]))
    assert codes[0, 0] == 7 and codes[0, 1] == -8
    assert (codes[:, 2] == 0).all()
    np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))
    assert t["s"][0, 2].item() == np.float32(1e-8) / np.float32(8.0)


def test_int4_packing_round_trips_every_code():
    codes = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)   # [3, 32]
    packed = tq.pack_int4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 16)
    # element 2c in the low nibble, 2c + 1 in the high one
    assert packed[0, 0].item() == ((-7 & 0xF) << 4) | (-8 & 0xF)
    torch.testing.assert_close(tq.unpack_int4(packed), codes, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


@pytest.mark.parametrize("form", FORMS)
def test_qmatmul_qmatmul_t_and_qgather_match_jax(form):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 48)).astype(np.float32) / 8   # [in, out]
    e = rng.standard_normal((40, 64)).astype(np.float32) / 50  # [V, D]
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    idx = rng.integers(0, 40, size=(2, 7))
    qj = getattr(jq, f"quantize_{form}")
    qt = getattr(tq, f"quantize_{form}")
    jw, je = qj(jnp.asarray(w), axis=0), qj(jnp.asarray(e), axis=1)
    tw, te = qt(torch.from_numpy(w), axis=0), qt(torch.from_numpy(e), axis=1)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(tq.qmatmul(tx, tw).numpy(),
                               np.asarray(jq.qmatmul(jnp.asarray(x), jw)),
                               atol=1e-5)
    head = tq.qmatmul_t(tx, te, out_dtype=torch.float32)
    assert head.dtype == torch.float32 and head.shape == (2, 5, 40)
    np.testing.assert_allclose(
        head.numpy(), np.asarray(jq.qmatmul_t(jnp.asarray(x), je,
                                              out_dtype=jnp.float32)),
        atol=1e-5)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tq.qgather(te, torch.from_numpy(idx), dtype)
        want = jq.qgather(je, jnp.asarray(idx), jdtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the port's [N, K] layout: x @ W^T gives JAX's x @ W
    tn = qt(torch.from_numpy(w.T.copy()), axis=1)
    np.testing.assert_allclose(tq.qmatmul_t(tx, tn).numpy(),
                               np.asarray(jq.qmatmul(jnp.asarray(x), jw)),
                               atol=1e-5)
    # the wrapper on CPU tensors is its plain version
    torch.testing.assert_close(
        tq.wq_gemm(tx.reshape(-1, 64), tn),
        tq.wq_gemm_plain(tx.reshape(-1, 64), tn), rtol=0, atol=0)


@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_qmatmul_of_a_quantized_leaf_raises_off_the_cpu(device):
    """A quantized [K, N] matrix off the CPU is a layout the port's trees
    do not hold: qmatmul names the [N, K] one and never dequantizes."""
    w = tq.quantize_int8(torch.randn(64, 48), axis=0)
    x = torch.empty(5, 64, dtype=torch.bfloat16, device="meta")
    if device == "cuda":   # a stand-in: only its device is read
        x = mock.Mock(device=torch.device("cuda", 0))
    with mock.patch.object(tq, "_scaled_product",
                           side_effect=AssertionError("dequantized")), \
            mock.patch.object(tq, "codes_of",
                              side_effect=AssertionError("dequantized")):
        with pytest.raises(ValueError, match=r"\[N, K\].*qmatmul_t"):
            tq.qmatmul(x, w)


@pytest.mark.parametrize("m,n,k,want", [
    (8, 2048, 2048, (1, 4)), (8, 512, 2048, (1, 8)), (8, 8192, 2048, (1, 1)),
    (8, 2048, 8192, (1, 4)), (8, 128256, 2048, (1, 1)),
    (128, 2048, 2048, (1, 2)), (128, 512, 2048, (1, 8)),
    (128, 8192, 2048, (1, 1)), (128, 2048, 8192, (1, 2)),
    (128, 128256, 2048, (2, 1)), (512, 2048, 2048, (1, 1))])
def test_wq_tile_rules_follow_the_shapes(m, n, k, want):
    """The kernel's warpgroups a block and cluster splits come from the
    shapes alone (llama3_1b's products at the decode step's 8 rows, the
    verify's 128 and a 512-row prefill), the same for both code
    forms."""
    groups = tq.wq_groups(m, n)
    for int4 in (False, True):
        assert (groups, tq.wq_splits(m, n, k, int4=int4, groups=groups)) \
            == want
    assert tq.row_tile(m) == {8: 8, 128: 128, 512: 128}[m]


def _swap(a):
    return np.swapaxes(np.asarray(a), -1, -2)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_quantize_llama_is_jax_transposed_bit_for_bit(form, tie):
    jc, jparams, tc, tparams = _converted(tie)
    jtree = getattr(jq, f"quantize_llama_{form}")(jparams)
    ttree = getattr(tq, f"quantize_llama_{form}")(tparams)
    pairs = [(f"layers/{k}", jtree["layers"][k], ttree["layers"][k], True)
             for k in ttree["layers"] if tq.is_quantized(ttree["layers"][k])]
    pairs.append(("embed", jtree["embed"], ttree["embed"], False))
    if not tie:
        pairs.append(("lm_head", jtree["lm_head"], ttree["lm_head"], True))
    assert len(pairs) == 7 + 1 + (not tie)
    for name, j, t, transposed in pairs:
        want_q = _jax_codes(j["q"])
        want_s = np.asarray(j["s"])
        if transposed:   # [.., in, out] -> [.., out, in]
            want_q, want_s = _swap(want_q), _swap(want_s)
        np.testing.assert_array_equal(tq.codes_of(t).numpy(), want_q,
                                      err_msg=name)
        np.testing.assert_array_equal(t["s"].numpy(), want_s, err_msg=name)
        assert t["s"].shape[-1] == 1, name       # per output channel
        assert t["q"].is_contiguous(), name
        if form == "int4":   # packed two a byte along K, the last axis
            assert t["q"].dtype == torch.uint8, name
            assert t["q"].shape[-1] * 2 == want_q.shape[-1], name
            torch.testing.assert_close(
                t["q"], tq.pack_int4(torch.from_numpy(want_q.copy())),
                rtol=0, atol=0, msg=name)


def test_quantized_bytes_matches_jax():
    jc = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.key(0), jc)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              tllama.LlamaConfig.tiny(), "cpu")
    for form in FORMS:
        jtree = getattr(jq, f"quantize_llama_{form}")(jparams)
        ttree = getattr(tq, f"quantize_llama_{form}")(tparams)
        assert tq.quantized_bytes(ttree) == jq.quantized_bytes(jtree)
    # int4 codes at half a byte: a quarter of the float32 matrices
    assert tq.quantized_bytes(tq.quantize_llama_int4(tparams)) < \
        tq.quantized_bytes(tq.quantize_llama_int8(tparams))
    # the int8 KV pool's {q, s} tree
    tpool = tllama.make_pool(tllama.LlamaConfig.tiny(), 6, 8, "cpu", "int8")
    jpool = tuple(jquantize_pool(jnp.zeros((2, 2, 6, 8, 16), jnp.float32))
                  for _ in range(2))
    assert tq.quantized_bytes(tpool) == jq.quantized_bytes(jpool)


def _converted(tie: bool):
    jc = jllama.LlamaConfig.tiny()
    tc = tllama.LlamaConfig.tiny()
    if tie:
        jc, tc = jc.scaled(tie_embeddings=True), tc.scaled(tie_embeddings=True)
    jparams = jllama.llama_init(jax.random.key(0), jc)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tc, "cpu")
    return jc, jparams, tc, tparams


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_params_from_jax_carries_quantized_trees(form, tie):
    jc, jparams, tc, tparams = _converted(tie)
    got = params_from_jax(
        jax.tree.map(np.asarray, getattr(jq, f"quantize_llama_{form}")(
            jparams)), tc, "cpu")
    want = getattr(tq, f"quantize_llama_{form}")(tparams)
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert gl.keys() == wl.keys()
    assert ("/lm_head/q" in gl) == (not tie)
    for name in gl:
        assert gl[name].dtype == wl[name].dtype, name
        torch.testing.assert_close(gl[name], wl[name], rtol=0, atol=0,
                                   msg=name)
    code_dtype = torch.int8 if form == "int8" else torch.uint8
    assert gl["/embed/q"].dtype == code_dtype
    assert gl["/layers/wq/q"].shape[:2] == (2, 64)   # [L, out, in]
    assert gl["/layers/wq/s"].shape == (2, 64, 1)
    assert gl["/layers/attn_norm"].dtype == torch.float32


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_model_functions_on_quantized_trees_match_jax(form, tie):
    jc, jparams, tc, tparams = _converted(tie)
    jparams = getattr(jq, f"quantize_llama_{form}")(jparams)
    tparams = getattr(tq, f"quantize_llama_{form}")(tparams)
    rng = np.random.default_rng(4)
    b, s, pg, n_pages, mp = 2, 16, 8, 12, 4
    lens = np.array([16, 7], np.int32)
    tokens = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    jl, (jk, jv) = jllama.llama_prefill_last(
        jparams, jnp.asarray(tokens), jc, kv_lengths=jnp.asarray(lens),
        implementation="xla")
    tl, (tk, tv) = tllama.llama_prefill_last(
        tparams, torch.from_numpy(tokens), tc,
        kv_lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    tables = np.full((b, mp), n_pages, np.int32)
    tables[0, :3], tables[1, :2] = [4, 0, 7], [2, 9]
    jkp = jnp.zeros((2, 2, n_pages, pg, 16), jnp.float32)
    jvp = jnp.zeros_like(jkp)
    zeros = jnp.zeros(b, jnp.int32)
    jkp = jscatter(jkp, jnp.asarray(tables), jk, zeros, jnp.asarray(lens))
    jvp = jscatter(jvp, jnp.asarray(tables), jv, zeros, jnp.asarray(lens))
    tkp, tvp = tllama.make_pool(tc, n_pages, pg, "cpu")
    tt, tlens = torch.from_numpy(tables), torch.from_numpy(lens)
    tz = torch.zeros(b, dtype=torch.int32)
    tscatter(tkp, tt, tk, tz, tlens)
    tscatter(tvp, tt, tv, tz, tlens)

    # one decode step
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, jkp, jvp = jllama.llama_decode_step_paged(
        jparams, jnp.asarray(tok), jkp, jvp, jnp.asarray(tables),
        jnp.asarray(lens), jc, implementation="xla")
    tl, tkp, tvp = tllama.llama_decode_step_paged(
        tparams, torch.from_numpy(tok).long(), tkp, tvp, tt, tlens, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), atol=ATOL)

    # a chunk after that history, then a tree verify after the chunk
    offsets = lens + 1
    chunk = rng.integers(0, 256, size=(b, 5)).astype(np.int32)
    clens = np.array([5, 3], np.int32)
    jl, jkp, jvp = jllama.llama_prefill_chunk_paged(
        jparams, jnp.asarray(chunk), jkp, jvp, jnp.asarray(tables),
        jnp.asarray(offsets), jnp.asarray(clens), jc,
        implementation="interpret")
    tl, tkp, tvp = tllama.llama_prefill_chunk_paged(
        tparams, torch.from_numpy(chunk).long(), tkp, tvp, tt,
        torch.from_numpy(offsets), torch.from_numpy(clens), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), atol=ATOL)

    from gofr_tpu_torch.serving.spec import build_draft_tree
    trees = [build_draft_tree(3, [[1, 2], [1, 5]]), build_draft_tree(8, [])]
    w = 4
    ttok = np.zeros((b, w), np.int32)
    depths = np.zeros((b, w), np.int32)
    masks = np.ones((b, w), np.int32)
    for i, t in enumerate(trees):
        ttok[i, :t.n_nodes], depths[i, :t.n_nodes] = t.tokens, t.depths
        masks[i, :t.n_nodes] = t.masks
    tlen = np.array([t.n_nodes for t in trees], np.int32)
    voff = offsets + clens
    jl, _, _ = jllama.llama_prefill_chunk_paged(
        jparams, jnp.asarray(ttok), jkp, jvp, jnp.asarray(tables),
        jnp.asarray(voff), jnp.asarray(tlen), jc,
        implementation="interpret", return_all_logits=True,
        tree_depths=jnp.asarray(depths), tree_masks=jnp.asarray(masks))
    tl, _, _ = tllama.llama_prefill_chunk_paged(
        tparams, torch.from_numpy(ttok).long(), tkp, tvp, tt,
        torch.from_numpy(voff), torch.from_numpy(tlen), tc,
        return_all_logits=True, tree_depths=torch.from_numpy(depths),
        tree_masks=torch.from_numpy(masks))
    live = np.arange(w)[None, :] < tlen[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL)


def _serve(engine, prompts, params):
    engine.start()
    try:
        reqs = [engine.submit(p, params) for p in prompts]
        deadline = time.time() + 120
        while time.time() < deadline and any(
                r.finished_at is None and r.error is None for r in reqs):
            time.sleep(0.005)
    finally:
        engine.stop()
    assert all(r.error is None and r.finished_at for r in reqs), \
        [r.error for r in reqs]
    return reqs


PATTERN = [9, 8, 7, 6] * 6


@pytest.mark.parametrize("form,extra", [
    ("int8", {}), ("int4", {}), ("int8", {"kv_dtype": "int8"}),
    ("int4", {"speculative": True, "spec_adaptive": False,
              "spec_ngram": 1})],
    ids=["int8", "int4", "int8-kv-int8", "int4-speculative"])
def test_engine_with_quantized_weights_matches_jax_engine(form, extra):
    jc, jparams, tc, tparams = _converted(False)
    common = dict(max_batch=2, max_seq=128, page_size=16, seed=0,
                  decode_steps_per_pass=4, prefix_cache=False, **extra)
    spec = extra.get("speculative", False)
    jeng = jax_llama_engine(
        jparams, jc,
        JaxEngineConfig(kv_layout="paged", compile_cache_dir=None,
                        paged_attention="interpret" if spec or extra
                        else "xla", **common),
        implementation="xla", quantize=form)
    teng = llama_engine(tparams, tc, EngineConfig(**common), device="cpu",
                        quantize=form)
    assert tq.is_quantized(teng.params["layers"]["w1"])
    rng = np.random.default_rng(21)
    prompts = [PATTERN if spec else rng.integers(0, 256, 11).tolist(),
               rng.integers(0, 256, 30).tolist()]
    want = _serve(jeng, prompts, JaxSamplingParams(temperature=0.0,
                                                   max_new_tokens=12))
    got = _serve(teng, prompts, SamplingParams(temperature=0.0,
                                               max_new_tokens=12))
    assert [r.generated for r in got] == [r.generated for r in want]
    for g, w in zip(got, want):
        assert request_digest(g.prompt_tokens, g.params, g.generated) == \
            request_digest(w.prompt_tokens, w.params, w.generated)
    if spec:
        assert teng.stats["spec_drafted"] > 0
        for key in ("spec_passes", "spec_drafted", "spec_accepted"):
            assert teng.stats[key] == jeng.stats[key], key


@pytest.mark.parametrize("extra,rows", [
    ({"max_batch": 513}, 513),
    ({"max_batch": 64, "speculative": True}, 1024),
    ({"max_batch": 32, "speculative": True, "spec_draft": 8}, 1024)])
def test_llama_engine_rejects_products_wider_than_the_kernel(extra, rows):
    """Quantized weights: a decode step or verify pass wider than M_MAX
    rows would send its products down the dequantizing route, so the
    engine is refused (quantized here or beforehand); 32 slots x a
    16-node bucket fit exactly."""
    _, _, tc, tparams = _converted(False)
    cfg = EngineConfig(max_seq=128, page_size=16, **extra)
    assert kernel_rows(cfg) == rows
    for quantize, tree in (("int8", tparams),
                           (None, tq.quantize_llama_int4(tparams))):
        with pytest.raises(ValueError, match=f"have {rows} rows, above "
                                             f"the weight-dequantizing "
                                             f"kernel's M_MAX = "
                                             f"{tq.M_MAX}"):
            llama_engine(tree, tc, cfg, device="cpu", quantize=quantize)
    fits = EngineConfig(max_seq=128, page_size=16, max_batch=32,
                        speculative=True)
    assert kernel_rows(fits) == tq.M_MAX == 512
    assert tq.is_quantized(llama_engine(tparams, tc, fits, device="cpu",
                                        quantize="int8").params["embed"])


def test_llama_engine_rejects_an_unknown_quantize():
    _, _, tc, tparams = _converted(False)
    with pytest.raises(ValueError, match="quantize must be None, 'int8' or "
                                         "'int4', got 'fp8'"):
        llama_engine(tparams, tc, device="cpu", quantize="fp8")
