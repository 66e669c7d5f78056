"""The port's ``llama_engine`` on the dense-cache paths against the JAX
``llama_engine``, on the CPU at ``LlamaConfig.tiny()``.

Both engines serve the same converted weights: the JAX engine on its
default slot layout and on the paged layout with
``paged_attention="view"``, the port's on the same. ``prefill_buckets``
is (16,), so every prompt past 16 tokens walks in chunks, through
``llama_prefill_chunk`` on the rows' dense copy; the second wave
repeats the first's long prompts, so on the view their page-aligned
prefixes hit the prefix cache (the slot layout keeps none). The first
wave is queued before ``start()``, the second submitted once the first
has ended, and the engine stops after it. Greedy
tokens, ``request_digest`` and the stamped digests must be equal, and
so must ``prefix_hits``; with ``speculative=True,
spec_adaptive=False`` the tree verify runs on the dense copy too, and
the spec counters must be equal. Also: the prompt that walks is served
whole, ``paged_attention`` takes the JAX engine's values, ``"view"``
forces the dense path where the native one is there, and the tiny demo
engine serves on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving import app
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import demo_llama_engine, llama_engine

from .torch_parity import assert_parity, serve_waves

torch.set_num_threads(2)

COMMON = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefill_batch=4,
              prefill_buckets=(16,))
N_NEW = 9


def _prompt(n, k):
    return [(7 * i + 3 * k + n) % 256 for i in range(n)]


#: wave 2 repeats wave 1's two long prompts (their 32- and 64-row
#: prefixes are cached on the view) and brings a new one
WAVES = [[_prompt(5, 0), _prompt(40, 1), _prompt(70, 2)],
         [_prompt(40, 1), _prompt(70, 2), _prompt(23, 3)]]

LAYOUTS = {
    "slot": dict(kv_layout="slot"),
    "view": dict(kv_layout="paged", paged_attention="view"),
    "view_int8": dict(kv_layout="paged", paged_attention="view",
                      kv_dtype="int8"),
    "view_windows": dict(kv_layout="paged", paged_attention="view",
                         decode_windows=(32, 64)),
    "slot_spec": dict(kv_layout="slot", speculative=True,
                      spec_adaptive=False, spec_ngram=2),
    "view_spec": dict(kv_layout="paged", paged_attention="view",
                      speculative=True, spec_adaptive=False, spec_ngram=2),
}

SPEC_STATS = ("spec_passes", "spec_drafted", "spec_accepted")


@pytest.fixture(scope="module")
def weights():
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    LlamaConfig.tiny(), "cpu")


def _engines(weights, **kw):
    cfg = {**COMMON, **kw}
    jeng = jax_llama_engine(weights[0], JaxLlamaConfig.tiny(),
                            JaxEngineConfig(compile_cache_dir=None, **cfg),
                            implementation="xla")
    teng = llama_engine(weights[1], LlamaConfig.tiny(), EngineConfig(**cfg),
                        device="cpu")
    return jeng, teng


def _serve(engine, *waves):
    port = isinstance(engine.config, EngineConfig)
    params = (SamplingParams if port else JaxSamplingParams)(
        temperature=0.0, max_new_tokens=N_NEW)
    return serve_waves(engine, waves, params)


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_llama_engine_matches_jax_on_the_dense_paths(weights, case):
    jeng, teng = _engines(weights, **LAYOUTS[case])
    assert not teng._native and teng._chunk_fn is not None
    assert_parity(_serve(teng, *WAVES), _serve(jeng, *WAVES), N_NEW)
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"]
    if teng.config.kv_layout == "paged":
        assert teng.stats["prefix_hits"] > 0
        assert sorted(teng._free_pages) == sorted(
            set(range(teng._n_pages)) - {p for pages in
                                         teng._prefix_cache.values()
                                         for p in pages})
    else:
        assert teng.stats["prefix_hits"] == 0 and not teng._prefix_enabled
    if teng.config.speculative:
        assert teng.stats["spec_passes"] > 0
        assert [teng.stats[k] for k in SPEC_STATS] == \
            [jeng.stats[k] for k in SPEC_STATS]
    if "windows" in case:
        passes = teng._decode_graph.passes_by_window
        assert passes[32] > 0 and passes[64] > 0


@pytest.mark.parametrize("layout", ["slot", "view"])
def test_a_prompt_past_every_bucket_walks_whole(weights, layout):
    _, teng = _engines(weights, **LAYOUTS[layout])
    prompt = _prompt(100, 4)
    req, = _serve(teng, [prompt])
    assert req.error is None and req.prompt_tokens == prompt
    # 100 tokens in 16-row chunks, no bucket prefill
    assert teng.stats["prefill_calls"] == 7


@pytest.mark.parametrize("layout", ["slot", "view"])
def test_speculative_tokens_equal_plain_tokens(weights, layout):
    spec = llama_engine(weights[1], LlamaConfig.tiny(), EngineConfig(
        **COMMON, **LAYOUTS[f"{layout}_spec"]), device="cpu")
    plain = llama_engine(weights[1], LlamaConfig.tiny(), EngineConfig(
        **COMMON, **LAYOUTS[layout]), device="cpu")
    wave = [[1, 2, 3, 4] * 10, _prompt(30, 5)]
    got, want = _serve(spec, wave), _serve(plain, wave)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert spec.stats["spec_accepted"] > 0


def test_paged_attention_values_match_jax(weights):
    for value in ("auto", "kernel", "interpret", "xla"):
        _, teng = _engines(weights, kv_layout="paged", paged_attention=value)
        assert teng._native
    _, teng = _engines(weights, kv_layout="paged", paged_attention="view")
    assert not teng._native and teng._decode_graph.layout == "view"
    with pytest.raises(ValueError, match="paged_attention"):
        llama_engine(weights[1], LlamaConfig.tiny(), EngineConfig(
            **COMMON, paged_attention="pallas"), device="cpu")


def test_demo_llama_engine_serves_on_the_cpu():
    engine = demo_llama_engine(device="cpu")
    assert engine.config.max_batch == 4 and engine.config.max_seq == 128
    req, = serve_waves(engine, [[[5, 6, 7]]],
                       SamplingParams(temperature=0.0, max_new_tokens=4))
    assert req.error is None and len(req.generated) == 4


def test_the_8b_preset_builds_in_app_engine(monkeypatch):
    built = []
    monkeypatch.setattr(app, "build_engine",
                        lambda config, **kw: built.append(config) or "engine")
    engine, _, name = app.app_engine({"MODEL_PRESET": "llama3_8b"})
    assert (engine, name) == ("engine", "llama3_8b")
    assert built == [LlamaConfig.llama3_8b()]
