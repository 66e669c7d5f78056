"""The port's ``moe_engine`` against the JAX ``moe_engine`` on the
engine's dense-cache paths, on the CPU at ``MoEConfig.tiny()``.

Both engines serve the same converted weights. Every wave is queued
before ``start()`` (both engines then admit it as one batch, so the
prefill groups are the same) and the engine stops after it. Greedy
tokens, ``integrity.request_digest`` (the JAX package's function) and
each engine's stamped digest must be equal:

- on the slot layout, on the paged layout through the pool's dense view
  (the JAX engine's view path on the CPU) with bf16 and int8 pools, and
  with ``decode_windows`` on both layouts (the port's windows of 32 and
  64 rows are each replayed);
- without a chunk function: a prompt past the widest bucket is clamped
  to it, the prefix cache stays off, and ``speculative=True`` serves
  plain decode;
- across a ``pass_raise`` restart on the slot layout, whose caches are
  zeroed in place (same tensors) and whose recovered requests keep the
  clean run's digests.

Also: the config checks of the JAX engine (``kv_layout``, int8 and
``kv_pool_bytes`` need the paged layout), ``llama_engine`` refusing an
int8 KV form on the slot layout, a dry view pool preempting with its continuation cut to the
widest bucket, and the decode window a dispatch picks.
"""

import time

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models.moe import MoEConfig as JaxMoEConfig
from gofr_tpu.models.moe import moe_init as jax_moe_init
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import RestartPolicy as JaxRestartPolicy
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import moe_engine as jax_moe_engine
from gofr_tpu.serving.integrity import request_digest
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.models.moe import MoEConfig
from gofr_tpu_torch.serving.engine import (EngineConfig, RestartPolicy,
                                           SamplingParams)
from gofr_tpu_torch.serving.glue import llama_engine, moe_engine

torch.set_num_threads(2)

COMMON = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefill_batch=4)
N_NEW = 11
#: two waves: the first decodes inside a 32-row and then a 64-row
#: window, the second needs the full cache
WAVES = [[[(7 * i + 3 + n) % 256 for i in range(n)] for n in (5, 26)],
         [[(5 * i + 1 + n) % 256 for i in range(n)] for n in (40, 70)]]


@pytest.fixture(scope="module")
def weights():
    jparams = jax_moe_init(jax.random.key(0), JaxMoEConfig.tiny())
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    MoEConfig.tiny(), "cpu")


def _is_port(engine) -> bool:
    return isinstance(engine.config, EngineConfig)


def _engines(weights, **kw):
    cfg = {**COMMON, **kw}
    jeng = jax_moe_engine(weights[0], JaxMoEConfig.tiny(),
                          JaxEngineConfig(compile_cache_dir=None, **cfg),
                          implementation="xla")
    teng = moe_engine(weights[1], MoEConfig.tiny(), EngineConfig(**cfg),
                      device="cpu")
    return jeng, teng


def _serve(engine, prompts, n_new=N_NEW, stop=True):
    """Queue ``prompts`` before ``start()``, wait until each ended, then
    stop (a stopped engine takes submits again after ``reopen``)."""
    params = (SamplingParams if _is_port(engine) else JaxSamplingParams)(
        temperature=0.0, max_new_tokens=n_new)
    engine.waiting.reopen()
    reqs = [engine.submit(p, params) for p in prompts]
    engine.start()
    try:
        deadline = time.time() + 120
        while time.time() < deadline and any(
                r.finished_at is None and r.error is None for r in reqs):
            time.sleep(0.005)
    finally:
        if stop:
            engine.stop()
    return reqs


def _assert_same(got, want, n_new=N_NEW):
    assert [r.error for r in got] == [r.error for r in want]
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == n_new for r in got)
    for g, w in zip(got, want):
        assert g.prompt_tokens == w.prompt_tokens
        assert request_digest(g.prompt_tokens, g.params, g.generated) == \
            request_digest(w.prompt_tokens, w.params, w.generated)
        assert g.digest is not None and g.digest == w.digest


LAYOUTS = {
    "slot": dict(kv_layout="slot"),
    "view_bf16": dict(kv_layout="paged"),
    "view_int8": dict(kv_layout="paged", kv_dtype="int8"),
    "slot_windows": dict(kv_layout="slot", decode_windows=(32, 64)),
    "view_windows": dict(kv_layout="paged", decode_windows=(32, 64)),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_moe_engine_matches_jax(weights, case):
    jeng, teng = _engines(weights, **LAYOUTS[case])
    for wave in WAVES:
        want, got = _serve(jeng, wave), _serve(teng, wave)
        _assert_same(got, want)
    passes = teng._decode_graph.passes_by_window
    if "windows" in case:
        assert passes[32] > 0 and passes[64] > 0 and passes[0] > 0
    else:
        assert list(passes) == [0] and passes[0] > 0
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 0
    if teng.config.kv_layout == "paged":
        assert sorted(teng._free_pages) == list(range(teng._n_pages))


def test_slot_and_view_engines_give_the_same_bits(weights):
    # the same data meets the same arithmetic on both layouts
    out = []
    for layout in ("slot", "paged"):
        eng = moe_engine(weights[1], MoEConfig.tiny(),
                         EngineConfig(kv_layout=layout, **COMMON),
                         device="cpu")
        out.append([[r.generated, r.digest] for wave in WAVES
                    for r in _serve(eng, wave, n_new=20)])
    assert out[0] == out[1]


def test_a_prompt_past_the_widest_bucket_is_clamped_like_jax(weights):
    prompt = [(3 * i + 2) % 256 for i in range(50)]
    for layout in ("slot", "paged"):
        jeng, teng = _engines(weights, kv_layout=layout,
                              prefill_buckets=(16, 32))
        want, got = _serve(jeng, [prompt]), _serve(teng, [prompt])
        _assert_same(got, want)
        assert got[0].prompt_tokens == prompt[-32:]
        assert teng.stats["prefill_calls"] == 1         # no chunk walk


def test_the_prefix_cache_stays_off_without_a_chunk_function(weights):
    prompt = [(11 * i + 5) % 256 for i in range(40)]
    jeng, teng = _engines(weights, kv_layout="paged", prefix_cache=True)
    for _ in range(2):
        _assert_same(_serve(teng, [prompt]), _serve(jeng, [prompt]))
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 0
    assert not teng._prefix_cache and not teng._prefix_enabled
    assert not jeng._prefix_enabled


def test_speculative_serves_plain_decode_without_a_verify_function(weights):
    jeng, teng = _engines(weights, kv_layout="slot", speculative=True)
    _assert_same(_serve(teng, WAVES[0]), _serve(jeng, WAVES[0]))
    assert not teng._spec_enabled and not jeng._spec_enabled
    assert teng.stats["spec_passes"] == 0
    assert teng.stats["decode_passes"] > 0
    plain = moe_engine(weights[1], MoEConfig.tiny(),
                       EngineConfig(kv_layout="slot", **COMMON),
                       device="cpu")
    assert [r.generated for r in _serve(plain, WAVES[0])] == \
        [r.generated for r in _serve(teng, WAVES[0])]


def test_a_restart_on_the_slot_layout_keeps_the_digests(weights):
    policy = dict(max_restarts=3, backoff_s=0.01)
    clean = _serve(moe_engine(weights[1], MoEConfig.tiny(),
                              EngineConfig(kv_layout="slot", **COMMON),
                              device="cpu"), WAVES[1])
    cfg = dict(kv_layout="slot", faults="pass_raise:at=2", **COMMON)
    jeng = jax_moe_engine(weights[0], JaxMoEConfig.tiny(),
                          JaxEngineConfig(
                              compile_cache_dir=None,
                              restart_policy=JaxRestartPolicy(**policy),
                              **cfg), implementation="xla")
    teng = moe_engine(weights[1], MoEConfig.tiny(),
                      EngineConfig(restart_policy=RestartPolicy(**policy),
                                   **cfg), device="cpu")
    caches = [teng.k_cache, teng.v_cache]
    zeroed = []
    real_zero = torch.Tensor.zero_

    def spy(t):
        if any(t is c for c in caches):
            zeroed.append(t.data_ptr())
        return real_zero(t)

    torch.Tensor.zero_ = spy
    try:
        got = _serve(teng, WAVES[1])
    finally:
        torch.Tensor.zero_ = real_zero
    want = _serve(jeng, WAVES[1])
    view = [(r.generated, r.digest, r.recovered,
             r.reject.code if r.reject else None) for r in got]
    assert view == [(r.generated, r.digest, r.recovered,
                     r.reject.code if r.reject else None) for r in want]
    assert teng._restarts == jeng._restarts == 1
    # the caches were zeroed in place, never reallocated
    assert sorted(zeroed) == sorted(c.data_ptr() for c in caches)
    assert [teng.k_cache, teng.v_cache] == caches
    for i, r in enumerate(got):
        if r.recovered:
            assert r.digest == clean[i].digest


def test_a_dry_view_pool_preempts_and_cuts_the_continuation(weights):
    # 9 pages of 16 rows for 4 prompts of 30 tokens, 60 new each: the
    # pool runs dry while decoding, the newest requests are preempted and
    # come back with prompt + generated cut to the widest bucket (32)
    teng = moe_engine(weights[1], MoEConfig.tiny(),
                      EngineConfig(kv_layout="paged", kv_pages=9,
                                   prefill_buckets=(16, 32), **COMMON),
                      device="cpu")
    prompts = [[(13 * i + k) % 256 for i in range(30)] for k in range(4)]
    reqs = _serve(teng, prompts, n_new=60)
    assert all(r.error is None and len(r.generated) == 60 for r in reqs)
    assert teng.stats["preemptions"] > 0
    assert max(len(r.prompt_tokens) for r in reqs) <= 32
    assert sorted(teng._free_pages) == list(range(teng._n_pages))


def test_the_dispatch_takes_the_smallest_covering_window(weights):
    teng = moe_engine(weights[1], MoEConfig.tiny(),
                      EngineConfig(kv_layout="slot", decode_windows=(
                          64, 32, 128, 500), **COMMON), device="cpu")
    # windows at or past max_seq are dropped, the rest sorted
    assert teng._decode_windows == (32, 64)
    assert [teng._pick_window(n) for n in (1, 32, 33, 64, 65, 128)] == \
        [32, 32, 64, 64, 0, 0]


def test_config_checks_match_jax(weights):
    for bad, match in ((dict(kv_layout="ring"), "kv_layout"),
                       (dict(kv_layout="slot", kv_dtype="int8"), "int8"),
                       (dict(kv_layout="slot", kv_pool_bytes=1 << 20),
                        "kv_pool_bytes")):
        with pytest.raises(ValueError, match=match):
            jax_moe_engine(weights[0], JaxMoEConfig.tiny(),
                           JaxEngineConfig(compile_cache_dir=None,
                                           **{**COMMON, **bad}))
        with pytest.raises(ValueError, match=match):
            moe_engine(weights[1], MoEConfig.tiny(),
                       EngineConfig(**{**COMMON, **bad}), device="cpu")


def test_llama_engine_refuses_the_slot_layout():
    # llama_engine serves the slot layout now; what it refuses there is
    # a quantized KV form, which needs pages, as the JAX engine does
    c = LlamaConfig.tiny()
    params = llama_init(c, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="int8"):
        llama_engine(params, c, EngineConfig(kv_layout="slot",
                                             kv_dtype="int8", **COMMON),
                     device="cpu")
    assert not llama_engine(params, c, EngineConfig(
        kv_layout="slot", **COMMON), device="cpu")._paged


def test_moe_engine_runs_on_cuda_unless_asked(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        moe_engine(weights[1], MoEConfig.tiny())
