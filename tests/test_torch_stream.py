"""The engine's per-token channel (``GenRequest.out_queue``,
``Engine.stream_request``) on the CPU at the tiny config.

In plain decode (K x M = 8 x 2, greedy tokens equal to the JAX engine's
on the same converted weights), speculative decode, a chunk walk with
the prefix cache, and a dry pool that preempts with a dispatch always in
flight (so that collects discard rows), every request's drained channel
is its ``generated`` followed by exactly one ``None``: each token once,
none that a collect discarded, none of the tokens a recompute folded
into its prompt again. A cancelled request (waiting, and mid-stream
through ``stream_request``) and a failed one end their streams; a
refused submit ends it at once. Under a shortened thread switch
interval, more submitting and streaming threads than cores each read
exactly their own request's tokens, and the scheduler's counters
balance.
"""

import os
import queue
import sys
import threading
import time

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
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine

torch.set_num_threads(2)

GREEDY = dict(temperature=0.0)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny(), "cpu")
    return jparams, tparams


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lengths]


def _drained(req) -> list:
    out = []
    while True:
        try:
            out.append(req.out_queue.get_nowait())
        except queue.Empty:
            return out


def _serve_queued(engine, prompts, params):
    """Queue every prompt, then start and wait for all of them."""
    reqs = [engine.submit(p, params) for p in prompts]
    engine.start()
    try:
        deadline = time.time() + 120
        while time.time() < deadline and any(
                r.finished_at is None and r.error is None for r in reqs):
            time.sleep(0.005)
    finally:
        engine.stop()
    assert all(r.error is None and r.finished_at is not None
               for r in reqs), [r.error for r in reqs]
    return reqs


#: (prompts, new tokens, EngineConfig fields, stat that must be > 0)
CASES = {
    "plain_k8_m2": (_prompts(41, (5, 20, 40, 60)), 21, dict(
        max_batch=4, max_seq=128, page_size=16, decode_steps_per_pass=8,
        decode_passes_per_dispatch=2, prefix_cache=False),
        "decode_passes"),
    "speculative": ([[11, 22, 33, 44] * 12, [5, 6, 7] * 10 + [9]], 24, dict(
        max_batch=2, max_seq=128, page_size=16, decode_steps_per_pass=4,
        prefix_cache=False, speculative=True, spec_adaptive=False,
        spec_ngram=1), "spec_accepted"),
    "walk": (_prompts(42, (5, 40, 70, 30)), 16, dict(
        max_batch=4, max_seq=128, page_size=8, decode_steps_per_pass=4,
        prefill_buckets=(16,), prefill_batch=4, prefill_chunks_per_pass=1,
        prefix_cache=True), "prefill_calls"),
    "dry_pool_preempts": (_prompts(31, (5, 20, 40, 30)), 24, dict(
        max_batch=4, max_seq=128, page_size=8, decode_steps_per_pass=4,
        prefix_cache=False, kv_pages=16, pipeline_depth=1), "preemptions"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_channel_is_generated_then_one_end(weights, case):
    prompts, n_new, cfg, stat = CASES[case]
    eng = llama_engine(weights[1], LlamaConfig.tiny(),
                       EngineConfig(seed=0, **cfg), device="cpu")
    reqs = _serve_queued(eng, prompts,
                         SamplingParams(max_new_tokens=n_new, **GREEDY))
    assert eng.stats[stat] > 0, eng.stats
    for req in reqs:
        assert len(req.generated) == n_new
        assert _drained(req) == req.generated + [None]
    if case == "dry_pool_preempts":
        # recomputed requests folded their tokens into their prompts,
        # and their channels still hold each token once
        assert any(r.folded for r in reqs)
    if case == "walk":
        assert eng.stats["prefill_calls"] > len(prompts)


def test_streamed_greedy_tokens_equal_the_jax_engine(weights):
    prompts, n_new, cfg, _ = CASES["plain_k8_m2"]
    jeng = jax_llama_engine(
        weights[0], JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                        compile_cache_dir=None, seed=0, **cfg),
        implementation="xla")
    want = _serve_queued(jeng, prompts,
                         JaxSamplingParams(max_new_tokens=n_new, **GREEDY))
    eng = llama_engine(weights[1], LlamaConfig.tiny(),
                       EngineConfig(seed=0, **cfg), device="cpu")
    reqs = [eng.submit(p, SamplingParams(max_new_tokens=n_new, **GREEDY))
            for p in prompts]
    eng.start()
    try:
        streamed = [list(eng.stream_request(r)) for r in reqs]
    finally:
        eng.stop()
    assert streamed == [r.generated for r in want]
    assert all(r.error is None and not r.cancelled for r in reqs)


def _engine(weights, **cfg):
    base = dict(max_batch=2, max_seq=128, page_size=16, seed=0,
                decode_steps_per_pass=4, prefix_cache=False)
    return llama_engine(weights[1], LlamaConfig.tiny(),
                        EngineConfig(**{**base, **cfg}), device="cpu")


def test_a_cancelled_waiting_request_ends_its_stream(weights):
    eng = _engine(weights)
    req = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=8, **GREEDY))
    ticks = eng.stream_request(req, timeout_s=0.01)
    assert next(ticks) is None           # nothing yet: a tick, not an end
    ticks.close()                        # the caller leaves: cancelled
    assert req.cancelled and not req.done.is_set()
    eng._admit()                         # dropped at admission
    assert req.done.is_set() and req.slot == -1 and not req.generated
    assert _drained(req) == [None]
    assert all(r is None for r in eng.active)


def test_closing_a_stream_mid_way_cancels_and_ends_it(weights):
    eng = _engine(weights)
    req = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=100, **GREEDY))
    eng._admit()                         # prefilled: the first token
    stream = eng.stream_request(req)
    assert next(stream) == req.generated[0]
    eng._decode_step()
    seen = [next(stream) for _ in range(3)]
    stream.close()
    assert req.cancelled and seen == req.generated[1:4]
    eng._decode_step()                   # the sweep retires the slot
    assert req.done.is_set() and all(r is None for r in eng.active)
    assert len(req.generated) < 100
    assert _drained(req) == req.generated[4:] + [None]
    assert sorted(eng._free_pages) == list(range(eng._n_pages))


def test_a_failed_request_ends_its_stream_and_a_refused_one_at_once(weights):
    eng = _engine(weights)

    def broken(*args, **kwargs):
        raise RuntimeError("planted decode fault")

    eng._decode_graph.launch = broken
    req = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=8, **GREEDY))
    eng.start()
    try:
        tokens = list(eng.stream_request(req))
    finally:
        eng.stop()
    assert tokens == req.generated and len(tokens) == 1   # the prefill's
    assert req.error == "engine crashed: RuntimeError: planted decode fault"
    assert _drained(req) == []
    refused = eng.submit([1, 2], SamplingParams(max_new_tokens=4))
    # the JAX engine's typed refusal of a crashed engine
    assert refused.error == "engine not accepting requests"
    assert refused.reject.code == "engine_down"
    assert list(eng.stream_request(refused)) == []
    assert not refused.cancelled


def test_more_streaming_threads_than_cores_each_read_their_own(weights):
    eng = _engine(weights, max_batch=4)
    n = 2 * (os.cpu_count() or 4)
    got: dict = {}

    def client(i):
        req = eng.submit([1 + i % 200, 2, 3 + i % 50],
                         SamplingParams(max_new_tokens=6, **GREEDY))
        got[i] = (req, list(eng.stream_request(req, timeout_s=0.001)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        eng.stop()
    assert sorted(got) == list(range(n))
    for req, streamed in got.values():
        assert req.error is None and len(req.generated) == 6
        assert [t for t in streamed if t is not None] == req.generated
        assert _drained(req) == []
    counters = eng.waiting.counters
    assert counters["admitted"] == counters["dequeued"] == n
