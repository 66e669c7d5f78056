"""The port's scheduling core against the JAX engine's, on the CPU at the
tiny config: lazy page growth with preemption-by-recompute, pipelined
decode dispatch/collect, deferred prefill collect, and the lifecycle
calls ``cancel``, ``drain`` and ``warmup``.

Both engines serve the same converted weights on pools too small for
every request's whole life, at ``pipeline_depth`` 0 and 1. Every
request is queued before ``start()``, so that both engines admit one
batch and grow, preempt and requeue at the same points. Their tokens,
``request_digest`` (over the recompute prompt, which preemption
rewrites), ``preemptions`` (> 0) and ``requeues`` must be equal, and
afterwards the pool's books balance: every page is free or pinned by the
prefix cache, with one reference per cache entry. The cases: a dry pool
in both pool forms; the same with one 16-row bucket, so that prompts and
recomputes walk and preemption happens inside the walk; and a
speculative engine (``spec_adaptive=False``, the JAX kernels
interpreted) whose verify passes grow pages too. The JAX engine appends
every generated token to the prompt again at each preemption, so a
request preempted twice recomputes from a corrupted context; the port
folds each token in once, and the parity runs wrap the JAX engine's
``_preempt`` to do the same (``_fold_once``). One test shows that the
wrap leaves the shipped reference as it is wherever no request has
tokens to fold at more than one preemption (the depth-0 dry and walk
cases); another holds the port's dry-pool tokens to an unpreempted JAX
run and pins the reference's divergence.

On the port alone: ``DecodeGraph.launch`` twice then ``collect`` twice
equals two ``run`` calls, and a third launch into an uncollected ring
buffer raises; a batch prefill collected after its request was
preempted is dropped (the counterpart of
``tests/test_paged_attention.py``'s stale-prefill test); ``cancel`` of a
waiting and of an active request; ``drain``; and ``warmup`` leaving the
pools, the free list, ``lengths`` and the generator as they were.
"""

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
from gofr_tpu.serving.integrity import request_digest
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig, make_pool
from gofr_tpu_torch.ops.paged_kv import pool_row_bytes
from gofr_tpu_torch.serving.app import build_engine
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine

torch.set_num_threads(2)

PAGE = 8


def _converted_tiny():
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny(), "cpu")
    return jparams, tparams


def _pool_bytes(n_pages, kv_dtype):
    """The byte budget of ``n_pages`` pages of the tiny model's pool in
    ``kv_dtype``, K and V: both engines then size the same pool."""
    k_probe, _ = make_pool(LlamaConfig.tiny(), 1, PAGE, "cpu", kv_dtype)
    return n_pages * 2 * PAGE * pool_row_bytes(k_probe)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lengths]


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


def _assert_books_balance(eng):
    """Every page is free or pinned by the prefix cache, and each pinned
    page holds one reference per cache entry that lists it."""
    pinned = [p for pages in eng._prefix_cache.values() for p in pages]
    assert len(eng._free_pages) == len(set(eng._free_pages))
    assert len(eng._free_pages) + len(set(pinned)) == eng._n_pages
    assert sorted(set(eng._free_pages) | set(pinned)) == \
        list(range(eng._n_pages))
    np.testing.assert_array_equal(
        eng._page_refs, np.bincount(pinned, minlength=eng._n_pages))
    assert (eng._slot_pages == 0).all()


def _fold_once(jeng):
    """Wrap the JAX engine's ``_preempt`` so that a preempted request's
    prompt gains only the tokens generated since its last preemption.
    The JAX engine appends every generated token again at each
    preemption, so a request preempted twice recomputes from a context
    that holds its first tokens twice, and its greedy tokens leave those
    of an unpreempted run (ROADMAP Queue C;
    ``test_repeated_preemption_keeps_the_unpreempted_tokens``). The port
    repairs that; the parity runs hold it to the repaired reference."""
    inner, folded = jeng._preempt, {}

    def preempt(slot):
        req = jeng.active[slot]
        if req is None:
            return inner(slot)
        emitted = req.generated
        req.generated = emitted[folded.get(id(req), 0):]
        try:
            inner(slot)
        finally:
            req.generated = emitted
        folded[id(req)] = len(emitted)

    jeng._preempt = preempt
    return jeng


def _against_jax(prompts, n_new, *, jax_attention="xla", **common):
    """Serve ``prompts`` greedily through the JAX engine and the port's
    on the same converted weights and config; returns (port requests,
    JAX requests, port engine, JAX engine) after checking tokens,
    digests, preemptions, requeues and the port's books."""
    jparams, tparams = _converted_tiny()
    common = dict(seed=0, page_size=PAGE, **common)
    jeng = _fold_once(jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention=jax_attention,
                        compile_cache_dir=None, **common),
        implementation="xla"))
    teng = llama_engine(tparams, LlamaConfig.tiny(), EngineConfig(**common),
                        device="cpu")
    assert teng._n_pages == jeng._n_pages
    want = _serve_queued(jeng, prompts, JaxSamplingParams(
        temperature=0.0, max_new_tokens=n_new))
    got = _serve_queued(teng, prompts, SamplingParams(
        temperature=0.0, max_new_tokens=n_new))
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == n_new for r in got)
    for g, w in zip(got, want):
        assert g.prompt_tokens == w.prompt_tokens
        assert request_digest(g.prompt_tokens, g.params, g.generated) == \
            request_digest(w.prompt_tokens, w.params, w.generated)
    for key in ("preemptions", "requeues", "prefix_hits"):
        assert teng.stats[key] == jeng.stats[key], \
            (key, teng.stats[key], jeng.stats[key])
    assert teng.stats["preemptions"] > 0
    _assert_books_balance(teng)
    return got, want, teng, jeng


def _dry_case(kv_dtype, depth):
    """16 pages of 8 rows hold the four prompts (1 + 3 + 6 + 4 pages) but
    not their lives (4 + 6 + 8 + 7): decode growth preempts the newest
    requests, which come back by recompute. (prompts, new tokens, config)"""
    return (_prompts(31, (5, 20, 40, 30)), 24, dict(
        max_batch=4, max_seq=128, decode_steps_per_pass=4,
        prefix_cache=False, kv_dtype=kv_dtype,
        kv_pool_bytes=_pool_bytes(16, kv_dtype), pipeline_depth=depth))


def _walk_case(depth):
    """One 16-row bucket: every prompt longer than 16 walks, a chunk at a
    time with a decode step between rounds, and so does each recompute;
    the prefix cache pins retired prompts' pages and a hit re-attaches.
    (prompts, new tokens, config)"""
    first = _prompts(32, (5, 40, 70, 30))
    return (first + [first[2][:48] + [1, 2, 3]], 20, dict(
        jax_attention="interpret", max_batch=4, max_seq=128,
        decode_steps_per_pass=4, prefill_buckets=(16,), prefill_batch=4,
        prefill_chunks_per_pass=1, kv_pages=18, prefix_cache=True,
        pipeline_depth=depth))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("depth", [0, 1])
def test_dry_pool_preempts_like_the_jax_engine(depth, kv_dtype):
    prompts, n_new, cfg = _dry_case(kv_dtype, depth)
    _against_jax(prompts, n_new, **cfg)


@pytest.mark.parametrize("depth", [0, 1])
def test_dry_pool_preempts_inside_the_walk_like_the_jax_engine(depth):
    prompts, n_new, cfg = _walk_case(depth)
    got, _, teng, _ = _against_jax(prompts, n_new, **cfg)
    assert teng.stats["prefill_calls"] > len(prompts)


@pytest.mark.parametrize("case", ["dry-bf16", "dry-int8", "walk"])
def test_fold_once_leaves_the_reference_as_shipped_below_two_folds(case):
    # at depth 0 no request of these cases is preempted with tokens to
    # fold more than once, so the wrapped JAX engine is the shipped one:
    # their parity runs hold the port to the reference as it stands
    prompts, n_new, cfg = (_walk_case(0) if case == "walk"
                           else _dry_case(case[4:], 0))
    jparams, _ = _converted_tiny()
    attention = cfg.pop("jax_attention", "xla")
    runs = []
    for wrap in (False, True):
        jeng = jax_llama_engine(
            jparams, JaxLlamaConfig.tiny(),
            JaxEngineConfig(kv_layout="paged", paged_attention=attention,
                            compile_cache_dir=None, seed=0, page_size=PAGE,
                            **cfg),
            implementation="xla")
        if wrap:
            _fold_once(jeng)
        folds, inner = {}, jeng._preempt

        def preempt(slot, jeng=jeng, inner=inner, folds=folds):
            req = jeng.active[slot]
            if req is not None and req.generated:
                folds[id(req)] = folds.get(id(req), 0) + 1
            inner(slot)

        jeng._preempt = preempt
        reqs = _serve_queued(jeng, prompts, JaxSamplingParams(
            temperature=0.0, max_new_tokens=n_new))
        assert jeng.stats["preemptions"] > 0
        assert max(folds.values()) == 1, folds
        runs.append(([r.generated for r in reqs],
                     [r.prompt_tokens for r in reqs],
                     [jeng.stats[k] for k in ("preemptions", "requeues",
                                              "prefix_hits")]))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("depth", [0, 1])
def test_speculative_dry_pool_matches_the_jax_engine(depth):
    # repetitive prompts draft from the first pass; each verify pass
    # grows every fed tree row's pages first and preempts when it cannot
    prompts = [[11, 22, 33, 44] * 6, [5, 6, 7] * 9, [40, 41, 42, 43, 44] * 5,
               _prompts(33, (12,))[0]]
    got, want, teng, jeng = _against_jax(
        prompts, 24, jax_attention="interpret", max_batch=4, max_seq=128,
        decode_steps_per_pass=4, prefix_cache=False, kv_pages=16,
        speculative=True, spec_adaptive=False, spec_ngram=1,
        pipeline_depth=depth)
    for key in ("spec_passes", "spec_drafted", "spec_accepted"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["spec_drafted"] > 0


def test_repeated_preemption_keeps_the_unpreempted_tokens():
    # at depth 1 the dry pool preempts the 40-token request twice: the
    # port recomputes it from its prompt and every token it emitted, each
    # once, so its greedy tokens are those of a run that never preempts
    # (the JAX engine on an ample pool); the JAX engine on the dry pool
    # appends its first tokens to the prompt a second time and diverges
    jparams, tparams = _converted_tiny()
    prompts = _prompts(31, (5, 20, 40, 30))
    common = dict(seed=0, page_size=PAGE, max_batch=4, max_seq=128,
                  decode_steps_per_pass=4, prefix_cache=False,
                  pipeline_depth=1)

    def jax_engine(pages):
        return jax_llama_engine(
            jparams, JaxLlamaConfig.tiny(),
            JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                            compile_cache_dir=None, kv_pages=pages,
                            **common),
            implementation="xla")

    greedy = JaxSamplingParams(temperature=0.0, max_new_tokens=24)
    ample = _serve_queued(jax_engine(64), prompts, greedy)
    jax_dry = _serve_queued(jax_engine(16), prompts, greedy)
    teng = llama_engine(tparams, LlamaConfig.tiny(),
                        EngineConfig(kv_pages=16, **common), device="cpu")
    preempted, inner = [], teng._preempt

    def preempt(slot):
        preempted.append(teng.active[slot].prompt_tokens[:5])
        inner(slot)

    teng._preempt = preempt
    got = _serve_queued(teng, prompts, SamplingParams(temperature=0.0,
                                                      max_new_tokens=24))
    assert [r.generated for r in got] == [r.generated for r in ample]
    twice = [i for i, p in enumerate(prompts) if preempted.count(p[:5]) > 1]
    assert twice == [2]
    req = got[2]
    assert req.prompt_tokens == prompts[2] + req.generated[
        :len(req.prompt_tokens) - len(prompts[2])]
    # the reference's fault: the same request, recomputed from a prompt
    # that holds its first tokens twice
    assert jax_dry[2].generated != ample[2].generated
    assert jax_dry[2].prompt_tokens != prompts[2] + jax_dry[2].generated[
        :len(jax_dry[2].prompt_tokens) - len(prompts[2])]
    _assert_books_balance(teng)


# ------------------------------------------------------------ port alone
def _engine(**cfg):
    return build_engine(LlamaConfig.tiny(), device="cpu",
                        engine_config=EngineConfig(seed=0, **cfg))


def test_launch_twice_then_collect_twice_equals_two_runs():
    outs = []
    for pipelined in (False, True):
        eng = _engine(max_batch=4, max_seq=128, decode_steps_per_pass=4,
                      pipeline_depth=1)
        for p in ([1, 2, 3], [9, 8, 7, 6]):
            eng.submit(p, SamplingParams(temperature=0.8, top_k=20,
                                         max_new_tokens=40))
        eng._admit()
        eng._collect_prefills()    # depth 1: the first tokens were in flight
        eng._sync_decode_state()
        eng._sync_tables()
        graph = eng._decode_graph
        if pipelined:
            handles = [graph.launch(eng.k_cache, eng.v_cache, False)
                       for _ in range(2)]
            with pytest.raises(RuntimeError, match="uncollected"):
                graph.launch(eng.k_cache, eng.v_cache, False)
            got = [graph.collect(h) for h in handles]
        else:
            got = [graph.run(eng.k_cache, eng.v_cache, False)
                   for _ in range(2)]
        outs.append((got, graph.save()))
    (runs, state_runs), (pipe, state_pipe) = outs
    for a, b in zip(runs, pipe):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0], runs[1])
    for name, value in state_runs.items():
        if name != "generator":
            assert torch.equal(state_pipe[name], value), name
    assert torch.equal(state_pipe["generator"], state_runs["generator"])


def test_stale_prefill_is_discarded_after_a_preempt():
    eng = _engine(max_batch=2, max_seq=64, page_size=8, pipeline_depth=1)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=5)
    req = eng.submit([1, 2, 3, 4], greedy)
    eng._admit()                   # depth 1: the first token stays in flight
    assert req.pending_prefill and len(eng._pending_prefills) == 1
    slot, epoch = req.slot, req.prefill_epoch
    eng._preempt(slot)             # pool pressure before the collect
    assert eng.stats["preemptions"] == 1 and req.prefill_epoch == epoch + 1
    assert eng._requeued == [req] and eng.active[slot] is None
    eng._admit()                   # re-admitted, into the same slot
    assert eng.active[slot] is req and req.prefill_epoch == epoch + 2
    assert len(eng._pending_prefills) == 2
    eng._collect_prefills()        # the stale record lands nowhere
    assert len(req.generated) == 1 and not req.pending_prefill
    assert eng.lengths[slot] == len(req.prompt_tokens)
    eng.stop()
    _assert_books_balance(eng)


def test_cancel_a_waiting_and_an_active_request():
    eng = _engine(max_batch=2, max_seq=128, decode_steps_per_pass=4)
    params = SamplingParams(temperature=0.0, max_new_tokens=60)
    waiting = eng.submit([1, 2, 3], params)
    eng.cancel(waiting)
    active = eng.submit([4, 5, 6], params)
    eng._admit()
    assert waiting.done.is_set() and waiting.slot == -1
    assert waiting.error is None and waiting.generated == []
    assert active.slot >= 0
    eng._decode_dispatch()         # a pass in flight for the active slot
    n = len(active.generated)
    eng.cancel(active)
    eng._decode_step()             # the sweep retires it; its tokens drop
    assert active.done.is_set() and active.error is None
    assert len(active.generated) == n
    assert eng.active == [None, None] and not eng._pending
    eng.stop()
    _assert_books_balance(eng)


def test_drain_finishes_the_work_then_stops():
    eng = _engine(max_batch=2, max_seq=128, decode_steps_per_pass=4)
    params = SamplingParams(temperature=0.0, max_new_tokens=40)
    reqs = [eng.submit(p, params) for p in ([1, 2], [3, 4, 5], [6])]
    eng.start()
    result = []
    drainer = threading.Thread(target=lambda: result.append(
        eng.drain(timeout_s=60)))
    drainer.start()
    while not eng._draining and drainer.is_alive():
        time.sleep(0.001)
    late = eng.submit([7, 8], params)          # refused while draining
    drainer.join(timeout=90)
    assert result == [True]
    assert late.error and "draining" in late.error and late.done.is_set()
    assert all(r.error is None and len(r.generated) == 40 for r in reqs)
    assert not eng._running and eng.health_check()["status"] == "DOWN"
    _assert_books_balance(eng)


def _leaves(pool):
    return list(pool.values()) if isinstance(pool, dict) else [pool]


@pytest.mark.parametrize("speculative", [False, True])
def test_warmup_leaves_pools_free_list_lengths_and_generator(speculative):
    eng = _engine(max_batch=4, max_seq=128, page_size=PAGE, kv_pages=40,
                  prefill_buckets=(16, 64), speculative=speculative)
    prompt = list(range(1, 30))
    # a request served first: the pools hold rows and the cache a prefix
    eng.start()
    assert eng.submit_sync(prompt, SamplingParams(
        temperature=0.0, max_new_tokens=6), 60).error is None
    eng.stop()
    pools = [t.clone() for p in (eng.k_cache, eng.v_cache)
             for t in _leaves(p)]
    free, lengths = list(eng._free_pages), eng.lengths.copy()
    generator = eng._generator.get_state()
    state = eng._decode_graph.save()
    seconds = eng.warmup(prompt_lens=(1, 40), chunked=True)
    assert seconds > 0
    after = [t for p in (eng.k_cache, eng.v_cache) for t in _leaves(p)]
    assert all(torch.equal(a, b) for a, b in zip(after, pools))
    assert eng._free_pages == free
    np.testing.assert_array_equal(eng.lengths, lengths)
    assert torch.equal(eng._generator.get_state(), generator)
    for name, value in eng._decode_graph.save().items():
        assert torch.equal(value, state[name]), name
    # and it serves the same tokens as an engine that never warmed up
    cold = _engine(max_batch=4, max_seq=128, page_size=PAGE, kv_pages=40,
                   prefill_buckets=(16, 64), speculative=speculative)
    params = SamplingParams(temperature=0.9, max_new_tokens=10)
    reqs = []
    for engine in (eng, cold):
        engine.start()
        reqs.append(engine.submit_sync(prompt[:20], params, 60))
        engine.stop()
    assert reqs[0].generated == reqs[1].generated


def test_decode_graph_ring_holds_depth_plus_one_buffers():
    eng = _engine(max_batch=2, max_seq=64, pipeline_depth=3)
    assert len(eng._decode_graph._ring) == 4
    assert len(_engine(max_batch=2, max_seq=64)._decode_graph._ring) == 2
