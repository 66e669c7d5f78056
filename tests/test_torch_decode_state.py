"""The port's compiled decode dispatch on the CPU (the counterpart of
``tests/test_decode_state.py`` for the JAX engine).

The port keeps its per-slot decode state in static buffers, row = slot
(``serving/decode_graph.py``), rewritten only when an event changes it,
and runs T = K x M decode steps a dispatch with on-device token feedback
and length advance. On the CPU the same pass runs on the same buffers
without a CUDA graph, so these tests pin the contract there:

- steady-state dispatches upload nothing (``h2d_transfers`` and
  ``sched_syncs`` stay put, and the upload path is made to raise), and
  an admission costs exactly one resync;
- ``decode_passes_per_dispatch`` (M) is a pure throughput knob: greedy
  tokens at M = 4 equal those at M = 1, in fewer dispatches, and equal
  the JAX engine's at M = 4 (tokens and ``request_digest``), on bf16 and
  int8 pools;
- an M = 4 dispatch crossing ``max_seq`` emits only the valid prefix and
  retires the slot;
- a slot in the middle of its chunk walk keeps its pages byte for byte
  through a decode dispatch, with ``max_seq % page_size != 0``;
- ``sample_batch(all_greedy=...)`` gives what the inferred flag gives;
- the plain pool writes drop out-of-range rows as JAX's ``pool_write``
  (``mode="drop"``) does, in both pool forms.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.ops import paged_kv as jkv
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.integrity import request_digest
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.ops import paged_kv as tkv
from gofr_tpu_torch.serving.app import build_engine
from gofr_tpu_torch.serving.decode_graph import DecodeGraph
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.sampling import TOPK_BOUND, sample_batch

torch.set_num_threads(2)


def _engine(**cfg):
    return build_engine(LlamaConfig.tiny(), device="cpu",
                        engine_config=EngineConfig(seed=0, **cfg))


def _admit(eng, prompts, **sp):
    """Queue and admit on this thread (no engine thread), so the test
    decides when each dispatch runs; short prompts prefill at once."""
    reqs = [eng.submit(p, SamplingParams(**sp)) for p in prompts]
    eng._admit()
    assert all(r.error is None and r.slot >= 0 for r in reqs)
    return reqs


def _serve(eng, prompts, params):
    """Serve concurrent prompts on the engine's thread (either engine)."""
    eng.start()
    try:
        reqs = [eng.submit(p, params) for p in prompts]
        deadline = time.time() + 120
        while time.time() < deadline and any(
                r.finished_at is None and r.error is None for r in reqs):
            time.sleep(0.005)
    finally:
        eng.stop()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return reqs


def test_steady_state_decode_uploads_nothing(monkeypatch):
    eng = _engine(max_batch=4, max_seq=256, decode_steps_per_pass=4)
    reqs = _admit(eng, [[1 + i, 2, 3] for i in range(3)], temperature=0.0,
                  max_new_tokens=200)
    eng._decode_step()            # the admitted state goes up once
    assert eng.stats["sched_syncs"] == 1
    transfers, syncs = eng.stats["h2d_transfers"], eng.stats["sched_syncs"]

    def refuse(self, **arrays):
        raise AssertionError(f"steady-state upload of {sorted(arrays)}")

    monkeypatch.setattr(DecodeGraph, "upload", refuse)
    for _ in range(3):
        eng._decode_step()
    assert eng.stats["h2d_transfers"] == transfers
    assert eng.stats["sched_syncs"] == syncs
    assert all(len(r.generated) == 1 + 4 * 4 for r in reqs)
    # lengths advanced on the device exactly as the host mirror did
    np.testing.assert_array_equal(eng._decode_graph.lengths.numpy(),
                                  eng.lengths)


def test_admission_event_triggers_exactly_one_resync():
    eng = _engine(max_batch=4, max_seq=256, decode_steps_per_pass=4)
    _admit(eng, [[7, 8, 9]], temperature=0.0, max_new_tokens=200)
    for _ in range(3):
        eng._decode_step()
    syncs = eng.stats["sched_syncs"]
    new = _admit(eng, [[4, 5, 6]], temperature=0.0, max_new_tokens=200)
    eng._decode_step()            # admission -> one resync
    assert eng.stats["sched_syncs"] == syncs + 1
    eng._decode_step()            # the fresh row feeds back on the device
    assert eng.stats["sched_syncs"] == syncs + 1
    assert len(new[0].generated) == 1 + 2 * 4


def _converted_tiny():
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny(), "cpu")
    return jparams, tparams


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_multi_pass_greedy_identical_and_matches_jax(kv_dtype):
    jparams, tparams = _converted_tiny()
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 20, 40)]
    n_new = 37
    common = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
                  decode_steps_per_pass=4, prefix_cache=False,
                  kv_dtype=kv_dtype)
    ports = {}
    for m in (1, 4):
        eng = llama_engine(tparams, LlamaConfig.tiny(), EngineConfig(
            decode_passes_per_dispatch=m, **common), device="cpu")
        ports[m] = (_serve(eng, prompts, SamplingParams(
            temperature=0.0, max_new_tokens=n_new)), eng)
    jeng = jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                        compile_cache_dir=None, decode_passes_per_dispatch=4,
                        **common),
        implementation="xla")
    want = _serve(jeng, prompts, JaxSamplingParams(temperature=0.0,
                                                   max_new_tokens=n_new))
    (one, eng1), (four, eng4) = ports[1], ports[4]
    assert [r.generated for r in four] == [r.generated for r in one]
    assert eng4.stats["decode_passes"] < eng1.stats["decode_passes"]
    assert [r.generated for r in four] == [r.generated for r in want]
    assert all(len(r.generated) == n_new for r in four)
    for g, w in zip(four, want):
        assert request_digest(g.prompt_tokens, g.params, g.generated) == \
            request_digest(w.prompt_tokens, w.params, w.generated)
        # the digest each engine stamped itself at the request's end
        assert g.digest is not None and g.digest == w.digest
    assert sorted(eng4._free_pages) == list(range(eng4._n_pages))


def test_multi_pass_respects_max_seq_ceiling():
    # a 31-token prompt (39 clamped to leave half of max_seq to generate)
    # and a 100-token budget: the slot runs into max_seq = 64 in the
    # middle of a 16-step dispatch
    prompt = list(range(1, 40))
    got = {}
    for m in (1, 4):
        eng = _engine(max_batch=2, max_seq=64, page_size=16,
                      decode_steps_per_pass=4, decode_passes_per_dispatch=m)
        req, = _serve(eng, [prompt], SamplingParams(temperature=0.0,
                                                    max_new_tokens=100))
        got[m] = req.generated
        # the last token is sampled from the row at max_seq - 1, never
        # stored; the slot retired and gave its pages back
        assert len(req.prompt_tokens) + len(req.generated) == 64 + 1
        assert eng.active == [None, None]
        assert len(eng._free_pages) + eng._cached_pages >= eng._n_pages - 1
    assert got[4] == got[1]


def _slot_pages(pool, table):
    leaves = list(pool.values()) if isinstance(pool, dict) else [pool]
    pages = [int(p) for p in table if p < tkv.pool_shape(pool)[2]]
    return [leaf[:, :, pages].clone() for leaf in leaves]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_mid_walk_slot_pages_are_untouched_by_a_decode_dispatch(kv_dtype):
    # max_seq 100 is not a multiple of the 16-row page: the JAX engine's
    # length sentinel (max_seq) would land inside the walker's last page
    eng = _engine(max_batch=2, max_seq=100, page_size=16,
                  prefill_buckets=(16,), prefill_chunks_per_pass=1,
                  decode_steps_per_pass=4, decode_passes_per_dispatch=2,
                  prefix_cache=False, kv_dtype=kv_dtype)
    rng = np.random.default_rng(22)
    short, long_ = rng.integers(0, 256, 9).tolist(), \
        rng.integers(0, 256, 60).tolist()
    greedy = dict(temperature=0.0, max_new_tokens=30)
    decoding, = _admit(eng, [short], **greedy)
    walker, = _admit(eng, [long_], **greedy)     # one 16-row chunk
    assert walker.pending_prefill and not decoding.pending_prefill
    assert walker.prefill_offset == 16
    table = eng._tables[walker.slot].copy()
    before = [_slot_pages(p, table) for p in (eng.k_cache, eng.v_cache)]
    n0 = len(decoding.generated)
    eng._decode_step()
    assert len(decoding.generated) == n0 + 8
    after = [_slot_pages(p, table) for p in (eng.k_cache, eng.v_cache)]
    for b_pool, a_pool in zip(before, after):
        for b, a in zip(b_pool, a_pool):
            assert torch.equal(a, b)
    # the walk then finishes and the walker decodes to its budget
    while walker.pending_prefill:
        eng._admit()              # the walk resumes from the requeued lane
    while eng.active[walker.slot] is not None:
        eng._decode_step()
    assert len(walker.generated) == 30


def test_sample_batch_all_greedy_flag_matches_the_inferred_one():
    rng = np.random.default_rng(23)
    logits = torch.from_numpy((rng.standard_normal((5, 300)) * 3)
                              .astype(np.float32))
    noise = torch.from_numpy(rng.uniform(1e-20, 1.0, (5, TOPK_BOUND))
                             .astype(np.float32))
    top_ps = torch.tensor([1.0, 0.9, 0.5, 1.0, 0.8])
    top_ks = torch.tensor([0, 0, 5, 10, 3])
    greedy = torch.zeros(5)
    mixed = torch.tensor([0.0, 0.7, 1.0, 0.0, 1.3])
    want_greedy = sample_batch(logits, greedy, top_ps, top_ks, uniform=noise)
    want_mixed = sample_batch(logits, mixed, top_ps, top_ks, uniform=noise)
    assert want_greedy.tolist() == logits.argmax(-1).tolist()
    for flag in (True, False):
        got = sample_batch(logits, greedy, top_ps, top_ks, uniform=noise,
                           all_greedy=flag)
        assert got.tolist() == want_greedy.tolist()
    got = sample_batch(logits, mixed, top_ps, top_ks, uniform=noise,
                       all_greedy=False)
    assert got.tolist() == want_mixed.tolist()


def _jax_pool(form, rng, shape):
    pool = rng.standard_normal(shape).astype(np.float32)
    return (jkv.quantize_pool(jnp.asarray(pool)) if form == "int8"
            else jnp.asarray(pool))


def _leaves(pool):
    return [pool[k] for k in tkv.QUANT_KEYS] if isinstance(pool, dict) \
        else [pool]


def _to_torch(pool):
    if isinstance(pool, dict):
        return {k: torch.from_numpy(np.array(pool[k])) for k in tkv.QUANT_KEYS}
    return torch.from_numpy(np.array(pool))


def _assert_same(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("form", ["plain", "int8"])
@pytest.mark.parametrize("shape", ["decode", "chunk"])
def test_plain_writes_drop_out_of_range_rows_like_jax(form, shape):
    # page ids 6 (= Np, unallocated) and 11 are out of range: dropped
    rng = np.random.default_rng(24)
    n_pages, hkv, hd = 6, 2, 16
    jk = _jax_pool(form, rng, (2, hkv, n_pages, 8, hd))
    jv = _jax_pool(form, rng, (2, hkv, n_pages, 8, hd))
    if shape == "decode":
        pids = np.array([4, 6, 0, 11], np.int32)
        offs = np.array([7, 1, 0, 3], np.int32)
    else:
        pids = np.array([[1, 1, 6], [11, 2, 3]], np.int32)
        offs = np.array([[2, 3, 0], [0, 5, 7]], np.int32)
    k_rows = rng.standard_normal((*pids.shape, hkv, hd)).astype(np.float32)
    v_rows = rng.standard_normal((*pids.shape, hkv, hd)).astype(np.float32)
    args = [jnp.asarray(a) for a in (pids, offs)]
    want_k = jkv.pool_write(jk, 1, *args, jnp.asarray(k_rows))
    want_v = jkv.pool_write(jv, 1, *args, jnp.asarray(v_rows))
    targs = [torch.from_numpy(a) for a in (pids, offs)]
    got_k = tkv.pool_write(_to_torch(jk), 1, *targs, torch.from_numpy(k_rows))
    _assert_same(got_k, want_k)
    got_k, got_v = tkv.kv_write(_to_torch(jk), _to_torch(jv), 1, *targs,
                                torch.from_numpy(k_rows),
                                torch.from_numpy(v_rows))
    _assert_same(got_k, want_k)
    _assert_same(got_v, want_v)
    # the in-range rows landed
    changed = (_leaves(got_v)[0].numpy() != np.asarray(_leaves(jv)[0])).any(
        axis=(0, 1, 4))
    assert 0 < changed.sum() <= (pids < n_pages).sum()


def test_the_cycle_collector_waits_until_a_capture_ends(monkeypatch):
    # a dead engine's CUDA graphs freed by the cycle collector inside
    # another engine's capture: CUDA refuses the teardown while a
    # stream captures, and the capture is invalidated. So _capture
    # collects dead cycles first and holds the collector off until the
    # capture ends (the capture machinery is faked here, on the CPU)
    import contextlib
    import gc
    eng = _engine()
    inside, collected = [], []

    class FakeGraph:
        def register_generator_state(self, generator):
            pass

    class FakeStream:
        def __init__(self, *args):
            pass

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def capture(graph, pool=None, capture_error_mode=None):
        inside.append(gc.isenabled())
        yield

    real_collect = gc.collect
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *args: FakeStream())
    monkeypatch.setattr(gc, "collect",
                        lambda *args: collected.append(1) or real_collect())
    assert gc.isenabled()
    for greedy in (True, False):
        eng._decode_graph._capture(eng.k_cache, eng.v_cache, greedy)
    assert collected and inside == [False, False]
    assert gc.isenabled()
    assert eng._decode_graph.captures == 2
