"""The port's engine against the JAX engine, and the port's HTTP app,
on the CPU at the tiny config.

Both engines serve the same converted weights on the paged layout.
Without the prefix cache (the JAX one with ``paged_attention="xla"``),
four concurrent greedy prompts within the widest bucket must give
identical tokens and an equal ``integrity.request_digest`` per
request. With it (the JAX one with ``paged_attention="interpret"``,
its Pallas kernels interpreted, and a single 16-row bucket so that
longer prompts walk in chunks), a second wave whose prompts share
page-aligned prefixes with the first must also give equal
``prefix_hits``. With speculation (the JAX one with
``paged_attention="interpret"``, ``spec_adaptive=False``), a repetitive
prompt must give identical tokens, ``request_digest`` and spec counters,
and a second wave identical tokens. On a 3-page pool both engines must
preempt and recompute alike. Page accounting, LRU eviction, the
speculative path's page growth, oracle drafts, mixed greedy and
sampled batches and speculative-vs-plain tokens are checked on the port
alone.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.integrity import request_digest
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving.app import build_engine, build_server
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.spec import build_draft_tree

torch.set_num_threads(2)


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, size=n).tolist() for n in (5, 20, 40, 70)]


def _run(engine, prompts, params, *waves):
    """Serve ``prompts``, then each later wave once the one before it
    has finished; all requests of all waves, in order."""
    engine.start()
    reqs = []
    try:
        for wave in (prompts, *waves):
            batch = [engine.submit(p, params) for p in wave]
            deadline = time.time() + 120
            while time.time() < deadline and any(
                    r.finished_at is None and r.error is None
                    for r in batch):
                time.sleep(0.005)
            reqs += batch
    finally:
        engine.stop()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    assert all(r.finished_at is not None for r in reqs)
    return reqs


def _converted_tiny():
    jparams = jax_llama_init(jax.random.key(0), JaxLlamaConfig.tiny())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny(), "cpu")
    return jparams, tparams


def _assert_same_requests(got, want, n_new):
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == n_new for r in got)
    for g, w in zip(got, want):
        assert g.prompt_tokens == w.prompt_tokens
        assert request_digest(g.prompt_tokens, g.params, g.generated) == \
            request_digest(w.prompt_tokens, w.params, w.generated)
        # the digest each engine stamped itself at the request's end
        assert g.digest is not None and g.digest == w.digest


def test_engine_greedy_matches_jax_engine():
    jparams, tparams = _converted_tiny()
    prompts = _prompts()
    common = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
                  decode_steps_per_pass=4)
    jeng = jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", prefix_cache=False,
                        paged_attention="xla", compile_cache_dir=None,
                        **common),
        implementation="xla")
    teng = llama_engine(tparams, LlamaConfig.tiny(),
                        EngineConfig(prefix_cache=False, **common),
                        device="cpu")
    want = _run(jeng, prompts,
                JaxSamplingParams(temperature=0.0, max_new_tokens=13))
    got = _run(teng, prompts,
               SamplingParams(temperature=0.0, max_new_tokens=13))
    _assert_same_requests(got, want, 13)
    # every page went back to the free list
    assert sorted(teng._free_pages) == list(range(teng._n_pages))


def _second_wave(first):
    """Prompts that share page-aligned (16-row) prefixes with the first
    wave's 20-, 40- and 70-token prompts (hits of 16, 32 and 64 rows),
    and one that shares nothing."""
    rng = np.random.default_rng(12)
    tail = [rng.integers(0, 256, size=n).tolist() for n in (10, 12, 20, 30)]
    return [first[1][:16] + tail[0], first[2][:35] + tail[1],
            first[3][:66] + tail[2], tail[3]]


def test_engine_prefix_cache_and_chunk_walk_match_jax_engine():
    jparams, tparams = _converted_tiny()
    first = _prompts()
    second = _second_wave(first)
    common = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
                  decode_steps_per_pass=4, prefill_batch=4,
                  prefill_buckets=(16,), prefix_cache=True)
    jeng = jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="interpret",
                        compile_cache_dir=None, **common),
        implementation="xla")
    teng = llama_engine(tparams, LlamaConfig.tiny(), EngineConfig(**common),
                        device="cpu")
    want = _run(jeng, first,
                JaxSamplingParams(temperature=0.0, max_new_tokens=13),
                second)
    got = _run(teng, first,
               SamplingParams(temperature=0.0, max_new_tokens=13), second)
    _assert_same_requests(got, want, 13)
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 3
    # every page is free or pinned by the cache, and each pinned page
    # holds one reference per entry that lists it
    pinned = [p for pages in teng._prefix_cache.values() for p in pages]
    assert len(teng._free_pages) + len(set(pinned)) == teng._n_pages
    assert sorted(set(teng._free_pages) | set(pinned)) == \
        list(range(teng._n_pages))
    refs = np.bincount(pinned, minlength=teng._n_pages)
    np.testing.assert_array_equal(teng._page_refs, refs)


def test_prefix_cache_evicts_least_recently_used_first():
    # 10 pages of 8 rows, one slot: A and B each pin 2 pages; a hit on A
    # makes B the least recently used, so the 7-page request C evicts B
    # and A survives
    teng = build_engine(LlamaConfig.tiny(), device="cpu",
                        engine_config=EngineConfig(
                            max_batch=1, max_seq=64, page_size=8,
                            kv_pages=10, prefix_cache_pages=10, seed=0))
    rng = np.random.default_rng(13)
    a, b, c = (rng.integers(0, 256, size=n).tolist() for n in (17, 17, 50))
    greedy = SamplingParams(temperature=0.0, max_new_tokens=2)
    teng.start()
    try:
        for prompt in (a, b, a[:16] + [1, 2, 3]):
            assert teng.submit_sync(prompt, greedy, 60).error is None
        assert teng.stats["prefix_hits"] == 1
        assert list(teng._prefix_cache) == [tuple(b[:16]), tuple(a[:16])]
        assert teng.submit_sync(c, greedy, 60).error is None
    finally:
        teng.stop()
    assert teng.stats["prefix_evictions"] == 1
    assert tuple(a[:16]) in teng._prefix_cache
    assert tuple(b[:16]) not in teng._prefix_cache
    pinned = {p for pages in teng._prefix_cache.values() for p in pages}
    assert len(teng._free_pages) + len(pinned) == teng._n_pages


def _serve_queued(engine, prompts, params):
    """Queue every prompt, then start: one admission batch, so that
    page growth and preemption happen at the same points in both
    engines."""
    reqs = [engine.submit(p, params) for p in prompts]
    engine.start()
    try:
        deadline = time.time() + 120
        while time.time() < deadline and any(
                r.finished_at is None and r.error is None for r in reqs):
            time.sleep(0.005)
    finally:
        engine.stop()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return reqs


def test_engine_preempts_like_the_jax_engine_when_the_pool_is_dry():
    # 3 pages of 8 rows: both 3-token prompts are admitted with one page
    # each, and the first 8-step dispatch needs two each, so the younger
    # request is preempted and recomputed from prompt + generated, as in
    # the JAX engine: same tokens, digests, preemptions and requeues
    jparams, tparams = _converted_tiny()
    common = dict(max_batch=2, max_seq=64, page_size=8, kv_pages=3, seed=0)
    jeng = jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                        compile_cache_dir=None, **common),
        implementation="xla")
    teng = llama_engine(tparams, LlamaConfig.tiny(), EngineConfig(**common),
                        device="cpu")
    prompts = [[1, 2, 3], [4, 5, 6]]
    want = _serve_queued(jeng, prompts,
                         JaxSamplingParams(temperature=0.0, max_new_tokens=9))
    got = _serve_queued(teng, prompts,
                        SamplingParams(temperature=0.0, max_new_tokens=9))
    _assert_same_requests(got, want, 9)
    for key in ("preemptions", "requeues"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["preemptions"] > 0
    assert got[1].prompt_tokens[:3] == [4, 5, 6]   # recomputed with its tokens
    # an id outside the vocabulary fails at submit
    bad = teng.submit([300], SamplingParams(max_new_tokens=2))
    assert bad.error and bad.done.is_set()


# a strongly repetitive prompt: prompt-lookup drafting engages on it
PATTERN = [11, 22, 33, 44] * 12


def _wait(reqs, timeout_s=120):
    deadline = time.time() + timeout_s
    while time.time() < deadline and any(
            r.finished_at is None and r.error is None for r in reqs):
        time.sleep(0.005)
    assert all(r.error is None and r.finished_at is not None for r in reqs)


def test_speculative_engine_matches_jax_engine():
    jparams, tparams = _converted_tiny()
    common = dict(max_batch=2, max_seq=128, page_size=16, seed=0,
                  decode_steps_per_pass=4, prefix_cache=False,
                  speculative=True, spec_adaptive=False, spec_ngram=1)
    jeng = jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="interpret",
                        compile_cache_dir=None, **common),
        implementation="xla")
    teng = llama_engine(tparams, LlamaConfig.tiny(), EngineConfig(**common),
                        device="cpu")
    second = [[5, 6, 7] * 9, [40, 41, 42, 43, 44] * 6]
    got = {}
    for name, eng, params in (
            ("jax", jeng, JaxSamplingParams(temperature=0.0,
                                            max_new_tokens=24)),
            ("port", teng, SamplingParams(temperature=0.0,
                                          max_new_tokens=24))):
        eng.start()
        try:
            one = [eng.submit(PATTERN, params)]
            _wait(one)
            counters = {k: eng.stats[k] for k in
                        ("spec_passes", "spec_drafted", "spec_accepted")}
            wave = [eng.submit(p, params) for p in second]
            _wait(wave)
        finally:
            eng.stop()
        got[name] = (one + wave, counters)
    (want, jcount), (have, tcount) = got["jax"], got["port"]
    _assert_same_requests(have, want, 24)
    assert tcount == jcount
    assert tcount["spec_drafted"] > 0 and tcount["spec_accepted"] > 0
    assert sorted(teng._free_pages) == list(range(teng._n_pages))


def test_speculative_engine_at_the_cache_ceiling_matches_jax_plain_decode():
    # 31 prompt tokens (the 48-token pattern, clamped to leave half of
    # max_seq = 64 to generate) and a 40-token budget: the request runs
    # into the ceiling after 34 tokens, and 9-node draft trees (depth 4,
    # 2 branches) reach it; every verify pass must keep its tree's rows
    # below max_seq, and the greedy tokens must be plain decode's
    jparams, tparams = _converted_tiny()
    common = dict(max_batch=2, max_seq=64, page_size=16, seed=0,
                  decode_steps_per_pass=4, prefix_cache=False)
    jeng = jax_llama_engine(
        jparams, JaxLlamaConfig.tiny(),
        JaxEngineConfig(kv_layout="paged", paged_attention="interpret",
                        compile_cache_dir=None, **common),
        implementation="xla")
    teng = llama_engine(tparams, LlamaConfig.tiny(), EngineConfig(
        speculative=True, spec_adaptive=False, spec_ngram=1, **common),
        device="cpu")
    verify, rows_end = teng._verify_fn, []

    def checked(params, tokens, k_pool, v_pool, tables, offsets, lens,
                **tree):
        for off, n in zip(offsets.tolist(), lens.tolist()):
            rows_end.append(off + n)
            assert off + n <= teng.config.max_seq, \
                f"tree rows {off}..{off + n - 1} pass max_seq"
        return verify(params, tokens, k_pool, v_pool, tables, offsets, lens,
                      **tree)

    teng._verify_fn = checked
    prompts = [PATTERN, [5, 6, 7] * 16]
    want = _run(jeng, prompts,
                JaxSamplingParams(temperature=0.0, max_new_tokens=40))
    got = _run(teng, prompts,
               SamplingParams(temperature=0.0, max_new_tokens=40))
    assert [r.generated for r in got] == [r.generated for r in want]
    # the last token is sampled from the row at max_seq - 1, never stored
    assert all(len(r.prompt_tokens) + len(r.generated) == 65 for r in got)
    assert teng.stats["spec_drafted"] > 0
    assert max(rows_end) == teng.config.max_seq   # a tree reached it
    assert sorted(teng._free_pages) == list(range(teng._n_pages))


def _plain_and_spec(prompts, n_new, **spec_kw):
    out = []
    for spec in (False, True):
        cfg = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
                   decode_steps_per_pass=4, prefix_cache=False)
        if spec:
            cfg.update(speculative=True, **spec_kw)
        eng = build_engine(LlamaConfig.tiny(), device="cpu",
                           engine_config=EngineConfig(**cfg))
        reqs = _run(eng, prompts,
                    SamplingParams(temperature=0.0, max_new_tokens=n_new))
        out.append(([r.generated for r in reqs], eng))
    return out


def test_speculative_tokens_equal_plain_tokens():
    # repetitive and random prompts, concurrent; adaptive controller on
    # (default), 1-gram lookup and 4-branch trees so drafts engage often
    rng = np.random.default_rng(14)
    prompts = [PATTERN, [9, 8, 7, 6, 5] * 7, rng.integers(0, 256, 30).tolist(),
               [3, 1, 4, 1, 5, 9, 2, 6] * 4]
    (plain, _), (spec, eng) = _plain_and_spec(prompts, 21, spec_ngram=1,
                                              spec_branches=4)
    assert spec == plain
    assert eng.stats["spec_passes"] > 0 and eng.stats["spec_drafted"] > 0
    assert eng.stats["spec_rows"] >= eng.stats["spec_passes"]
    assert sorted(eng._free_pages) == list(range(eng._n_pages))


def _oracle(engine, futures, decoy=True):
    """A drafting hook that proposes each request's true continuation
    (at the depth the budget allows) plus, with ``decoy``, a wrong
    branch of the same depth."""
    def draft(req):
        done = len(req.generated)
        depth = min(engine.config.spec_draft,
                    req.params.max_new_tokens - done - 1)
        if depth <= 0:
            return []
        true = futures[tuple(req.prompt_tokens)][done:done + depth]
        chains = [true] + ([[(t + 1) % 256 for t in true]] if decoy else [])
        return build_draft_tree(req.generated[-1], chains)
    return draft


def test_oracle_draft_is_accepted_with_fewer_passes():
    n = 24
    (vanilla, _), = [_plain_and_spec([PATTERN], n)[0]]
    eng = build_engine(LlamaConfig.tiny(), device="cpu",
                       engine_config=EngineConfig(
                           max_batch=2, max_seq=128, page_size=16, seed=0,
                           speculative=True))
    eng._draft_proposals = _oracle(eng, {tuple(PATTERN): vanilla[0]},
                                   decoy=False)
    reqs = _run(eng, [PATTERN], SamplingParams(temperature=0.0,
                                               max_new_tokens=n))
    assert reqs[0].generated == vanilla[0]
    assert eng.stats["spec_accepted"] == eng.stats["spec_drafted"] > 0
    # every pass lands spec_draft + 1 tokens
    assert eng.stats["spec_passes"] <= 2 + n // (eng.config.spec_draft + 1)
    assert eng.stats["decode_passes"] == 0


def test_verify_rows_land_in_pages_the_slot_owns():
    # 48-token prompts, 16 new tokens, 16-row pages: a life of exactly 4
    # pages, but a 2-branch depth-4 tree near the end writes rows past
    # prompt + max_new_tokens; each verify pass grows the slot's table
    # over every fed tree row first (5 pages each at the end), and the
    # 10-page pool holds both requests at once with no page to spare
    prompts = [PATTERN, [50, 60, 70] * 16]
    (vanilla, _), = [_plain_and_spec(prompts, 16)[0]]
    eng = build_engine(LlamaConfig.tiny(), device="cpu",
                       engine_config=EngineConfig(
                           max_batch=2, max_seq=128, page_size=16, seed=0,
                           kv_pages=10, prefix_cache=False, speculative=True))
    eng._draft_proposals = _oracle(
        eng, {tuple(p): v for p, v in zip(prompts, vanilla)})
    verify, pg, seen = eng._verify_fn, 16, []

    def checked(params, tokens, k_pool, v_pool, tables, offsets, lens,
                **tree):
        for row, (off, n) in enumerate(zip(offsets.tolist(), lens.tolist())):
            for pos in range(off, off + n):
                pid = int(tables[row, pos // pg])
                seen.append(pos)
                assert pid < eng._n_pages, f"row {pos} on an unallocated page"
                assert pid not in eng._free_pages
                assert eng._page_refs[pid] == 1
                assert (eng._tables == pid).sum() == 1   # this slot's only
        return verify(params, tokens, k_pool, v_pool, tables, offsets, lens,
                      **tree)

    eng._verify_fn = checked
    reqs = _run(eng, prompts, SamplingParams(temperature=0.0,
                                             max_new_tokens=16))
    assert [r.generated for r in reqs] == vanilla
    assert max(seen) >= 48 + 16         # past the 4 pages of a life
    assert sorted(eng._free_pages) == list(range(eng._n_pages))


def test_mixed_greedy_and_sampled_batch_keeps_budgets():
    # a sampled request shares the batch with a drafting greedy one:
    # verify and decode passes alternate, both finish with exact
    # budgets, and the greedy one matches plain decode
    (vanilla, _), = [_plain_and_spec([PATTERN], 16)[0]]
    eng = build_engine(LlamaConfig.tiny(), device="cpu",
                       engine_config=EngineConfig(
                           max_batch=2, max_seq=128, page_size=16, seed=0,
                           decode_steps_per_pass=4, prefix_cache=False,
                           speculative=True, spec_ngram=1))
    eng.start()
    try:
        greedy = eng.submit(PATTERN, SamplingParams(temperature=0.0,
                                                    max_new_tokens=16))
        sampled = eng.submit(np.random.default_rng(1).integers(
            3, 200, size=20).tolist(), SamplingParams(temperature=0.9,
                                                       max_new_tokens=16))
        _wait([greedy, sampled])
    finally:
        eng.stop()
    assert greedy.generated == vanilla[0]
    assert len(sampled.generated) == 16
    assert eng.stats["spec_passes"] > 0 and eng.stats["decode_passes"] > 0
    assert sorted(eng._free_pages) == list(range(eng._n_pages))


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_app_serves_chat_and_health_on_cpu():
    # the byte tokenizer's specials (bos = 257) need a 260-token vocab
    engine = build_engine(LlamaConfig.tiny().scaled(vocab_size=260),
                          device="cpu", engine_config=EngineConfig(
                              max_batch=2, max_seq=128, seed=0))
    server = build_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    engine.start()
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, health = _http(base + "/.well-known/health")
        assert status == 200 and health["data"]["status"] == "UP"
        status, out = _http(base + "/chat", {"prompt": "hello there",
                                             "max_tokens": 5,
                                             "temperature": 0})
        assert status == 201
        data = out["data"]
        assert len(data["tokens"]) == 5
        assert data["usage"]["prompt_tokens"] == len("hello there") + 1
        assert data["usage"]["completion_tokens"] == 5
        assert isinstance(data["text"], str)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_timed_out_chat_is_cancelled_and_frees_its_slot():
    # the engine loop is not started: the test admits the request by hand
    # while the handler waits, so it holds a slot and pages when its wait
    # times out; the 504 must cancel it, and the next dispatch retire it
    # with its pages back on the free list, not decode it to max_tokens
    engine = build_engine(LlamaConfig.tiny().scaled(vocab_size=260),
                          device="cpu", engine_config=EngineConfig(
                              max_batch=2, max_seq=128, seed=0))
    server = build_server(engine, port=0)
    server.request_timeout_s = 3.0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/chat"
    answer = {}

    def ask():
        try:
            answer["ok"] = _http(url, {"prompt": "hello there",
                                       "max_tokens": 64, "temperature": 0})
        except urllib.error.HTTPError as exc:
            answer["status"] = exc.code
            answer["body"] = json.loads(exc.read())

    client = threading.Thread(target=ask)
    try:
        client.start()
        deadline = time.time() + 30
        while not engine.waiting.qsize() and time.time() < deadline:
            time.sleep(0.005)
        engine._admit()                  # prefilled: a slot, pages, 1 token
        req = next(r for r in engine.active if r is not None)
        assert not answer, "the handler answered before its timeout"
        assert engine.active[req.slot] is req
        assert engine._slot_pages[req.slot] > 0 and req.generated
        client.join(timeout=30)
        assert answer.get("status") == 504, answer
        assert answer["body"]["error"]["message"] == "generation timed out"
        assert req.cancelled and not req.done.is_set()
        engine._decode_step()            # the sweep retires the slot
        assert req.done.is_set() and req.finished_at is not None
        assert all(r is None for r in engine.active)
        assert len(req.generated) == 1  # nothing decoded after the 504
        # the books balance: every page free, none held or referenced (a
        # cancelled request registers no prefix)
        assert sorted(engine._free_pages) == list(range(engine._n_pages))
        assert not engine._slot_pages.any() and not engine._page_refs.any()
        assert not engine._prefix_cache
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        client.join(timeout=10)
