"""Continuous-batching inference engine on the paged KV pool
(counterpart of ``gofr_tpu/serving/engine.py``, paged layout with the
prefix cache, the chunk-with-history walk and speculative tree verify).

- One **engine thread** owns every device call; ``submit()`` only
  queues, from any thread.
- **Bucketed group prefill**: waiting prompts are grouped by the
  smallest prefill bucket that holds them and prefilled ``[P, bucket]``
  at a time, P the smallest power of two (or ``prefill_batch``) that
  fits the group; dummy rows carry length 1 and an all-OOB block table,
  so their K/V writes drop. One device call per group samples each
  row's first token and writes the prompt K/V into the page pool
  (``scatter_chunk``).
- **Chunk walk** (``_walk_chunks``): a prompt wider than every bucket,
  and the suffix of a prompt whose prefix the cache held, run through
  the chunk model function against the slot's history, ``[G, width]``
  per call with G in {1, ``prefill_batch``} and width the smallest
  bucket covering what is left (the widest when none does); pad rows
  carry an all-OOB table, offset 0 and chunk length 0. At most
  ``prefill_chunks_per_pass`` rounds run per loop iteration, so the
  other slots decode between the chunks of a long prompt; the first
  token is sampled from the final chunk.
- **Pages**: a host-side free list with a reference count per page
  (slots and the prefix cache each hold one). A request is admitted
  only when the pool can hold its whole life — ``min(prompt +
  max_new_tokens, max_seq)`` rows — and its references drop on retire.
  When the pool is dry, cached prefixes are evicted (least recently
  used first), then the request waits for a retire; nothing is
  preempted.
- **Prefix cache**: at retire, a request's page-aligned prompt prefix
  stays pinned under its token ids (at most ``prefix_cache_pages``
  pages). A later prompt that starts with a cached prefix (leaving at
  least one token to compute) attaches those pages to its table and
  walks only the rest.
- **Decode dispatches** of T = ``decode_steps_per_pass`` (K) x
  ``decode_passes_per_dispatch`` (M) steps over every slot (row = slot,
  ``max_batch`` rows; ``decode_graph.DecodeGraph``): each step writes
  one K/V row per decoding slot through its table (other rows' writes
  are dropped on the card), attends with the paged decode kernel and
  samples; sampled tokens feed the next step on the device, and the
  host reads the T tokens once per dispatch. The per-slot state lives
  on the device and is uploaded only when an event changes it
  (admission, a first token, a retirement, a speculative pass, a table
  change: ``stats["sched_syncs"]``, ``stats["h2d_transfers"]``); on CUDA
  a dispatch is one CUDA graph replay (``stats["graph_captures"]``,
  ``stats["graph_replays"]``; the first dispatch of each kind captures,
  and ``decode_s`` includes ``stats["graph_capture_s"]``). Slots retire
  on eos, on ``max_new_tokens`` or at the ``max_seq`` ceiling, exactly
  as the JAX engine counts them.
- **Speculative tree verify** (``speculative``, off by default): before
  each pass every greedy decoding slot drafts by prompt lookup (its
  request's ``NgramIndex`` proposes up to ``spec_branches``
  continuations of the stream's last ``spec_ngram`` tokens, trie-merged
  into one ``DraftTree``; the ``SpecController`` prices the depth). When
  every decoding slot drafted — or, in a mixed batch, every other pass —
  one verify pass feeds each slot's tree (a lone root for a slot that
  did not draft) through the paged tree kernel at a pow-2 width,
  accepts the longest root-to-leaf path whose tokens the model predicts
  greedily (``resolve_tree``), compacts that path's K/V rows
  (``path_moves`` + ``pool_move_rows``) and emits the accepted tokens
  plus one bonus token sampled at the deepest accepted node. A request
  reserves ``spec_draft * spec_branches`` rows more than its life, so
  every tree row lands in a page it owns.
- **KV pool form** (``kv_dtype``): the model's dtype (``"bf16"``), or
  ``"int8"``: codes plus one float32 scale per row, quantized on every
  write and read by the int8 branches of the paged kernels. The pool is
  sized by bytes, as in the JAX engine: ``kv_pool_bytes``, or by default
  what ``kv_pages`` (or the full capacity) costs in the model's dtype,
  so an int8 pool holds about twice the pages in the same memory.

Left out (see ROADMAP.md Queue A): preemption and lazy page growth,
decode windows, pipelined dispatch/collect, and the SLO / events /
integrity / observability / goodput / cost planes (so the speculative
path keeps only the stats below).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..ops.paged_kv import (KV_DTYPES, pool_move_rows, pool_row_bytes,
                            scatter_chunk)
from .decode_graph import DecodeGraph
from .sampling import sample_batch
from .spec import (MAX_TREE_NODES, DraftTree, NgramIndex, SpecController,
                   build_draft_tree)


@dataclass
class SamplingParams:
    temperature: float = 0.7
    top_p: float = 1.0
    #: 0 disables the explicit top-k filter; stochastic sampling is
    #: always bounded to the TOPK_BOUND (64) most likely tokens
    top_k: int = 0
    max_new_tokens: int = 128


@dataclass
class GenRequest:
    prompt_tokens: list[int]
    params: SamplingParams
    submitted_at: float = field(default_factory=time.time)
    first_token_at: float | None = None
    finished_at: float | None = None
    slot: int = -1
    #: every token id emitted for this request, the prefill's first
    #: token included
    generated: list[int] = field(default_factory=list)
    #: prompt rows already in the cache: an attached prefix, then each
    #: chunk of the walk
    prefill_offset: int = 0
    #: True while the prompt is walked chunk by chunk (no decode yet)
    pending_prefill: bool = False
    #: prompt-lookup index over prompt + generated (speculation only)
    spec_index: NgramIndex | None = None
    error: str | None = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def ttft_ms(self) -> float | None:
        if self.first_token_at is None:
            return None
        return (self.first_token_at - self.submitted_at) * 1000.0


@dataclass
class EngineConfig:
    max_batch: int = 8          # decode slots
    max_seq: int = 1024         # per-slot kv capacity
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024)
    #: waiting requests prefilled per device call (largest group)
    prefill_batch: int = 8
    #: decode steps per pass (K)
    decode_steps_per_pass: int = 8
    #: K-step passes per decode dispatch (M): one dispatch (one CUDA
    #: graph replay) runs K x M steps with on-device token feedback and
    #: length advance, and the host reads the K x M tokens once.
    #: Admission, retirement and drafting happen between dispatches, so
    #: a large M trades scheduling granularity (and steps wasted past a
    #: finishing request's budget) for fewer dispatches; greedy tokens
    #: do not depend on it
    decode_passes_per_dispatch: int = 1
    eos_id: int = -1            # -1: never stop on eos
    #: sampling seed; None draws one from os.urandom
    seed: int | None = None
    #: rows per KV page
    page_size: int = 64
    #: pool size in pages; None = max_batch x ceil(max_seq / page_size)
    kv_pages: int | None = None
    #: KV page storage: "bf16" = the model's dtype; "int8" = int8 codes
    #: plus one float32 scale per row (hd + 4 bytes a row and head
    #: instead of 2 hd at bf16), quantized on write
    kv_dtype: str = "bf16"
    #: the pool's byte budget, K and V together; None = ``kv_pages`` (or
    #: the full capacity) at the model dtype's page cost, so an int8
    #: pool at the default budget holds about twice the pages
    kv_pool_bytes: int | None = None
    #: waiting requests beyond this fail at submit; 0 = unbounded
    max_waiting: int = 0
    #: chunk-walk rounds per loop iteration; unfinished walks resume
    #: after a decode pass of the other slots
    prefill_chunks_per_pass: int = 2
    #: pin retired prompts' page-aligned prefixes for reattachment
    prefix_cache: bool = True
    #: pages the prefix cache may pin; None = a quarter of the pool
    prefix_cache_pages: int | None = None
    #: speculative decoding: draft by prompt lookup and verify a draft
    #: tree in one pass; greedy outputs are those of plain decode, and
    #: sampled slots never accept drafts (their bonus token samples with
    #: their own params)
    speculative: bool = False
    #: max draft depth verified per pass
    spec_draft: int = 4
    #: n-gram width the prompt lookup matches on
    spec_ngram: int = 3
    #: continuations drafted per pass, trie-merged into one tree
    #: (1 + spec_draft * spec_branches <= 32 nodes)
    spec_branches: int = 2
    #: price each slot's draft depth against fitted decode and verify
    #: costs; False = always full depth
    spec_adaptive: bool = True
    #: accept-rate EWMA under which a slot stops drafting (re-probed
    #: every spec_probe_interval passes)
    spec_accept_floor: float = 0.1
    #: passes between single-node probes of a disabled slot
    spec_probe_interval: int = 32


class Engine:
    """Continuous batching over (prefill_fn, paged_chunk_fn,
    paged_decode_fn) and, for speculation, paged_verify_fn.

    prefill_fn(params, tokens [P, S], kv_lengths [P]) -> (logits [P, V],
        (k, v) each [L, P, S, Hkv, hd]) — e.g. ``llama_prefill_last``.
    paged_chunk_fn(params, tokens [G, W], k_pool, v_pool, tables [G, Mp],
        offsets [G], chunk_lengths [G]) -> (logits [G, V] at each row's
        last valid position, k_pool, v_pool) — e.g.
        ``llama_prefill_chunk_paged``; pools are updated in place.
    paged_decode_fn(params, tokens [B], k_pool, v_pool, tables [B, Mp],
        lengths [B], active=[B] bool) -> (logits [B, V], k_pool, v_pool)
        — e.g. ``llama_decode_step_paged``; pools are updated in place,
        rows whose ``active`` is False write nothing; B = ``max_batch``.
    paged_verify_fn(params, tokens [B, W], k_pool, v_pool, tables [B, Mp],
        offsets [B], chunk_lengths [B], tree_depths=[B, W],
        tree_masks=[B, W]) -> (logits [B, W, V], k_pool, v_pool) — e.g.
        ``llama_prefill_chunk_paged`` in tree mode with all logits;
        needed only with ``speculative``.
    make_cache(n_pages, page, kv_dtype) -> (k_pool, v_pool) [L, Hkv, Np,
        pg, hd], plain for "bf16", ``{q, s}`` dicts for "int8" (e.g.
        ``make_pool``).
    vocab_size: prompts holding a token id outside [0, vocab_size) fail
        at submit (an out-of-range embedding index would fault on the
        device and take the engine thread down).
    """

    def __init__(self, params: Any, config: EngineConfig, *,
                 prefill_fn: Callable, paged_decode_fn: Callable,
                 paged_chunk_fn: Callable, make_cache: Callable,
                 device: str | torch.device, vocab_size: int,
                 paged_verify_fn: Callable | None = None) -> None:
        cfg = config
        if cfg.page_size < 1 or cfg.max_batch < 1 or cfg.max_seq < 2:
            raise ValueError("page_size, max_batch >= 1 and max_seq >= 2 "
                             "required")
        if cfg.decode_steps_per_pass < 1 or cfg.decode_passes_per_dispatch < 1:
            raise ValueError("decode_steps_per_pass and "
                             "decode_passes_per_dispatch must be >= 1")
        if cfg.spec_branches < 1:
            raise ValueError(f"spec_branches must be >= 1, got "
                             f"{cfg.spec_branches}")
        if 1 + cfg.spec_draft * cfg.spec_branches > MAX_TREE_NODES:
            raise ValueError(
                f"1 + spec_draft * spec_branches = "
                f"{1 + cfg.spec_draft * cfg.spec_branches} exceeds the "
                f"{MAX_TREE_NODES}-node packed ancestor bitmask; shrink "
                f"spec_draft or spec_branches")
        if not 0.0 < cfg.spec_accept_floor < 1.0:
            raise ValueError(f"spec_accept_floor must be in (0, 1), "
                             f"got {cfg.spec_accept_floor}")
        if cfg.spec_probe_interval < 1:
            raise ValueError(f"spec_probe_interval must be >= 1, got "
                             f"{cfg.spec_probe_interval}")
        if cfg.speculative and paged_verify_fn is None:
            raise ValueError("speculative needs a paged_verify_fn")
        if cfg.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                             f"{cfg.kv_dtype!r}")
        self.params = params
        self.config = cfg
        self.device = torch.device(device)
        self.vocab_size = vocab_size
        self._prefill_fn = prefill_fn
        self._decode_fn = paged_decode_fn
        self._chunk_fn = paged_chunk_fn
        self._verify_fn = paged_verify_fn
        #: mixed batches alternate verify and decode passes
        self._spec_toggle = True
        self._spec_ctrl = SpecController(
            cfg.max_batch, draft=cfg.spec_draft, branches=cfg.spec_branches,
            adaptive=cfg.spec_adaptive, accept_floor=cfg.spec_accept_floor,
            probe_interval=cfg.spec_probe_interval)
        #: request each controller slot's state belongs to: a new tenant
        #: starts from a fresh accept-rate EWMA
        self._spec_ctrl_owner: list = [None] * cfg.max_batch
        # buckets wider than the cache could not be written back
        self._usable_buckets = tuple(sorted(
            b for b in cfg.prefill_buckets if b <= cfg.max_seq)) \
            or (cfg.max_seq,)

        pg = cfg.page_size
        self._pages_per_slot = -(-cfg.max_seq // pg)
        self._make_cache = make_cache
        self._n_pages = self._sized_pool_pages(
            pg, cfg.kv_pages if cfg.kv_pages is not None
            else cfg.max_batch * self._pages_per_slot)
        self.k_cache, self.v_cache = make_cache(self._n_pages, pg,
                                                cfg.kv_dtype)
        self._free_pages = list(range(self._n_pages))
        #: per-slot ordered page ids; the OOB id n_pages = unallocated
        self._tables = np.full((cfg.max_batch, self._pages_per_slot),
                               self._n_pages, np.int32)
        self._slot_pages = np.zeros(cfg.max_batch, np.int64)
        #: references per page: each slot and each cache entry holding it
        self._page_refs = np.zeros(self._n_pages, np.int32)
        #: prompt prefix (token ids) -> its pages; insertion order is the
        #: LRU order (a hit re-inserts)
        self._prefix_cache: dict[tuple, list[int]] = {}
        #: cached key lengths -> entry count: a probe tests only these
        self._prefix_lens: dict[int, int] = {}
        #: pins the cache holds (entries may share pages)
        self._cached_pages = 0
        self._prefix_budget = (cfg.prefix_cache_pages
                               if cfg.prefix_cache_pages is not None
                               else max(1, self._n_pages // 4))
        self.lengths = np.zeros(cfg.max_batch, np.int32)
        self.active: list[GenRequest | None] = [None] * cfg.max_batch
        #: requests mid-walk, in admission order
        self._walkers: list[GenRequest] = []

        self.seed = (cfg.seed if cfg.seed is not None
                     else int.from_bytes(os.urandom(4), "little"))
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        #: T = K x M steps per decode dispatch, over every slot
        self._tokens_per_pass = (cfg.decode_steps_per_pass
                                 * cfg.decode_passes_per_dispatch)
        self._decode_graph = DecodeGraph(
            paged_decode_fn, params, rows=cfg.max_batch,
            max_pages=self._pages_per_slot, n_pages=self._n_pages,
            steps=self._tokens_per_pass, max_seq=cfg.max_seq,
            device=self.device, generator=self._generator)
        #: the device copies of the scheduler arrays / tables are stale
        self._sched_dirty = True
        self._tables_dirty = True
        #: the request each row decoded for in the last dispatch: its
        #: last token is on the device (``use_prev``)
        self._dev_last_reqs: list = [None] * cfg.max_batch

        self._waiting: deque[GenRequest] = deque()
        self._cv = threading.Condition()
        self._running = False
        self._thread: threading.Thread | None = None
        self._failed: str | None = None
        self._step_count = 0
        self.total_generated = 0
        self.stats = {"prefill_calls": 0, "prefill_s": 0.0,
                      "decode_passes": 0, "decode_s": 0.0,
                      "decode_tokens": 0, "prefix_hits": 0,
                      "prefix_evictions": 0, "spec_passes": 0,
                      "spec_s": 0.0, "spec_drafted": 0,
                      "spec_accepted": 0, "spec_rows": 0,
                      "sched_syncs": 0, "h2d_transfers": 0,
                      "graph_captures": 0, "graph_replays": 0,
                      "graph_capture_s": 0.0}

    def _sized_pool_pages(self, page: int, base_pages: int) -> int:
        """The pool's page count from its byte budget: ``kv_pool_bytes``
        when set, else ``base_pages`` at the model dtype's page cost,
        divided by the configured form's page cost (K + V, scales
        included). The bf16 default with no budget is ``base_pages``
        exactly."""
        cfg = self.config
        if cfg.kv_dtype == "bf16" and cfg.kv_pool_bytes is None:
            return max(1, int(base_pages))

        def page_bytes(kv_dtype):
            k_probe, _ = self._make_cache(1, page, kv_dtype)
            return 2 * page * pool_row_bytes(k_probe)

        budget = (cfg.kv_pool_bytes if cfg.kv_pool_bytes is not None
                  else base_pages * page_bytes("bf16"))
        return max(1, int(budget) // page_bytes(cfg.kv_dtype))

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Start the engine thread."""
        if self._running:
            return
        if self._failed:
            raise RuntimeError(f"engine crashed: {self._failed}")
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gofr-torch-engine")
        self._thread.start()

    def stop(self, join_timeout_s: float = 30.0) -> None:
        """Stop the thread; queued and active requests fail with
        "engine stopped"."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=join_timeout_s)
            if thread.is_alive():
                raise RuntimeError("engine thread did not stop within "
                                   f"{join_timeout_s} s")
        self._fail_all("engine stopped")

    def health_check(self) -> dict:
        status = "DOWN" if (self._failed or not self._running) else "UP"
        with self._cv:
            waiting = len(self._waiting)
        out = {"status": status,
               "active_slots": sum(r is not None for r in self.active),
               "waiting": waiting,
               "steps": self._step_count,
               "total_generated": self.total_generated}
        if self._failed:
            out["error"] = self._failed
        return out

    # -------------------------------------------------------------- submit
    def _clamp_prompt(self, tokens: list[int], max_new: int) -> list[int]:
        """Keep the tail of an over-long prompt, reserving room to
        generate. The chunk walk takes prompts wider than every bucket,
        so the cache is the only cap."""
        room = max(1, min(max_new, self.config.max_seq // 2))
        limit = max(1, self.config.max_seq - room - 1)
        return tokens[-limit:] if len(tokens) > limit else tokens

    def submit(self, prompt_tokens: list[int],
               params: SamplingParams | None = None) -> GenRequest:
        """Queue a request from any thread. Its ``done`` event is set
        when it retires or fails (``error`` set)."""
        params = params or SamplingParams()
        req = GenRequest(
            prompt_tokens=self._clamp_prompt(list(prompt_tokens),
                                             params.max_new_tokens),
            params=params)
        if not req.prompt_tokens:
            self._fail(req, "empty prompt")
            return req
        if not all(0 <= t < self.vocab_size for t in req.prompt_tokens):
            self._fail(req, f"prompt token outside the vocabulary "
                            f"[0, {self.vocab_size})")
            return req
        with self._cv:
            if self._failed:
                reason = f"engine crashed: {self._failed}"
            elif self.config.max_waiting and \
                    len(self._waiting) >= self.config.max_waiting:
                reason = "engine overloaded: waiting queue full"
            else:
                reason = None
                self._waiting.append(req)
                self._cv.notify()
        if reason:
            self._fail(req, reason)
        return req

    def submit_sync(self, prompt_tokens: list[int],
                    params: SamplingParams | None = None,
                    timeout_s: float | None = None) -> GenRequest:
        """Blocking submit; returns when the request finished."""
        req = self.submit(prompt_tokens, params)
        if not req.done.wait(timeout_s):
            raise TimeoutError(f"request not finished within {timeout_s} s")
        return req

    # ---------------------------------------------------------------- loop
    def _loop(self) -> None:
        try:
            with torch.no_grad():
                while self._running:
                    self._admit()
                    if self._walkers:
                        self._walk_chunks()
                    if any(r is not None for r in self.active):
                        self._step()
                    elif not self._walkers:
                        with self._cv:
                            if self._running and not self._waiting:
                                self._cv.wait(0.05)
        except Exception as exc:  # noqa: BLE001 — boundary: fail loudly
            self._failed = f"{type(exc).__name__}: {exc}"
            self._running = False
            self._fail_all(f"engine crashed: {self._failed}")

    def _fail(self, req: GenRequest, error: str) -> None:
        req.error = error
        req.finished_at = time.time()
        req.done.set()

    def _fail_all(self, reason: str) -> None:
        with self._cv:
            waiting, self._waiting = list(self._waiting), deque()
        for req in waiting:
            self._fail(req, reason)
        self._walkers = []
        self._sched_dirty = True
        for i, req in enumerate(self.active):
            if req is not None:
                self.active[i] = None
                self._release_pages(i)
                self.lengths[i] = 0
                self._fail(req, reason)

    # ------------------------------------------------------------- pages
    def _pages_for(self, req: GenRequest) -> int:
        """Pages of a request's whole life. With speculation a verify
        pass writes its tree's rows past the slot's length — up to
        ``spec_draft * spec_branches`` rows beyond the last token the
        budget allows — so those rows are reserved too, and every tree
        row lands in a page the slot owns."""
        cfg = self.config
        spare = cfg.spec_draft * cfg.spec_branches if cfg.speculative else 0
        rows = min(len(req.prompt_tokens) + req.params.max_new_tokens + spare,
                   cfg.max_seq)
        return -(-rows // cfg.page_size)

    def _decref_page(self, page: int) -> None:
        self._page_refs[page] -= 1
        if self._page_refs[page] <= 0:
            self._page_refs[page] = 0
            self._free_pages.append(page)

    def _evict_prefix_entries(self, pages_needed: int) -> None:
        """Drop cache entries, least recently used first, until the free
        list holds ``pages_needed`` pages or the cache is empty."""
        while len(self._free_pages) < pages_needed and self._prefix_cache:
            key = next(iter(self._prefix_cache))
            pages = self._prefix_cache.pop(key)
            self.stats["prefix_evictions"] += 1
            count = self._prefix_lens[len(key)] - 1
            if count:
                self._prefix_lens[len(key)] = count
            else:
                del self._prefix_lens[len(key)]
            self._cached_pages -= len(pages)
            for page in pages:
                self._decref_page(page)

    def _alloc_pages(self, slot: int, need: int) -> bool:
        """Grow ``slot``'s table to ``need`` pages, evicting cached
        prefixes if the free list is short; False when even that does
        not cover it."""
        have = int(self._slot_pages[slot])
        if need - have > len(self._free_pages):
            self._evict_prefix_entries(need - have)
        if need - have > len(self._free_pages):
            return False
        for i in range(have, need):
            page = self._free_pages.pop()
            self._tables[slot, i] = page
            self._page_refs[page] = 1
        self._slot_pages[slot] = max(have, need)
        self._tables_dirty = True
        return True

    def _release_pages(self, slot: int) -> None:
        for i in range(int(self._slot_pages[slot])):
            self._decref_page(int(self._tables[slot, i]))
        self._tables[slot, :] = self._n_pages
        self._slot_pages[slot] = 0
        self._tables_dirty = True

    # ------------------------------------------------------ prefix cache
    def _probe_prefix(self, prompt: list[int]) -> int:
        """Rows covered by the longest cached prefix of ``prompt`` (0 =
        miss), leaving at least one token to compute: the first sample
        needs a position to come from."""
        if not self.config.prefix_cache:
            return 0
        limit = len(prompt) - 1
        for length in sorted(self._prefix_lens, reverse=True):
            if length <= limit and tuple(prompt[:length]) in self._prefix_cache:
                return length
        return 0

    def _attach_prefix(self, slot: int, prompt: list[int],
                       covered: int) -> None:
        """Point ``slot``'s table at the cached pages of
        ``prompt[:covered]`` (one more reference each) and mark the
        entry most recently used."""
        key = tuple(prompt[:covered])
        pages = self._prefix_cache.pop(key)
        self._prefix_cache[key] = pages
        for i, page in enumerate(pages):
            self._tables[slot, i] = page
            self._page_refs[page] += 1
        self._slot_pages[slot] = len(pages)
        self._tables_dirty = True

    def _register_prefix(self, slot: int, req: GenRequest) -> None:
        """At retire: pin the page-aligned prompt prefix (leaving its
        last token out, as a probe does), or the longest aligned part
        of it that the budget still allows. Decode wrote only past the
        prompt, so these pages hold exactly the prefix's K/V."""
        if not self.config.prefix_cache:
            return
        pg = self.config.page_size
        prompt = req.prompt_tokens
        n = (len(prompt) - 1) // pg
        if n < 1 or int(self._slot_pages[slot]) < n:
            return
        n = min(n, self._prefix_budget - self._cached_pages)
        if n < 1:
            return
        key = tuple(prompt[:n * pg])
        if key in self._prefix_cache:
            return
        pages = [int(self._tables[slot, i]) for i in range(n)]
        for page in pages:
            self._page_refs[page] += 1
        self._prefix_cache[key] = pages
        self._prefix_lens[n * pg] = self._prefix_lens.get(n * pg, 0) + 1
        self._cached_pages += n

    def _reserve(self, slot: int, req: GenRequest) -> bool:
        """Give ``req`` the pages of its whole life in ``slot``: a
        cached prefix of its prompt attaches, the rest comes from the
        free list. False (and nothing held) when the pool cannot."""
        covered = self._probe_prefix(req.prompt_tokens)
        if covered:
            self._attach_prefix(slot, req.prompt_tokens, covered)
        if not self._alloc_pages(slot, self._pages_for(req)):
            self._release_pages(slot)
            return False
        req.prefill_offset = covered
        if covered:
            self.stats["prefix_hits"] += 1
        return True

    # ----------------------------------------------------------- admission
    def _admit(self) -> None:
        """Move waiting requests into free slots (FIFO) while the pool
        can hold them. A prompt with a cached prefix, or wider than
        every bucket, joins the chunk walk; the rest prefill in bucket
        groups."""
        free = [i for i, r in enumerate(self.active) if r is None]
        placed: list[GenRequest] = []
        refused: list[GenRequest] = []
        with self._cv:
            while free and self._waiting:
                req = self._waiting[0]
                if self._pages_for(req) > self._n_pages:
                    refused.append(self._waiting.popleft())
                    continue
                if not self._reserve(free[0], req):
                    break            # pool dry: wait for a retire
                self._waiting.popleft()
                req.slot = free.pop(0)
                self.active[req.slot] = req
                placed.append(req)
        for req in refused:
            self._fail(req, "request exceeds kv pool")
        widest = self._usable_buckets[-1]
        by_bucket: dict[int, list[GenRequest]] = {}
        for req in placed:
            if req.prefill_offset or len(req.prompt_tokens) > widest:
                req.pending_prefill = True
                self._walkers.append(req)
            else:
                by_bucket.setdefault(self._bucket_for(len(req.prompt_tokens)),
                                     []).append(req)
        p_max = max(1, self.config.prefill_batch)
        for bucket, group in by_bucket.items():
            for i in range(0, len(group), p_max):
                self._prefill_group(bucket, group[i:i + p_max])

    def _bucket_for(self, n: int) -> int:
        for b in self._usable_buckets:
            if n <= b:
                return b
        return self._usable_buckets[-1]

    def _group_sizes(self) -> tuple:
        """Prefill group sizes: powers of two below ``prefill_batch``,
        then ``prefill_batch`` itself."""
        cap = max(1, self.config.prefill_batch)
        sizes, g = [], 1
        while g < cap:
            sizes.append(g)
            g *= 2
        return tuple(sizes) + (cap,)

    def _row_params(self, reqs: list, n: int):
        temps = np.zeros(n, np.float32)
        top_ps = np.ones(n, np.float32)
        top_ks = np.zeros(n, np.int64)
        for row, req in enumerate(reqs):
            temps[row] = req.params.temperature
            top_ps[row] = req.params.top_p
            top_ks[row] = req.params.top_k
        dev = self.device
        return (torch.from_numpy(temps).to(dev),
                torch.from_numpy(top_ps).to(dev),
                torch.from_numpy(top_ks).to(dev))

    def _prefill_group(self, bucket: int, group: list[GenRequest]) -> None:
        p = next(g for g in self._group_sizes() if g >= len(group))
        tokens = np.zeros((p, bucket), np.int64)
        kv_len = np.ones(p, np.int32)            # dummy rows: length 1
        tables = np.full((p, self._pages_per_slot), self._n_pages,
                         np.int32)               # dummy rows: all OOB
        for row, req in enumerate(group):
            n = len(req.prompt_tokens)
            tokens[row, :n] = req.prompt_tokens
            kv_len[row] = n
            tables[row] = self._tables[req.slot]
        dev = self.device
        t0 = time.perf_counter()
        tokens_t = torch.from_numpy(tokens).to(dev)
        kv_len_t = torch.from_numpy(kv_len).to(dev)
        tables_t = torch.from_numpy(tables).to(dev)
        temps, top_ps, top_ks = self._row_params(group, p)
        logits, (k, v) = self._prefill_fn(self.params, tokens_t, kv_len_t)
        toks = sample_batch(logits, temps, top_ps, top_ks,
                            generator=self._generator,
                            all_greedy=_all_greedy(group))
        offsets = torch.zeros_like(kv_len_t)
        scatter_chunk(self.k_cache, tables_t, k, offsets, kv_len_t)
        scatter_chunk(self.v_cache, tables_t, v, offsets, kv_len_t)
        first = toks.cpu().numpy()
        self.stats["prefill_calls"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t0
        for row, req in enumerate(group):
            self._first_token(req, int(first[row]))

    def _first_token(self, req: GenRequest, token: int) -> None:
        """The prompt is in the cache: emit the first sampled token and
        open the slot for decode."""
        req.pending_prefill = False
        self._sched_dirty = True
        req.first_token_at = time.time()
        req.generated.append(token)
        self.total_generated += 1
        self.lengths[req.slot] = len(req.prompt_tokens)
        if self._finished(req, token):
            self._retire(req.slot)

    # ---------------------------------------------------------- chunk walk
    def _walk_chunks(self) -> None:
        """Up to ``prefill_chunks_per_pass`` rounds of the walk: each
        round groups the walkers by the smallest bucket covering what is
        left of their prompt (the widest when none does) and runs each
        group of at most ``prefill_batch`` as one chunk call."""
        widest = self._usable_buckets[-1]
        p_max = max(1, self.config.prefill_batch)
        for _ in range(max(1, int(self.config.prefill_chunks_per_pass))):
            if not self._walkers:
                return
            by_width: dict[int, list[GenRequest]] = {}
            for req in self._walkers:
                left = len(req.prompt_tokens) - req.prefill_offset
                width = next((b for b in self._usable_buckets if b >= left),
                             widest)
                by_width.setdefault(width, []).append(req)
            for width, group in by_width.items():
                for i in range(0, len(group), p_max):
                    self._chunk_group(width, group[i:i + p_max])
            self._walkers = [r for r in self._walkers if r.pending_prefill]

    def _chunk_group(self, width: int, group: list[GenRequest]) -> None:
        """One [G, width] chunk call, G = 1 for a lone walker, else
        ``prefill_batch``; pad rows carry an all-OOB table, offset 0 and
        chunk length 0. Walkers whose prompt this chunk completes take
        their first token from it."""
        g = 1 if len(group) == 1 else max(1, self.config.prefill_batch)
        tokens = np.zeros((g, width), np.int64)
        offsets = np.zeros(g, np.int32)
        lens = np.zeros(g, np.int32)
        tables = np.full((g, self._pages_per_slot), self._n_pages, np.int32)
        for row, req in enumerate(group):
            chunk = req.prompt_tokens[req.prefill_offset:
                                      req.prefill_offset + width]
            tokens[row, :len(chunk)] = chunk
            offsets[row] = req.prefill_offset
            lens[row] = len(chunk)
            tables[row] = self._tables[req.slot]
        dev = self.device
        t0 = time.perf_counter()
        temps, top_ps, top_ks = self._row_params(group, g)
        logits, self.k_cache, self.v_cache = self._chunk_fn(
            self.params, torch.from_numpy(tokens).to(dev), self.k_cache,
            self.v_cache, torch.from_numpy(tables).to(dev),
            torch.from_numpy(offsets).to(dev), torch.from_numpy(lens).to(dev))
        toks = sample_batch(logits, temps, top_ps, top_ks,
                            generator=self._generator,
                            all_greedy=_all_greedy(group))
        first = None
        for row, req in enumerate(group):
            req.prefill_offset += int(lens[row])
            if req.prefill_offset >= len(req.prompt_tokens):
                if first is None:
                    first = toks.cpu().numpy()
                self._first_token(req, int(first[row]))
        self.stats["prefill_calls"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t0

    # -------------------------------------------------------------- decode
    def _finished(self, req: GenRequest, token: int) -> bool:
        if token == self.config.eos_id:
            return True
        return len(req.generated) >= req.params.max_new_tokens

    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        if req is None:
            return
        self.active[slot] = None
        self.lengths[slot] = 0
        self._sched_dirty = True
        self._register_prefix(slot, req)
        self._release_pages(slot)
        req.finished_at = time.time()
        req.done.set()

    def _sync_decode_state(self) -> None:
        """Rebuild and upload the per-slot arrays the decode dispatch
        reads, row = slot. Called only when an event set
        ``_sched_dirty``; steady-state dispatches reuse the device
        copies, which the dispatch itself advances. A row that decoded
        for the same request in the last dispatch takes its last token
        from the device (``use_prev``); idle and mid-walk rows are
        inactive, with length 0."""
        cfg = self.config
        b = cfg.max_batch
        arrays = {"tokens": np.zeros(b, np.int64),
                  "use_prev": np.zeros(b, bool),
                  "lengths": np.zeros(b, np.int32),
                  "active": np.zeros(b, bool),
                  "temps": np.zeros(b, np.float32),
                  "top_ps": np.ones(b, np.float32),
                  "top_ks": np.zeros(b, np.int64)}
        for i, req in enumerate(self.active):
            if req is None or req.pending_prefill:
                continue
            arrays["active"][i] = True
            arrays["lengths"][i] = self.lengths[i]
            if self._dev_last_reqs[i] is req:
                arrays["use_prev"][i] = True
            else:
                arrays["tokens"][i] = req.generated[-1]
            arrays["temps"][i] = req.params.temperature
            arrays["top_ps"][i] = req.params.top_p
            arrays["top_ks"][i] = req.params.top_k
        self.stats["h2d_transfers"] += self._decode_graph.upload(**arrays)
        self.stats["sched_syncs"] += 1
        self._sched_dirty = False

    def _sync_tables(self) -> None:
        """Upload the block tables, only when a page was allocated,
        released or attached since the last upload."""
        self.stats["h2d_transfers"] += self._decode_graph.upload(
            tables=self._tables)
        self._tables_dirty = False

    def _decode_pass(self) -> None:
        cfg = self.config
        steps = self._tokens_per_pass
        for i, req in enumerate(self.active):
            if req is not None and not req.pending_prefill \
                    and self.lengths[i] >= cfg.max_seq:
                self._retire(i)           # at the cache ceiling
        rows = [i for i, r in enumerate(self.active)
                if r is not None and not r.pending_prefill]
        if not rows:
            return
        reqs = [self.active[i] for i in rows]
        # steps whose write would land at or past max_seq are garbage
        # (their K/V writes drop): only the valid prefix is emitted
        valid = np.minimum(steps, cfg.max_seq - self.lengths[rows])
        t0 = time.perf_counter()
        if self._sched_dirty:
            self._sync_decode_state()
        if self._tables_dirty:
            self._sync_tables()
        graph = self._decode_graph
        out = graph.run(self.k_cache, self.v_cache, _all_greedy(reqs))
        busy = time.perf_counter() - t0
        self.stats["decode_passes"] += 1
        self.stats["decode_s"] += busy
        self.stats["graph_captures"] = graph.captures
        self.stats["graph_replays"] = graph.replays
        self.stats["graph_capture_s"] = graph.capture_s
        self._step_count += 1
        self._dev_last_reqs = [r if r is not None and not r.pending_prefill
                               else None for r in self.active]
        self.lengths[rows] += valid.astype(np.int32)
        emitted = 0
        for j, (slot, req) in enumerate(zip(rows, reqs)):
            done = False
            for k in range(int(valid[j])):
                token = int(out[k, slot])
                req.generated.append(token)
                self.total_generated += 1
                emitted += 1
                if self._finished(req, token):
                    done = True
                    break
            if done or valid[j] < steps:
                self._retire(slot)
        self.stats["decode_tokens"] += emitted
        # the price an accepted draft token undercuts
        self._spec_ctrl.note_decode(busy, emitted)

    # --------------------------------------------------------- speculation
    def _step(self) -> None:
        """One pass over the decoding slots. With speculation, every
        greedy slot drafts first; a verify pass runs when every
        decoding slot drafted, and in a mixed batch every other time
        (a verify pass advances a slot that did not draft by one token,
        so it gets a full K-step decode pass in between), else a decode
        pass."""
        proposals: dict[int, Any] = {}
        decoding = 0
        if self.config.speculative:
            for i, r in enumerate(self.active):
                if r is None or r.pending_prefill:
                    continue
                decoding += 1
                if r.params.temperature == 0.0:
                    drafted = self._draft_proposals(r)
                    if drafted:
                        proposals[i] = drafted
        if proposals and (len(proposals) == decoding or self._spec_toggle):
            self._spec_toggle = False
            self._spec_pass(proposals)
        else:
            self._spec_toggle = True
            self._decode_pass()

    def _draft_proposals(self, req: GenRequest):
        """Prompt-lookup drafting on the request's incremental n-gram
        index: the stream's final n-gram proposes up to
        ``spec_branches`` distinct continuations (newest occurrences
        first), trie-merged into one :class:`DraftTree`, at the depth
        the controller prices for the slot. Returns a tree with at least
        one draft node, or [] when this pass should not draft."""
        cfg = self.config
        slot = req.slot
        ctrl = self._spec_ctrl
        if self._spec_ctrl_owner[slot] is not req:
            ctrl.reset_slot(slot)
            self._spec_ctrl_owner[slot] = req
        depth, branches = ctrl.plan(slot)
        # the bonus token always lands, so at most remaining - 1 drafts
        # can be kept
        remaining = req.params.max_new_tokens - len(req.generated)
        depth = min(depth, max(0, remaining - 1))
        if depth <= 0 or branches <= 0:
            return []
        n = max(1, cfg.spec_ngram)
        idx = req.spec_index
        if idx is None or idx.n != n:
            idx = NgramIndex(n)
            idx.extend(req.prompt_tokens)
            idx.prompt_len = len(req.prompt_tokens)
            req.spec_index = idx
        stream_len = idx.prompt_len + len(req.generated)
        if idx.size < stream_len:
            idx.extend(req.generated[idx.size - idx.prompt_len:])
        chains = idx.propose(depth, branches)
        if not chains:
            return []
        # the verify pass writes the tree's rows at lengths .. lengths +
        # n_nodes - 1: near the cache ceiling the tree is cut (in its
        # topological order) so that every row lands below max_seq
        room = cfg.max_seq - int(self.lengths[slot])
        tree = build_draft_tree(
            req.generated[-1], chains,
            max_nodes=min(1 + cfg.spec_draft * cfg.spec_branches, room))
        return tree if tree.n_draft else []

    def _spec_pass(self, proposals: dict[int, DraftTree]) -> None:
        """One tree-verify pass over every decoding slot (``proposals``:
        slot -> its draft tree); a slot without a tree rides along as a
        lone root node, which is exactly one decode step for it. Accepted tokens and the bonus token are
        emitted host-side; the accepted path's K/V rows were compacted
        on the device."""
        cfg = self.config
        for i, req in enumerate(self.active):
            if req is not None and not req.pending_prefill \
                    and self.lengths[i] >= cfg.max_seq:
                self._retire(i)           # at the cache ceiling
        rows = [i for i, r in enumerate(self.active)
                if r is not None and not r.pending_prefill]
        if not rows:
            return
        trees: dict[int, DraftTree] = {
            i: tree for i, tree in proposals.items()
            if self.active[i] is not None}
        # pow-2 width buckets: the widest tree of the pass picks it
        widest = max((t.n_nodes for t in trees.values()), default=1)
        width = 2
        while width < widest:
            width *= 2
        n = len(rows)
        reqs = [self.active[i] for i in rows]
        tokens = np.zeros((n, width), np.int64)
        parents = np.zeros((n, width), np.int64)
        depths = np.zeros((n, width), np.int64)
        masks = np.ones((n, width), np.int64)
        chunk_lens = np.ones(n, np.int32)
        for j, (slot, req) in enumerate(zip(rows, reqs)):
            tokens[j, 0] = req.generated[-1]
            tree = trees.get(slot)
            if tree is not None:
                m = tree.n_nodes
                tokens[j, :m] = tree.tokens
                parents[j, :m] = tree.parents
                depths[j, :m] = tree.depths
                masks[j, :m] = tree.masks
                chunk_lens[j] = m
        dev = self.device
        t0 = time.perf_counter()
        temps, top_ps, top_ks = self._row_params(reqs, n)
        tables = torch.from_numpy(self._tables[rows]).to(dev)
        offsets = torch.from_numpy(self.lengths[rows].copy()).to(dev)
        lens_t = torch.from_numpy(chunk_lens).to(dev)
        tokens_t = torch.from_numpy(tokens).to(dev)
        parents_t = torch.from_numpy(parents).to(dev)
        depths_t = torch.from_numpy(depths).to(dev)
        # the 32-bit ancestor masks travel as int32 bit patterns
        masks_t = torch.from_numpy(
            masks.astype(np.uint32).view(np.int32)).to(dev)
        logits, self.k_cache, self.v_cache = self._verify_fn(
            self.params, tokens_t, self.k_cache, self.v_cache, tables,
            offsets, lens_t, tree_depths=depths_t, tree_masks=masks_t)
        n_acc, bonus, path = resolve_tree(
            logits, tokens_t, parents_t, depths_t, lens_t, temps, top_ps,
            top_ks, generator=self._generator)
        src, dst = path_moves(offsets, path, n_acc, cfg.max_seq)
        pool_move_rows(self.k_cache, tables, src, dst)
        pool_move_rows(self.v_cache, tables, src, dst)
        out = torch.cat([n_acc[:, None], bonus[:, None].long(), path],
                        1).cpu().numpy()
        dur = time.perf_counter() - t0
        # the verify emitted tokens the decode state has not seen
        self._sched_dirty = True
        self._dev_last_reqs = [None] * cfg.max_batch
        self.stats["spec_passes"] += 1
        self.stats["spec_s"] += dur
        self.stats["decode_s"] += dur
        self._step_count += 1
        emitted_total = 0
        for j, (slot, req) in enumerate(zip(rows, reqs)):
            tree = trees.get(slot)
            n_drafted = tree.n_draft if tree is not None else 0
            accepted = min(int(out[j, 0]), n_drafted)
            if n_drafted:
                self._spec_ctrl.note_result(slot, n_drafted, accepted)
            self.stats["spec_accepted"] += accepted
            self.stats["spec_drafted"] += n_drafted
            self.stats["spec_rows"] += 1
            # the accepted root-to-leaf path's tokens in depth order,
            # then the bonus token sampled at the deepest accepted node
            emitted = [tree.tokens[int(out[j, 2 + k])]
                       for k in range(1, accepted + 1)] if tree else []
            emitted.append(int(out[j, 1]))
            ceiling = cfg.max_seq - int(self.lengths[slot])
            done = False
            kept = 0
            for token in emitted:
                if kept >= ceiling:
                    done = True
                    break
                req.generated.append(token)
                self.total_generated += 1
                kept += 1
                if self._finished(req, token):
                    done = True
                    break
            emitted_total += kept
            self.lengths[slot] += kept
            if done or kept >= ceiling:
                self._retire(slot)
        self.stats["decode_tokens"] += emitted_total
        self._spec_ctrl.note_verify(dur, n, width)


def _all_greedy(reqs) -> bool:
    """True when every request decodes greedily (the sampler then skips
    its candidate search), decided on the host from their params."""
    return all(r.params.temperature <= 0.0 for r in reqs)


def resolve_tree(logits: torch.Tensor, tokens: torch.Tensor,
                 parents: torch.Tensor, depths: torch.Tensor,
                 chunk_lens: torch.Tensor, temps: torch.Tensor,
                 top_ps: torch.Tensor, top_ks: torch.Tensor, *,
                 generator: torch.Generator | None = None):
    """The longest accepted root-to-leaf path of each row's draft tree.

    logits [B, W, V] of every node; tokens / parents / depths [B, W]
    (topological packing, node 0 = the committed root); chunk_lens [B]
    live nodes. Node j is accepted iff its parent is and its token is
    the parent's greedy prediction (node 0 always is), so one forward
    sweep over the width is exact. The deepest accepted node wins, ties
    to the lowest index (``argmax`` returns the first maximum). Returns
    (accepted depth [B], bonus token [B] sampled at the deepest accepted
    node with the row's params, path [B, W]: ``path[b, k]`` is the node
    at depth k of the accepted path, for k <= accepted[b])."""
    b, w = tokens.shape
    rows = torch.arange(b, device=tokens.device)
    pred = logits.argmax(-1)                                     # [B, W]
    acc = torch.zeros((b, w), dtype=torch.bool, device=tokens.device)
    acc[:, 0] = True
    for j in range(1, w):
        pj = parents[:, j]
        acc[:, j] = (acc[rows, pj] & (tokens[:, j] == pred[rows, pj])
                     & (j < chunk_lens))
    score = torch.where(acc, depths, torch.full_like(depths, -1))
    best = score.argmax(1)
    n_acc = depths[rows, best]
    # root-first path by depth: walk parents w steps from the best node,
    # writing each visited node at its own depth (the walk idles at the
    # root once it gets there)
    path = torch.zeros_like(tokens)
    depth_idx = torch.arange(w, device=tokens.device)[None, :]
    cur = best
    for _ in range(w):
        hit = depth_idx == depths[rows, cur][:, None]
        path = torch.where(hit, cur[:, None], path)
        cur = parents[rows, cur]
    bonus = sample_batch(logits[rows, best], temps, top_ps, top_ks,
                         generator=generator)
    return n_acc, bonus, path


def path_moves(offsets: torch.Tensor, path: torch.Tensor,
               n_acc: torch.Tensor, max_seq: int):
    """The K/V compaction plan of an accepted path: the node at depth k
    was written at row ``offsets + path[k]`` and belongs at
    ``offsets + k``. Depth 0 is the root, moved onto itself; depths past
    the accepted one get the ``max_seq`` sentinel, which
    :func:`pool_move_rows` drops. Returns (src, dst) [B, W]."""
    k = torch.arange(path.shape[1], device=path.device)[None, :]
    base = offsets.long()[:, None]
    dst = torch.where(k <= n_acc[:, None], base + k,
                      torch.full_like(path, max_seq))
    return base + path, dst
