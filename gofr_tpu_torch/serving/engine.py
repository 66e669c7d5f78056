"""Continuous-batching inference engine (counterpart of
``gofr_tpu/serving/engine.py``: the paged layout with the prefix cache,
the chunk-with-history walk, speculative tree verify, lazy page growth
with preemption-by-recompute and pipelined decode, and the dense-cache
paths of families with a dense decode step).

- **KV layouts** (``kv_layout``): ``"paged"`` (the default here; the JAX
  engine's default is ``"slot"``), a page pool with block tables, and
  ``"slot"``, contiguous per-slot caches [L, max_batch, max_seq, Hkv,
  hd]. A family with paged step functions (``paged_decode_fn``, Llama)
  decodes natively on the pool unless ``paged_attention="view"``; a
  family with only a dense ``decode_fn`` (the MoE family), and any
  family on the slot layout or under ``"view"``, decodes on the slot
  caches, or on the paged layout through the pool's dense view: one
  gather per T-step dispatch, the T steps on the view, the T new rows
  written back (``decode_graph.DecodeGraph``'s layouts). The dense
  layouts' chunk walk and tree verify run the family's dense
  ``prefill_chunk_fn`` / ``spec_verify_fn`` on a copy of the rows'
  caches (the slot layout: the slots' rows; the view: the pool gathered
  through their tables), and write back what the call wrote (the view:
  each row's chunk range, through the slab kernel). Without a chunk
  function there is no chunk walk: a prompt is clamped to the widest
  bucket, a preempted request's continuation too, and the prefix cache
  is off; without a verify function ``speculative`` serves plain
  decode. The slot layout keeps no prefix cache.
- **Decode windows** (``decode_windows``, dense layouts): each listed
  window is a decode graph of its own that attends (slot) or gathers
  and writes back (view) only the first ``window`` rows; a dispatch
  takes the smallest window covering every decoding slot's length + T,
  else the full graph.

- One **engine thread** owns every device call; ``submit()`` only
  queues, from any thread. Each loop iteration admits (requeued work
  first, then ``free - needing_slots`` waiting requests), runs one
  decode step or speculative pass, and collects the batch prefills in
  flight; when idle, and on ``stop``, it drains whatever is in flight
  (those tokens are real, so they are emitted before anything fails).
- **Bucketed group prefill**: waiting prompts are grouped by the
  smallest prefill bucket that holds them and prefilled ``[P, bucket]``
  at a time, P the smallest power of two (or ``prefill_batch``) that
  fits the group; dummy rows carry length 1 and an all-OOB block table,
  so their K/V writes drop. One device call per group samples each
  row's first token and writes the prompt K/V into the page pool
  (``scatter_chunk_kv``). The first tokens travel to pinned host memory
  behind an event and are emitted by ``_collect_prefills`` (records
  whose request was preempted or re-admitted since, by
  ``prefill_epoch``, are dropped); below the pipelining threshold that
  happens at admission.
- **Chunk walk** (``_walk_chunks``): a prompt wider than every bucket,
  the suffix of a prompt whose prefix the cache held and a preempted
  request's recompute run through the chunk model function against the
  slot's history, ``[G, width]`` per call with G in {1,
  ``prefill_batch``} and width the smallest bucket covering what is left
  (the widest when none does); pad rows carry an all-OOB table, offset
  0 and chunk length 0. At most ``prefill_chunks_per_pass`` rounds run
  per admission; an unfinished walker goes back to the requeued lane
  and resumes in the slot it holds, so the other slots decode between
  the chunks of a long prompt. The walk is synchronous.
- **Pages**: a host-side free list with a reference count per page
  (slots and the prefix cache each hold one). A slot's table grows
  lazily, in rows: prompt + 1 at the group prefill, each chunk's rows in
  the walk, ``len + T`` rows before each decode dispatch (oldest request
  first) and every fed tree row before a verify pass. When the free
  list runs short, cached prefixes are evicted (least recently used
  first), then the newest request younger than the one growing is
  preempted (``_ensure_headroom``): its pages go back, and it re-enters
  the requeued lane with prompt + generated as its new prompt, to be
  recomputed (``_preempt``). A prompt is refused only when it can never
  fit the pool.
- **Prefix cache**: at retire, a request's page-aligned prompt prefix
  stays pinned under its token ids (at most ``prefix_cache_pages``
  pages). A later prompt that starts with a cached prefix (leaving at
  least one token to compute) attaches those pages to its table and
  walks only the rest. Every change of the cache (an entry pinned,
  evicted or touched, the cache emptied) marks the fleet **prefix
  digest** dirty; the throttled gauge pass rebuilds it
  (``_refresh_prefix_digest``: the newest ``prefix_digest_hashes`` keys,
  each hashed by ``router.prefix_hash``) and publishes it by reference
  swap (``prefix_digest()``), which the flight recorder's
  ``fleet_summary`` hands to a heartbeat and the leader's router scores
  hosts by.
- **Decode dispatches** of T = ``decode_steps_per_pass`` (K) x
  ``decode_passes_per_dispatch`` (M) steps over every slot (row = slot,
  ``max_batch`` rows; ``decode_graph.DecodeGraph``): each step writes
  one K/V row per decoding slot through its table (other rows' writes
  are dropped on the card), attends with the paged decode kernel and
  samples; sampled tokens feed the next step on the device. The
  per-slot state lives on the device and is uploaded only when an event
  changes it (``stats["sched_syncs"]``, ``stats["h2d_transfers"]``); on
  CUDA a dispatch is one CUDA graph replay (``stats["graph_captures"]``,
  ``stats["graph_replays"]``; ``warmup`` captures both graphs ahead of
  traffic, else the first dispatch of each kind does). Dispatch and
  collect are split (``_decode_dispatch`` / ``_decode_collect``): up to
  ``pipeline_depth`` dispatches stay in flight while the host emits the
  previous one's tokens. Lengths advance at dispatch; a row whose
  request was retired or preempted since its dispatch is discarded at
  collect. Slots retire on eos, on ``max_new_tokens``, at the
  ``max_seq`` ceiling or when cancelled, exactly as the JAX engine
  counts them.
- **Speculative tree verify** (``speculative``, off by default): before
  each pass every greedy decoding slot drafts by prompt lookup (its
  request's ``NgramIndex`` proposes up to ``spec_branches``
  continuations of the stream's last ``spec_ngram`` tokens, trie-merged
  into one ``DraftTree``; the ``SpecController`` prices the depth). When
  every decoding slot drafted — or, in a mixed batch, every other pass —
  the decode pipeline is drained and one verify pass feeds each slot's
  tree (a lone root for a slot that did not draft) through the paged
  tree kernel (a dense layout: the dense verify function) at a pow-2
  width, accepts the longest root-to-leaf path whose tokens the model
  predicts greedily (``resolve_tree``), compacts that path's K/V rows
  (``path_moves`` + ``pool_move_rows``; ``dense_move_rows`` in a dense
  copy before its write-back) and emits
  the accepted tokens plus one bonus token sampled at the deepest
  accepted node. Every tree row lands in a page its slot owns: the
  pass grows each slot's table to cover its tree first.
- **KV pool form** (``kv_dtype``): the model's dtype (``"bf16"``), or
  ``"int8"``: codes plus one float32 scale per row, quantized on every
  write and read by the int8 branches of the paged kernels. The pool is
  sized by bytes, as in the JAX engine: ``kv_pool_bytes``, or by default
  what ``kv_pages`` (or the full capacity) costs in the model's dtype,
  so an int8 pool holds about twice the pages in the same memory.
- **Admission** (``scheduler``, :mod:`.scheduler`): waiting requests
  sit in a :class:`Scheduler` (tenant sub-queues, an interactive and a
  background lane, per-tenant rate limits, ``max_waiting`` as its
  capacity); a refusal fails the request at ``submit`` with a typed
  ``reject``. With the batch full and an interactive request waiting
  past ``starvation_s``, the newest background slot is preempted and
  its request handed back to the scheduler (``readmit``).
- **Per-token channel**: each request's ``out_queue`` receives every
  token id where it is appended to ``generated``, then one ``None``
  where the request ends (retired, failed or dropped cancelled);
  ``stream_request`` iterates it. Tokens a collect discards never reach
  it.
- **Lifecycle**: ``warmup`` (before ``start``) runs every prefill shape,
  optionally the walk's, both decode graphs and the verify widths on
  all-OOB tables, leaving pools, free list, lengths and generator as
  they were; ``cancel`` abandons a request; ``drain`` refuses new
  submits, lets the queued and in-flight work finish, then stops.

- **Accounting and integrity planes** (host arithmetic over the spans
  and tokens the collects already hold, as in the JAX engine; none adds
  a device sync or an upload): every collect feeds the flight recorder
  (``recorder``), the goodput ledger (``goodput``: useful vs padding /
  preempt_recompute / spec_rejected / bubble / integrity_probe, useful
  + waste == busy), the pass-cost model (``costs``, per dispatch
  signature, with its drift sentinel) and the recompile sentinel
  (``sentinel``, sealed by ``warmup``); memory high-water marks
  (``watermarks``); every request ends in ``_finalize_obs`` exactly
  once (latency histograms, the usage ledger, the SLO verdict and the
  scheduler's burn column, the output digest ``req.digest`` and golden
  probe judgement of the integrity plane, the recorder's request log);
  golden probes run on the background lane every
  ``integrity_probe_passes`` collected passes; actions land on the
  event ledger (``events``); seven fault sites (``faults``, the
  ``GOFR_FAULTS`` syntax); a stall watchdog flips health to DEGRADED;
  ``attach_metrics`` registers the JAX engine's series (its
  ``app_tpu_execute_seconds`` is ``app_gpu_execute_seconds`` here) and
  the loop publishes its gauges every 0.25 s, the MFU gauge from the
  model's flops per token (``warmup``) over the card's peak.

- **Recovery** (as in the JAX engine): a failed group prefill, prefill
  collect or chunk call fails only the requests of that pass (``prefill
  failed``) and the engine serves on. With a ``restart_policy`` a loop
  exception goes to the in-thread supervisor (``_recover``): a request
  with no first token yet is replayed from its prompt through the
  requeued lane (``recovered``, its re-prefill priced as
  ``preempt_recompute``), a mid-stream one fails with a typed
  ``engine_restart`` reject, a cancelled one closes; the runtime state is
  rebuilt on the resident weights, pools and captured graphs
  (``_reset_runtime_state``: the dispatches in flight discarded, the
  card synchronised, a pristine allocator, every device-resident state
  buffer marked for upload; the pools are never reallocated, since the
  decode graphs hold their addresses), and the loop resumes after a
  deterministic backoff, up to ``max_restarts``; past it (or on a
  sticky CUDA error) the crash is terminal and opens a
  ``restart_budget`` incident bundle. A submit into a stopped or
  crashed engine is refused with a typed ``engine_down`` reject.
- **Forensics**: incident bundles (``incidents``) on a restart budget
  overrun, a cost drift, a golden-probe mismatch and an SLO fast burn;
  workload capture (``workload``, the ``gofr-workload`` file that
  ``serving/replay.py`` drives back through an engine); the request's
  ``engine.*`` spans through ``tracer`` at its end, exemplar trace ids
  on the latency histograms; the anomaly-triggered ``torch.profiler``
  capture (``autoprof``).
"""

from __future__ import annotations

import inspect
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..analysis.annotations import hot_path, hot_path_boundary
from ..ops.paged_kv import (KV_DTYPES, gather_view, pool_move_rows,
                            pool_row_bytes, scatter_chunk_kv,
                            scatter_decode_kv)
from ..tracing import _traceparent_sampled, extract_traceparent
from .costmodel import AutoProfiler, CostModel
from .decode_graph import DecodeGraph
from .events import IncidentDetector, resolve_ledger
from .faults import NO_FAULTS, resolve_plan
from .integrity import GoldenSet, IntegrityPlane
from .lockstep import Lockstep
from .observability import (FlightRecorder, GoodputMeter, ProfilerCapture,
                            RecompileSentinel, StallWatchdog, UsageLedger,
                            WatermarkTracker, WorkloadRecorder,
                            device_peak_flops, emit_engine_spans,
                            request_summary)
from .router import prefix_hash
from .sampling import sample_batch
from .scheduler import SchedReject, Scheduler, SchedulerConfig
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
    #: True while the slot holds the request but must not decode yet:
    #: mid chunk walk, or a batch prefill whose first token is in flight
    pending_prefill: bool = False
    #: admission order, given once and kept across preemption: the
    #: newest request is the one preempted
    admit_order: int = -1
    #: bumped per batch-prefill dispatch, walk admission and preemption,
    #: so that a stale first token never lands on a requeued request
    prefill_epoch: int = 0
    #: the caller gave up: dropped at admission, retired at the next
    #: dispatch (its tokens in flight are discarded)
    cancelled: bool = False
    #: generated tokens a preemption already appended to the prompt
    folded: int = 0
    #: prompt-lookup index over prompt + generated (speculation only)
    spec_index: NgramIndex | None = None
    #: the caller's accounting label (None: "anonymous" to the scheduler)
    tenant: str | None = None
    #: scheduler lane, "interactive" or "background"
    lane: str = "interactive"
    #: the scheduler's typed refusal, when admission refused the request
    reject: Any = None
    #: first slot assignment: the end of the queue wait
    admitted_at: float | None = None
    #: lifecycle events (name, t0, t1, attrs), at most 64: the flight
    #: recorder's request log
    events: list = field(default_factory=list)
    #: ``_finalize_obs`` ran (it runs once: retire, fail or cancel)
    _obs_done: bool = False
    #: this request's share of every pass's busy span, summed at collect
    device_s: float = 0.0
    #: the part of ``device_s`` that re-prefilled K/V this request had
    #: computed once (preemption by recompute)
    waste_recompute_s: float = 0.0
    #: the part of ``device_s`` spent on this request's rejected drafts
    waste_spec_s: float = 0.0
    #: output fingerprint (``integrity.request_digest``), stamped at the
    #: end
    digest: str | None = None
    #: (trace_id, parent_span_id) of the submitter's sampled trace: the
    #: ``engine.*`` spans assemble under it at the end
    trace: Any = None
    #: salvaged across an engine restart before its first token: its
    #: replayed prefill recomputes K/V it paid for once
    #: (``preempt_recompute``)
    recovered: bool = False
    #: golden-probe id when this request is an integrity probe
    probe: str = ""
    #: the sealed digest a probe must reproduce
    probe_expected: str = ""
    error: str | None = None
    done: threading.Event = field(default_factory=threading.Event)
    #: every token id as it is appended to ``generated``, then one None
    #: when the request ends; a ``SimpleQueue``, so the engine thread
    #: never blocks on it
    out_queue: queue.SimpleQueue = field(default_factory=queue.SimpleQueue)

    def _end(self) -> None:
        """Set ``done`` and close the channel, once."""
        if not self.done.is_set():
            self.done.set()
            self.out_queue.put(None)

    @property
    def ttft_ms(self) -> float | None:
        if self.first_token_at is None:
            return None
        return (self.first_token_at - self.submitted_at) * 1000.0


@dataclass
class RestartPolicy:
    """The in-thread supervisor's budget: on a loop exception the engine
    salvages what it safely can (``Engine._recover``), rebuilds its
    runtime state on the resident weights, pools and graphs, sleeps a
    deterministic exponential backoff and resumes, up to
    ``max_restarts`` times; after that the crash is terminal."""
    max_restarts: int = 3       # lifetime restart budget; 0 = disabled
    backoff_s: float = 0.05     # sleep before restart #1
    backoff_mult: float = 2.0   # growth per successive restart
    max_backoff_s: float = 5.0  # backoff ceiling

    def backoff_for(self, attempt: int) -> float:
        """Deterministic backoff before restart ``attempt`` (1-based)."""
        return min(self.max_backoff_s,
                   self.backoff_s * self.backoff_mult ** max(0, attempt - 1))


class DeviceLost(RuntimeError):
    """The card reports an error on synchronisation: a CUDA error is
    sticky, so no restart can serve on this context."""


#: ``EngineConfig.kv_layout`` values
KV_LAYOUTS = ("paged", "slot")
#: ``EngineConfig.paged_attention`` values (the JAX engine's)
PAGED_ATTENTION = ("auto", "kernel", "interpret", "xla", "view")


@dataclass
class EngineConfig:
    max_batch: int = 8          # decode slots
    max_seq: int = 1024         # per-slot kv capacity
    #: "paged": a page pool with block tables (capacity decoupled from
    #: max_batch x max_seq, pages allocated lazily, preemption when the
    #: pool runs dry); "slot": contiguous per-slot rows, max_batch x
    #: max_seq, for families with a dense decode step. The JAX engine's
    #: default is "slot"; the port's main path is "paged"
    kv_layout: str = "paged"
    #: dense layouts: extra decode graphs that attend (slot) or gather
    #: and write back (paged view) only the first ``window`` rows; each
    #: dispatch takes the smallest window covering every decoding slot's
    #: length + T, else the full graph. () = off; the native paged step
    #: ignores them (its kernel reads each slot's own pages)
    decode_windows: tuple = ()
    #: how the paged layout attends when the family supplies paged step
    #: functions: "view" forces the dense view (gather, the dense steps,
    #: write back); "auto", "kernel", "interpret" and "xla" take the
    #: native path, whose wrappers launch the paged kernels for CUDA
    #: tensors and run their plain versions for CPU ones. (The JAX
    #: engine's "auto" goes native on a TPU only.) Ignored on the slot
    #: layout and by a family with only a dense decode_fn
    paged_attention: str = "auto"
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
    #: rows per KV page (paged layout)
    page_size: int = 64
    #: pool size in pages; None = max_batch x ceil(max_seq / page_size);
    #: fewer overcommit the pool, and the engine preempts when it runs dry
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
    #: (preempted and mid-walk requests bypass it)
    max_waiting: int = 0
    #: admission policy of the waiting queue (tenants, lanes, rate
    #: limits, starvation preemption); None = ``SchedulerConfig()``
    scheduler: SchedulerConfig | None = None
    #: chunk-walk rounds per admission; unfinished walks resume after a
    #: decode pass of the other slots
    prefill_chunks_per_pass: int = 2
    #: pin retired prompts' page-aligned prefixes for reattachment
    prefix_cache: bool = True
    #: pages the prefix cache may pin; None = a quarter of the pool
    prefix_cache_pages: int | None = None
    #: prefix-cache digest published to the fleet: the newest N cache
    #: keys, hashed (``router.prefix_hash``) at the throttled gauge pass
    #: and carried by heartbeat summaries, so the leader's router scores
    #: hosts by longest resident prefix; 0 disables the digest
    prefix_digest_hashes: int = 64
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
    #: decode dispatches left uncollected after each step: 1 overlaps
    #: the host's token readout, emission and admission with the next
    #: dispatch on the card, at the price of one pass per retirement
    #: that its slot rides out and first tokens one pass late. None =
    #: adaptive: 1 while at least ``pipeline_min_slots`` slots decode,
    #: else 0
    pipeline_depth: int | None = None
    #: decoding slots from which the adaptive depth pipelines
    pipeline_min_slots: int = 8
    #: flight recorder: per-pass records kept in a ring (``/debug/engine``,
    #: ``health_check()``, dumped on a crash or stall); 0 disables
    flight_recorder_size: int = 256
    #: retired requests' summaries kept beside the pass ring
    flight_recorder_requests: int = 32
    #: goodput accounting (useful vs waste causes, conserved against
    #: busy time) and memory high-water marks
    goodput: bool = True
    #: after ``warmup`` seals the shapes it ran, a dispatch of a shape it
    #: never ran bumps ``app_engine_recompiles`` and WARNs once
    recompile_sentinel: bool = True
    #: pass-cost model per dispatch signature, with its drift sentinel
    cost_model: bool = True
    #: EWMA weight of the per-signature cost mean and variance
    cost_alpha: float = 0.2
    #: serving passes per signature before its drift baseline seals
    cost_baseline_passes: int = 32
    #: a drift episode opens when a signature's EWMA exceeds both
    #: baseline x ratio and baseline + sigma x baseline std
    cost_drift_ratio: float = 2.0
    cost_drift_sigma: float = 6.0
    #: output fingerprint of every request, golden probes
    integrity: bool = True
    #: golden corpus (``gofr-golden`` JSONL, ``GoldenSet``); None = no
    #: probes (the fingerprints need none)
    integrity_golden_path: str | None = None
    #: golden entries loaded at most
    integrity_golden_max: int = 8
    #: one golden probe on the background lane every N collected passes;
    #: 0 disables probing
    integrity_probe_passes: int = 0
    #: consecutive clean probes that close a mismatch episode
    integrity_rearm_probes: int = 2
    #: fault plan (``faults.FaultPlan`` or its string); None = the
    #: ``GOFR_FAULTS`` environment variable (unset: no faults)
    faults: Any = None
    #: event ledger: an ``EventLedgerConfig``, an ``EventLedger``,
    #: True / False, or None = the default ledger unless ``GOFR_EVENTS``
    #: is 0 / false / off
    events: Any = None
    #: with work in flight, a loop that has not begun an iteration for
    #: this long is DEGRADED; 0 disables
    stall_threshold_s: float = 120.0
    #: the stall watchdog's polling interval; 0 disables the watchdog
    watchdog_interval_s: float = 5.0
    #: workload capture from construction: every ended request lands in
    #: the capture ring (``GET /debug/workload``); ``POST
    #: /debug/workload/start`` arms it at run time regardless
    workload_capture: bool = False
    #: records the capture ring keeps (the oldest drop, counted); 0
    #: disables the recorder
    workload_capture_requests: int = 4096
    #: captured prompt and completion ids become salted hashes (lengths
    #: kept): shippable, not replayable
    capture_redact: bool = False
    #: anomaly-triggered profiling: a cost drift, an SLO fast burn or a
    #: goodput-floor breach starts a ``torch.profiler`` capture that
    #: stops after ``autoprof_passes`` collected passes or
    #: ``autoprof_max_capture_s``; arms are debounced, and
    #: ``GOFR_AUTOPROF=0`` is the kill switch
    autoprof: bool = True
    autoprof_passes: int = 64
    autoprof_max_capture_s: float = 30.0
    autoprof_debounce_s: float = 300.0
    #: goodput ratio under which the autoprofiler arms (checked with the
    #: gauges once 1 s of busy time is in); 0 disables the floor
    autoprof_goodput_floor: float = 0.0
    #: where its captures land; None = ``gofr_tpu_profiles`` under the
    #: process's temporary directory
    autoprof_dir: str | None = None
    #: crash recovery: a ``RestartPolicy`` arms the supervisor; None keeps
    #: every loop exception terminal (health DOWN)
    restart_policy: RestartPolicy | None = None


class Engine:
    """Continuous batching over (prefill_fn, paged_chunk_fn,
    paged_decode_fn) and, for speculation, paged_verify_fn; or, for a
    family with a dense decode step, over (prefill_fn, decode_fn) on the
    slot layout or through the paged pool's dense view.

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
        without it ``speculative`` serves plain decode.
    prefill_chunk_fn / spec_verify_fn: the dense forms of the two, on
        caches [L, G, S, Hkv, hd] in place of (pools, tables) — e.g.
        ``llama_prefill_chunk`` — for the slot layout and the view.
    decode_fn(params, tokens [B], k_cache, v_cache, lengths [B][,
        attn_window=w]) -> (logits [B, V], k_cache, v_cache) on dense
        caches [L, B, S, Hkv, hd], written in place, a row at or past S
        dropped — e.g. ``moe_decode_step``; used where there is no
        ``paged_decode_fn`` (and on the slot layout, which needs it).
    make_cache(n_pages, page, kv_dtype) -> (k_pool, v_pool) [L, Hkv, Np,
        pg, hd], plain for "bf16", ``{q, s}`` dicts for "int8" (e.g.
        ``make_pool``); on the slot layout it is called as
        ``make_cache(max_batch, max_seq, "bf16", head_major=False)`` for
        the dense caches [L, max_batch, max_seq, Hkv, hd]
        (``make_empty_cache``).
    vocab_size: prompts holding a token id outside [0, vocab_size) fail
        at submit (an out-of-range embedding index would fault on the
        device and take the engine thread down).
    flops_per_token(context) -> float: the model's flops for one decoded
        token attending over ``context`` rows (e.g. ``llama_decode_flops``);
        ``warmup`` fixes the MFU basis from it. None: the MFU gauge stays
        0.
    metrics: a ``metrics.Manager`` (``attach_metrics``); logger: a
        ``logger.Logger`` for the WARNs and the flight recorder's dumps;
        tracer: a ``tracing.Tracer`` for the requests' ``engine.*`` spans
        and the watchdog's ``engine.stall`` span (None: no spans).
    mesh: a tensor-parallel ``parallel.mesh.Mesh`` whose ranks each run
        this engine on their shards (``glue.llama_engine(mesh=)``). With
        more than one rank the mesh's leader broadcasts every device
        operation (an ``_op_<code>`` method) before it runs it
        (``serving/lockstep.py``) and the other ranks' engines are driven
        by ``lockstep.follow``, never started; on ``gloo`` device groups,
        which a graph cannot hold, the decode dispatch runs uncaptured;
        a page's bytes in the ``kv_pool_bytes`` budget are this rank's
        page times ``tp``, so every rank sizes the pool as the unsharded
        engine does. None: one device.
    """

    def __init__(self, params: Any, config: EngineConfig, *,
                 prefill_fn: Callable, make_cache: Callable,
                 device: str | torch.device, vocab_size: int,
                 paged_decode_fn: Callable | None = None,
                 paged_chunk_fn: Callable | None = None,
                 paged_verify_fn: Callable | None = None,
                 decode_fn: Callable | None = None,
                 prefill_chunk_fn: Callable | None = None,
                 spec_verify_fn: Callable | None = None,
                 flops_per_token: Callable[[int], float] | None = None,
                 metrics: Any = None, logger: Any = None,
                 tracer: Any = None, mesh: Any = None) -> None:
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
        if cfg.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be 'slot' or 'paged', got "
                             f"{cfg.kv_layout!r}")
        if cfg.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                             f"{cfg.kv_dtype!r}")
        if cfg.paged_attention not in PAGED_ATTENTION:
            raise ValueError(f"paged_attention must be one of "
                             f"{PAGED_ATTENTION}, got "
                             f"{cfg.paged_attention!r}")
        if cfg.kv_dtype != "bf16" and cfg.kv_layout != "paged":
            raise ValueError("kv_dtype='int8' requires kv_layout='paged' "
                             "(the quantized pool is a page pool; the slot "
                             "layout has no pages)")
        if cfg.kv_pool_bytes is not None and cfg.kv_layout != "paged":
            raise ValueError("kv_pool_bytes sizes the paged pool; set "
                             "kv_layout='paged'")
        #: the paged layout, and on it the native path: the family's
        #: paged steps write through the block tables and attend with the
        #: paged kernels; otherwise the dense functions run on the slot
        #: caches or on the pool's dense view
        self._paged = cfg.kv_layout == "paged"
        self._native = (self._paged and paged_decode_fn is not None
                        and cfg.paged_attention != "view")
        if not self._native and decode_fn is None:
            raise ValueError("the slot layout, and the paged layout without "
                             "a paged_decode_fn or under paged_attention="
                             "'view', need a dense decode_fn")
        self.params = params
        self.config = cfg
        self.device = torch.device(device)
        self.vocab_size = vocab_size
        self._prefill_fn = prefill_fn
        self.mesh = mesh
        #: this rank's tp collectives (``glue.llama_engine(mesh=)``)
        self.tp = None
        self._lockstep = (Lockstep(mesh) if mesh is not None
                          and mesh.control is not None
                          and dist.get_world_size(mesh.control) > 1
                          else None)
        self._kv_shards = mesh.size("tp") if mesh is not None else 1
        self._decode_fn = paged_decode_fn if self._native else decode_fn
        self._chunk_fn = paged_chunk_fn if self._native else prefill_chunk_fn
        self._verify_fn = paged_verify_fn if self._native else spec_verify_fn
        #: speculation is served only with a verify function: without
        #: one ``speculative`` decodes plainly, as in the JAX engine
        self._spec_enabled = cfg.speculative and self._verify_fn is not None
        #: a dispatch's window choices (dense layouts; the slot layout's
        #: decode_fn must take ``attn_window``)
        windows = tuple(sorted({int(w) for w in cfg.decode_windows or ()
                                if 0 < w < cfg.max_seq}))
        if self._native or (not self._paged
                            and not _takes_window(decode_fn)):
            windows = ()
        self._decode_windows = windows
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
        self._make_cache = make_cache
        #: the dtype a quantized pool's view dequantizes to: the model's
        self._view_dtype = None
        if self._paged:
            self._pages_per_slot = -(-cfg.max_seq // pg)
            self._n_pages = self._sized_pool_pages(
                pg, cfg.kv_pages if cfg.kv_pages is not None
                else cfg.max_batch * self._pages_per_slot)
            self.k_cache, self.v_cache = make_cache(self._n_pages, pg,
                                                    cfg.kv_dtype)
            if not self._native:
                self._view_dtype = make_cache(1, pg, "bf16")[0].dtype
        else:
            # no pool: the decode graph's table buffer is one unused
            # column
            self._pages_per_slot, self._n_pages = 1, 0
            self.k_cache, self.v_cache = make_cache(
                cfg.max_batch, cfg.max_seq, "bf16", head_major=False)
        self._free_pages = list(range(self._n_pages))
        #: per-slot ordered page ids; the OOB id n_pages = unallocated
        self._tables = np.full((cfg.max_batch, self._pages_per_slot),
                               self._n_pages, np.int32)
        self._slot_pages = np.zeros(cfg.max_batch, np.int64)
        #: references per page: each slot and each cache entry holding it
        self._page_refs = np.zeros(self._n_pages, np.int32)
        #: sharing prefixes needs page tables and the walk that attaches
        #: them (native, or the view's dense walk)
        self._prefix_enabled = (self._paged and cfg.prefix_cache
                                and self._chunk_fn is not None)
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
        #: rows each slot holds in the cache, advanced at dispatch
        self.lengths = np.zeros(cfg.max_batch, np.int32)
        self.active: list[GenRequest | None] = [None] * cfg.max_batch
        #: next admission order number
        self._admit_seq = 0

        self.seed = (cfg.seed if cfg.seed is not None
                     else int.from_bytes(os.urandom(4), "little"))
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        #: T = K x M steps per decode dispatch, over every slot
        self._tokens_per_pass = (cfg.decode_steps_per_pass
                                 * cfg.decode_passes_per_dispatch)
        depth = (cfg.pipeline_depth if cfg.pipeline_depth is not None
                 else 1)
        self._decode_graph = DecodeGraph(
            self._decode_fn, params, rows=cfg.max_batch,
            max_pages=self._pages_per_slot, n_pages=self._n_pages,
            steps=self._tokens_per_pass, max_seq=cfg.max_seq,
            device=self.device, generator=self._generator,
            ring=max(2, depth + 1),
            layout=("paged" if self._native
                    else "view" if self._paged else "slot"),
            windows=self._decode_windows, page_size=pg,
            view_dtype=self._view_dtype,
            capture=mesh is None or mesh.backend != "gloo")
        #: the device copies of the scheduler arrays / tables are stale
        self._sched_dirty = True
        self._tables_dirty = True
        #: the request each row decoded for in the last dispatch: its
        #: last token is on the device (``use_prev``)
        self._dev_last_reqs: list = [None] * cfg.max_batch
        #: decode dispatches in flight, oldest first
        self._pending: deque[dict] = deque()
        #: batch prefills whose first tokens are in flight
        self._pending_prefills: deque[dict] = deque()
        #: ends of the last collected decode / prefill spans: decode_s
        #: and prefill_s sum the union of the spans, not each span
        self._decode_busy_until = 0.0
        self._prefill_busy_until = 0.0

        self.metrics = metrics
        self.logger = logger
        self.tracer = tracer
        self._flops_fn = flops_per_token
        #: MFU basis, fixed by ``warmup``: None keeps the gauge at 0
        self._flops_per_token: float | None = None
        self._peak_flops: float | None = None
        self.recorder = FlightRecorder(cfg.flight_recorder_size,
                                       cfg.flight_recorder_requests)
        self.goodput = GoodputMeter(cfg.goodput)
        self.watermarks = WatermarkTracker(cfg.goodput)
        self.sentinel = RecompileSentinel(cfg.recompile_sentinel)
        self.costs = CostModel(cfg.cost_model, alpha=cfg.cost_alpha,
                               baseline_passes=cfg.cost_baseline_passes,
                               drift_ratio=cfg.cost_drift_ratio,
                               drift_sigma=cfg.cost_drift_sigma)
        golden = None
        if cfg.integrity and cfg.integrity_golden_path:
            # a missing or corrupt corpus fails here, not mid-incident
            golden = GoldenSet.load(cfg.integrity_golden_path,
                                    limit=cfg.integrity_golden_max)
            # probes skip submit's checks: a token outside the
            # vocabulary would fault on the card
            bad = [e.id for e in golden.entries
                   if not all(0 <= t < vocab_size for t in e.prompt_tokens)]
            if bad:
                raise ValueError(f"golden entries {bad} hold token ids "
                                 f"outside the vocabulary [0, {vocab_size})")
        self.integrity = IntegrityPlane(
            cfg.integrity, golden=golden,
            probe_passes=cfg.integrity_probe_passes,
            rearm_probes=cfg.integrity_rearm_probes)
        # the fleet summary's sources, as the JAX engine wires them: the
        # cost table (straggler math on one signature), the probe
        # digests (the leader's divergence vote), the waste digest and
        # the prefix digest (the router's score)
        if self.costs.enabled:
            self.recorder.cost_source = self.costs.table
        if self.integrity.enabled:
            self.recorder.integrity_source = self.integrity.summary
        if self.goodput.enabled:
            self.recorder.goodput_source = self.goodput.summary
        #: the published prefix digest (a reference swap, read by the
        #: heartbeat thread) and whether the cache changed since
        self._prefix_digest: dict | None = None
        self._prefix_digest_dirty = True
        if cfg.prefix_digest_hashes > 0:
            self.recorder.prefix_digest_source = self.prefix_digest
        #: anomaly-triggered profiling: drift, fast burn and the goodput
        #: floor arm one bounded capture at a time
        capture = (ProfilerCapture(base_dir=cfg.autoprof_dir, logger=logger)
                   if cfg.autoprof else None)
        self.autoprof = AutoProfiler(
            capture, enabled=cfg.autoprof, passes=cfg.autoprof_passes,
            max_capture_s=cfg.autoprof_max_capture_s,
            debounce_s=cfg.autoprof_debounce_s, logger=logger)
        #: the capture ring of ended requests, stamped with the resolved
        #: seed so a replay engine can be built with it
        self.workload = WorkloadRecorder(cfg.workload_capture_requests,
                                         redact=cfg.capture_redact,
                                         engine_seed=self.seed)
        if self.goodput.enabled:
            self.workload.goodput_source = self.goodput.summary
        if self.costs.enabled:
            self.workload.cost_source = self.costs.table
        if cfg.workload_capture:
            self.workload.start()
        #: per-tenant usage, fed at the end of every request
        self.usage_ledger = UsageLedger()
        #: SLO burn-rate tracker; the app attaches one (None = off)
        self.slo = None
        self.faults = resolve_plan(cfg.faults)
        self.events = resolve_ledger(cfg.events, metrics=metrics)
        if self.faults is not NO_FAULTS:
            self.faults.events = self.events
        self.watermarks.events = self.events
        #: incident bundles, each with the timeline around its trigger
        #: and these state blocks
        self.incidents = IncidentDetector(self.events.config,
                                          ledger=self.events, logger=logger)
        self.incidents.sources.update({
            "slo": lambda: self.slo.state() if self.slo is not None
            else None,
            "scheduler": lambda: self.waiting.state(),
            "goodput": self.goodput.state,
            "watermarks": self.watermarks.state,
            "recorder": self.recorder.snapshot,
            "config": self.config_digest,
            "costs": self.cost_state,
            "integrity": self.integrity_state,
        })
        #: the supervisor's state: restarts made, the last crash
        self._restarts = 0
        self._last_crash: str | None = None
        #: the terminal teardown ran (``_shutdown_cleanup``): a start
        #: rebuilds the runtime state first
        self._cleaned = False
        #: the loop's heartbeat: set at the top of every iteration
        self._last_beat = time.time()
        self._watchdog: StallWatchdog | None = None
        self._gauge_wall = time.time()
        self._gauge_tokens = 0
        #: waste seconds already published as counter deltas
        self._waste_published: dict[str, float] = {}
        #: device bytes of the K and V pools, every leaf
        self._kv_bytes_total = sum(
            t.numel() * t.element_size()
            for pool in (self.k_cache, self.v_cache)
            for t in (pool.values() if isinstance(pool, dict) else (pool,)))

        #: the waiting queue: single-tenant traffic leaves it in arrival
        #: order
        self.waiting = Scheduler(
            cfg.scheduler if cfg.scheduler is not None else SchedulerConfig(),
            cfg.max_waiting, ledger=self.usage_ledger,
            slo_source=lambda: self.slo, metrics=metrics, logger=logger)
        self.waiting.events = self.events
        #: admitted work that bounced back (preempted, pool busy, a walk
        #: between its chunks): goes ahead of the waiting queue, past
        #: ``max_waiting``
        self._requeued: list[GenRequest] = []
        self._requeued_set: set[int] = set()
        self._running = False
        #: drain(): admission closed while the work in flight finishes
        self._draining = False
        #: requests taken from the queues by the engine thread and not
        #: yet placed
        self._admitting = False
        self._thread: threading.Thread | None = None
        self._failed: str | None = None
        self._step_count = 0
        self.total_generated = 0
        self.stats = {"prefill_calls": 0, "prefill_s": 0.0,
                      "decode_passes": 0, "decode_s": 0.0,
                      "dispatch_s": 0.0, "collect_s": 0.0,
                      "decode_tokens": 0, "prefix_hits": 0,
                      "prefix_evictions": 0, "preemptions": 0,
                      "requeues": 0, "spec_passes": 0,
                      "spec_s": 0.0, "spec_drafted": 0,
                      "spec_accepted": 0, "spec_rows": 0,
                      "sched_syncs": 0, "h2d_transfers": 0,
                      "graph_captures": 0, "graph_replays": 0,
                      "graph_capture_s": 0.0, "stalls": 0,
                      "recompiles": 0, "cost_drifts": 0,
                      "integrity_failures": 0}
        if metrics is not None:
            self.attach_metrics(metrics)

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
            return 2 * page * pool_row_bytes(k_probe) * self._kv_shards

        budget = (cfg.kv_pool_bytes if cfg.kv_pool_bytes is not None
                  else base_pages * page_bytes("bf16"))
        return max(1, int(budget) // page_bytes(cfg.kv_dtype))

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Start (or restart) the engine thread, and the stall watchdog.
        After a stop or a terminal crash the runtime state is rebuilt
        first (``_reset_runtime_state``) on the resident weights, pools
        and captured graphs, and the queue reopens. A mesh engine starts
        on its leader rank only, and once: its followers were released
        at the stop."""
        if self._running:
            return
        if self._lockstep is not None:
            if not self._lockstep.leader:
                raise RuntimeError("a follower rank of a mesh engine runs "
                                   "lockstep.follow(engine), not start()")
            if self._lockstep.released:
                raise RuntimeError("a mesh engine does not restart: its "
                                   "followers were released at the stop")
        if self._cleaned:
            self._reset_runtime_state()
            self._cleaned = False
            self._failed = None
        self.waiting.reopen()
        self._last_beat = time.time()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gofr-torch-engine")
        self._thread.start()
        if self.config.watchdog_interval_s > 0 and self._watchdog is None:
            self._watchdog = StallWatchdog(
                self, interval_s=self.config.watchdog_interval_s)
            self._watchdog.start()

    def stop(self, join_timeout_s: float = 30.0) -> None:
        """Stop the watchdog, then the thread once its iteration ends (a
        pass in flight is collected and its tokens emitted first);
        queued and active requests fail with "engine stopped". A mesh
        engine then releases its followers."""
        watchdog, self._watchdog = self._watchdog, None
        if watchdog is not None:
            watchdog.stop()
        self._running = False
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=join_timeout_s)
            if thread.is_alive():
                raise RuntimeError("engine thread did not stop within "
                                   f"{join_timeout_s} s")
        if not self._cleaned:
            self._shutdown_cleanup("engine stopped")
        if self._lockstep is not None:
            self._lockstep.release()

    def close(self) -> None:
        """The app's shutdown: stop without waiting long for a pass."""
        self.stop(join_timeout_s=2.0)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: refuse new submits, let queued, requeued
        and in-flight work run to completion, then ``stop()``. True when
        everything retired within ``timeout_s``; False when the deadline
        cut stragglers off (they fail with "engine stopped")."""
        deadline = time.time() + timeout_s
        self._draining = True
        self.events.emit("engine.drain", cause="admission closed",
                         timeout_s=timeout_s)
        try:
            drained = False
            while True:
                if (not self.waiting.qsize() and not self._admitting
                        and not self._requeued and not self._pending
                        and not self._pending_prefills
                        and all(r is None for r in self.active)):
                    drained = True
                    break
                if not self._running or time.time() >= deadline:
                    break
                time.sleep(0.01)
            self.stop(join_timeout_s=max(1.0, deadline - time.time()))
            return drained
        finally:
            self._draining = False

    def cancel(self, req: GenRequest) -> None:
        """Abandon a request (its caller is gone): a waiting request is
        dropped at admission, an active slot retires at the next
        dispatch and its tokens in flight are discarded."""
        req.cancelled = True

    def _op(self, code: str, *args):
        """Run the device operation ``_op_<code>(*args)``; on a mesh's
        leader broadcast it to the followers first (``lockstep.py``)."""
        if self._lockstep is not None:
            if not self._lockstep.leader:
                raise RuntimeError("a follower rank runs its operations "
                                   "through lockstep.follow(engine)")
            self._lockstep.send(code, args)
        return getattr(self, f"_op_{code}")(*args)

    def warmup(self, prompt_lens: tuple = (1,), decode: bool = True,
               chunked: bool = False) -> float:
        """Run the serving shapes once ahead of traffic, before
        ``start()``: the group prefill at every group size of each bucket
        covering ``prompt_lens``; with ``chunked`` (and a chunk function)
        the walk's chunk calls at every bucket width for groups 1 and
        ``prefill_batch``; with ``decode`` both decode graphs (greedy and
        sampled) of the full pass and of every decode window, captured
        on CUDA with every row inactive, so no serving dispatch
        captures; with speculation the verify pass at each power-of-two
        width. Every table is all-OOB (every row of the slot layout a
        dummy), so every K/V write drops: the caches, the free list,
        ``lengths`` and the generator's state are as they were. Every
        shape it runs is observed by the recompile sentinel, which it
        seals; with ``decode`` it fixes the MFU basis: the model's flops
        per token at the full decode graph's context (a slot's whole
        table, ``pages_per_slot x page_size`` rows, or ``max_seq`` on the
        slot layout) and the card's peak. Returns the seconds it
        took. On a mesh every rank runs it (one operation)."""
        if self._running:
            raise RuntimeError("warmup runs before start()")
        return self._op("warmup", tuple(int(n) for n in prompt_lens),
                        bool(decode), bool(chunked))

    def _op_warmup(self, prompt_lens: tuple, decode: bool,
                   chunked: bool) -> float:
        cfg = self.config
        t0 = time.perf_counter()
        generator = self._generator.get_state()

        def oob(rows):
            return self._upload(np.full((rows, self._pages_per_slot),
                                        self._n_pages, np.int32))

        def row_params(rows):
            return (self._upload(np.zeros(rows, np.float32)),
                    self._upload(np.ones(rows, np.float32)),
                    self._upload(np.zeros(rows, np.int64)))

        with torch.no_grad():
            for bucket in sorted({self._bucket_for(int(n))
                                  for n in prompt_lens}):
                for g in self._group_sizes():
                    self.sentinel.observe(self._sig("prefill", bucket, g))
                    kv_len = self._upload(np.ones(g, np.int32))
                    logits, (k, v) = self._prefill_fn(
                        self.params, self._upload(np.zeros((g, bucket),
                                                           np.int64)),
                        kv_len)
                    for greedy in (True, False):
                        sample_batch(logits, *row_params(g),
                                     generator=self._generator,
                                     all_greedy=greedy)
                    if self._paged:
                        scatter_chunk_kv(self.k_cache, self.v_cache, oob(g),
                                         k, v, torch.zeros_like(kv_len),
                                         kv_len)
            if chunked and self._chunk_fn is not None:
                # the view's walk may also take the widest decode window
                largest = self._chunk_window(0, 0)
                for window in (0, largest) if largest else (0,):
                    for width in self._usable_buckets:
                        if window and width > window:
                            continue     # the walk never picks it then
                        for g in sorted({1, max(1, cfg.prefill_batch)}):
                            self.sentinel.observe(self._sig(
                                "chunk", width, g, window or None))
                            zeros = self._upload(np.zeros(g, np.int32))
                            self._run_chunk(
                                self._upload(np.zeros((g, width), np.int64)),
                                [], oob(g), zeros, zeros, window)
            if decode:
                for window in (0, *self._decode_windows):
                    self.sentinel.observe(self._sig("decode", window))
                self._decode_graph.warm(self.k_cache, self.v_cache)
                if self._flops_fn is not None:
                    # the full decode graph attends over a slot's whole
                    # table (the slot layout: its whole cache)
                    self._flops_per_token = float(self._flops_fn(
                        self._pages_per_slot * cfg.page_size if self._paged
                        else cfg.max_seq))
                self._peak_flops = device_peak_flops(self.device)
            if self._spec_enabled:
                b, width = cfg.max_batch, 2
                while True:
                    self.sentinel.observe(self._sig("spec_verify", width))
                    zeros = np.zeros((b, width), np.int64)
                    tokens, depths = self._upload(zeros), self._upload(zeros)
                    tables = oob(b)
                    offsets = self._upload(np.zeros(b, np.int32))
                    lens = self._upload(np.ones(b, np.int32))
                    self._verify_and_compact(
                        tokens, depths, depths,
                        self._upload(np.ones((b, width), np.int32)), [],
                        tables, offsets, lens, row_params(b))
                    if width >= 1 + cfg.spec_draft * cfg.spec_branches:
                        break
                    width *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._generator.set_state(generator)
        self._note_graph_stats()
        self.sentinel.seal()
        return time.perf_counter() - t0

    def health_check(self) -> dict:
        """UP, DOWN (stopped or crashed), or DEGRADED: work in flight and
        no loop iteration begun for ``stall_threshold_s``
        (``stalled_for_s``); ``restarts`` and ``last_crash`` once the
        supervisor restarted the loop."""
        status = "DOWN" if (self._failed or not self._running) else "UP"
        active = sum(r is not None for r in self.active)
        waiting = self.waiting.qsize()
        out = {"status": status, "active_slots": active,
               "waiting": waiting, "steps": self._step_count,
               "total_generated": self.total_generated}
        threshold = self.config.stall_threshold_s
        stalled_for = time.time() - self._last_beat
        if (status == "UP" and threshold > 0 and (active or waiting)
                and stalled_for > threshold):
            out["status"] = "DEGRADED"
            out["stalled_for_s"] = round(stalled_for, 1)
        if self.stats.get("stalls"):
            out["stalls"] = self.stats["stalls"]
        if self._restarts:
            out["restarts"] = self._restarts
        if self._last_crash:
            out["last_crash"] = self._last_crash
        if self._failed:
            out["error"] = self._failed
        if self.recorder.enabled:
            out["flight"] = self.recorder.summary()
        return out

    def config_digest(self) -> dict:
        """JSON-safe summary of the engine's config for incident bundles:
        plain scalars as they are, anything else as its repr; and the
        resolved seed."""
        from dataclasses import fields
        out = {}
        for f in fields(self.config):
            value = getattr(self.config, f.name)
            out[f.name] = value if isinstance(
                value, (bool, int, float, str, type(None))) else repr(value)
        out["resolved_seed"] = self.seed
        return out

    def attach_metrics(self, metrics: Any) -> None:
        """Point the engine at a metrics manager, registering the JAX
        engine's series where absent (with its descriptions and
        buckets; ``app_tpu_execute_seconds`` is
        ``app_gpu_execute_seconds`` here), and hand it to the usage
        ledger, the SLO tracker, the scheduler and the event ledger."""
        self.metrics = metrics
        for name, desc in (
            ("app_engine_active_slots", "occupied decode slots"),
            ("app_engine_waiting", "requests queued for admission"),
            ("app_engine_kv_pool_utilization",
             "fraction of KV capacity in use (slots + prefix cache)"),
            ("app_engine_kv_pool_fragmentation",
             "fraction of allocated KV page capacity holding no rows"),
            ("app_engine_prefix_cache_entries",
             "prefix-cache entries pinned"),
            ("app_engine_prefix_cache_pages",
             "page references pinned by the prefix cache"),
            ("app_engine_tokens_per_second",
             "generated tokens per second (quarter-second window)"),
            ("app_engine_mfu",
             "decode-path model FLOPs utilization (model FLOPs per "
             "token x tokens/s over the card's peak; 0 when the peak or "
             "the model's cost is unknown)"),
            ("app_engine_goodput_ratio",
             "useful device time over total busy device time "
             "(1 - waste; see app_engine_waste_seconds for the causes)"),
            ("app_engine_kv_pages_watermark",
             "high-water mark of KV pool pages in use (paged layout)"),
            ("app_engine_kv_rows_watermark",
             "high-water mark of live KV rows (slot layout)"),
            ("app_engine_prefix_pages_watermark",
             "high-water mark of page references pinned by the prefix "
             "cache"),
            ("app_engine_kv_bytes_watermark",
             "high-water mark of KV-pool HBM bytes held by in-use "
             "pages/rows (scale leaves included for int8 pools)"),
            ("app_engine_host_rss_bytes_watermark",
             "host process RSS high-water mark (ru_maxrss)"),
            ("app_engine_spec_accept_rate",
             "lifetime speculative draft acceptance rate "
             "(accepted/drafted; 1.0 before any drafting)"),
        ):
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        for name, desc in (
            ("app_engine_h2d_transfers",
             "host->device scheduler-state uploads by the decode "
             "path (event-driven; zero per steady-state pass)"),
            ("app_engine_preemptions",
             "requests preempted (vLLM-style recompute requeue)"),
            ("app_engine_prefix_evictions",
             "prefix-cache entries evicted under pool pressure"),
            ("app_engine_requeues",
             "admitted work bounced back to the requeue list "
             "(chunk-walk pacing, slot races, preemption)"),
            ("app_engine_spec_drafted",
             "draft tokens offered to speculative verify"),
            ("app_engine_spec_accepted",
             "draft tokens accepted by speculative verify"),
            ("app_engine_stalls",
             "stall episodes escalated by the watchdog (work in "
             "flight, no pass for stall_threshold_s)"),
            ("app_replay_divergence",
             "replayed requests whose token stream diverged from the "
             "recorded completion (serving/replay.py)"),
            ("app_tenant_requests",
             "retired requests by tenant and status (ok/error/"
             "cancelled)"),
            ("app_tenant_prompt_tokens", "prompt tokens by tenant"),
            ("app_tenant_completion_tokens",
             "generated tokens by tenant"),
            ("app_tenant_device_seconds",
             "device busy time attributed to each tenant (per-request "
             "share of every pass's busy span)"),
            ("app_tenant_waste_seconds",
             "per-tenant attributable waste device time by cause "
             "(preempt_recompute, spec_rejected)"),
            ("app_engine_waste_seconds",
             "busy device time classified as waste, by cause (padding/"
             "preempt_recompute/spec_rejected/bubble); useful + waste "
             "== busy is conserved"),
            ("app_engine_recompiles",
             "post-warmup dispatches of a shape warmup never ran, "
             "detected by the dispatch-shape sentinel"),
            ("app_engine_cost_drift",
             "pass-cost drift episodes by dispatch kind: a signature's "
             "cost EWMA departed its sealed baseline past the "
             "configured ratio/sigma thresholds (serving/costmodel.py)"),
            ("app_engine_integrity_failures",
             "golden canary probe digest mismatch episodes by kind: "
             "this host produced output whose fingerprint departed the "
             "sealed golden digest (serving/integrity.py)"),
            ("app_engine_restarts",
             "engine loop restarts by the in-thread crash-recovery "
             "supervisor (EngineConfig.restart_policy)"),
            ("app_engine_requests_recovered",
             "pre-first-token requests salvaged into the recovery "
             "buffer and replayed across an engine restart"),
        ):
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)
        for name, desc in (
            ("app_slo_burn_rate",
             "error-budget burn rate by window (1 = spending the "
             "budget at exactly the sustainable pace)"),
            ("app_slo_error_budget_remaining",
             "fraction of the availability error budget left over "
             "SLOConfig.budget_window_s"),
            ("app_sched_lane_depth",
             "queued requests per scheduler lane (interactive/"
             "background)"),
            ("app_sched_tenant_share",
             "per-tenant fraction of windowed device time "
             "(the fair-share dequeue signal)"),
            ("app_sched_shed_active",
             "1 while a burn-rate shed episode is active"),
        ):
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        for name, desc in (
            ("app_sched_rejections",
             "admission refusals by cause (queue_full/rate_limited/"
             "shed) and tenant"),
            ("app_sched_preemptions",
             "scheduler-initiated background preemptions to unstarve "
             "the interactive lane (priced by the preempt_recompute "
             "goodput ledger)"),
            ("app_events_total",
             "event-ledger records by kind (serving/events.py)"),
            ("app_events_dropped",
             "event-ledger ring evictions by kind — a truncated "
             "timeline is visible, never silent"),
        ):
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)
        ttft_buckets = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.15,
                        0.25, 0.5, 1, 2, 5)
        for name, desc, buckets in (
            ("app_chat_ttft_seconds", "time to first token",
             ttft_buckets),
            ("app_chat_queue_seconds",
             "submit -> first slot assignment (admission queue wait)",
             ttft_buckets),
            ("app_chat_e2e_seconds", "submit -> finish wall time",
             (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)),
            ("app_chat_tpot_seconds",
             "per-request mean inter-token latency (time per output "
             "token past the first)",
             (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
              0.25, 0.5, 1)),
            ("app_engine_batch_occupancy",
             "active decode slots per pass",
             (1, 2, 4, 8, 16, 32, 64, 128, 256)),
            ("app_gpu_execute_seconds", "device execute wall time",
             (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
              0.25, 0.5, 1, 5)),
            ("app_tenant_queue_seconds",
             "admission queue wait by tenant", ttft_buckets),
            ("app_tenant_e2e_seconds",
             "submit -> finish wall time by tenant",
             (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)),
        ):
            if metrics.get(name) is None:
                metrics.new_histogram(name, desc, buckets=buckets)
        if self.usage_ledger.metrics is None:
            self.usage_ledger.metrics = metrics
        if self.slo is not None and self.slo.metrics is None:
            self.slo.metrics = metrics
        if self.waiting.metrics is None:
            self.waiting.metrics = metrics
        if self.events.enabled and self.events.metrics is None:
            self.events.metrics = metrics

    # -------------------------------------------------------------- submit
    def _clamp_prompt(self, tokens: list[int], max_new: int) -> list[int]:
        """Keep the tail of an over-long prompt, reserving room to
        generate. With a chunk function the walk takes prompts wider
        than every bucket, so the cache is the only cap; without one the
        widest prefill bucket caps admission too."""
        room = max(1, min(max_new, self.config.max_seq // 2))
        limit = max(1, self.config.max_seq - room - 1)
        if self._chunk_fn is None:
            limit = min(limit, self._usable_buckets[-1])
        return tokens[-limit:] if len(tokens) > limit else tokens

    def submit(self, prompt_tokens: list[int],
               params: SamplingParams | None = None, *,
               traceparent: str | None = None,
               tenant: str | None = None,
               lane: str = "interactive") -> GenRequest:
        """Queue a request from any thread, for ``tenant`` (an
        accounting label; None = anonymous) in the scheduler's ``lane``
        ("interactive" or "background"). Its ``done`` event is set and
        its ``out_queue`` closed when it retires or fails (``error``
        set; a refused admission also stamps a typed ``reject``: the
        scheduler's, ``kv_exhausted``, ``draining``, or ``engine_down``
        when the engine is stopped or crashed). With a tracer, the
        request joins the caller's trace: the span active on this
        thread, else a sampled ``traceparent``."""
        params = params or SamplingParams()
        req = GenRequest(
            prompt_tokens=self._clamp_prompt(list(prompt_tokens),
                                             params.max_new_tokens),
            params=params, tenant=tenant, lane=lane)
        if self.tracer is not None:
            parent = self.tracer.current_span()
            if parent is not None:
                if parent.sampled:
                    req.trace = (parent.trace_id, parent.span_id)
            elif traceparent:
                remote = extract_traceparent(traceparent)
                if remote is not None and _traceparent_sampled(traceparent):
                    req.trace = remote
        if not req.prompt_tokens:
            self._fail(req, "empty prompt")
            return req
        if not all(0 <= t < self.vocab_size for t in req.prompt_tokens):
            self._fail(req, f"prompt token outside the vocabulary "
                            f"[0, {self.vocab_size})")
            return req
        if self.faults is not NO_FAULTS and self.faults.trip(
                "page_exhaustion", request_id=req.tenant):
            # injected KV-pool exhaustion: a typed, retryable refusal;
            # the engine serves on
            self._refuse(req, "kv_exhausted",
                         "kv page pool exhausted; retry shortly",
                         retry_after_s=1.0)
        elif self._draining:
            self._refuse(req, "draining",
                         "engine draining for shutdown; retry against "
                         "another replica", retry_after_s=5.0)
        elif not self.waiting.put(req):
            # a policy refusal (queue full, rate limited) stamps a typed
            # reject; a closed queue (a stopped or crashed engine) gets
            # the lifecycle's own code
            if req.reject is not None and self._running:
                self._fail(req, req.reject.message)
            elif self._running:
                self._fail(req, "engine overloaded: waiting queue full")
            else:
                policy = self.config.restart_policy
                retry = (policy.backoff_for(self._restarts + 1)
                         if policy is not None else 1.0)
                self._refuse(
                    req, "engine_down", "engine not accepting requests"
                    + (f" (last crash: {self._last_crash})"
                       if self._last_crash else ""),
                    retry_after_s=max(1.0, retry))
        return req

    def submit_sync(self, prompt_tokens: list[int],
                    params: SamplingParams | None = None,
                    timeout_s: float | None = None) -> GenRequest:
        """Blocking submit; returns when the request finished."""
        req = self.submit(prompt_tokens, params)
        if not req.done.wait(timeout_s):
            raise TimeoutError(f"request not finished within {timeout_s} s")
        return req

    def stream_request(self, req: GenRequest,
                       timeout_s: float | None = None):
        """The token ids of a submitted request as the engine emits
        them, ending when the request ends (then check ``req.error``).
        With ``timeout_s``, a wait that outlasts it yields ``None`` (no
        token yet) and the stream goes on: the caller may look around
        (is its client still there?) and keep iterating. Closing the
        generator before the end cancels the request."""
        try:
            while True:
                try:
                    token = req.out_queue.get(timeout=timeout_s)
                except queue.Empty:
                    yield None
                    continue
                if token is None:
                    return
                yield token
        finally:
            if req.finished_at is None:
                self.cancel(req)

    # ---------------------------------------------------------------- loop
    def _loop(self) -> None:
        try:
            with torch.no_grad():
                while self._running:
                    self._last_beat = time.time()
                    if self.faults is not NO_FAULTS:
                        # armed only with a plan: a raise ends the loop
                        # below, a stall or latency sleeps here
                        self.faults.trip("pass_raise")
                        self.faults.trip("pass_stall")
                        self.faults.trip("pass_latency")
                    self._admit()
                    if any(r is not None for r in self.active):
                        self._step()
                    else:
                        # nothing active: settle any pass in flight so
                        # its last tokens reach their requests
                        self._drain_pending()
                    self._collect_prefills()
                    self._update_gauges()
                # a clean stop with work in flight: those tokens are
                # real, so they are emitted before anything is failed
                self._drain_pending()
                self._collect_prefills()
        except Exception as exc:  # noqa: BLE001 — boundary: contain it
            if self._recover(exc):
                # rebuilt on the resident weights, pools and graphs: serve
                # on, the recovered requests first (the recursion is
                # bounded by the restart budget)
                self._loop()
            else:
                self._crash(exc)

    def _recover(self, exc: BaseException) -> bool:
        """The in-thread supervisor: with a ``restart_policy`` and budget
        left, salvage what can be salvaged, rebuild the runtime state,
        sleep the policy's backoff and return True so ``_loop`` resumes.
        False (the crash is terminal): no policy, the engine was
        stopping, the budget is spent, or the card reports a sticky
        error; the last two open a ``restart_budget`` incident bundle.

        Salvage (no token is ever emitted twice): a request with no
        first token yet replays from its prompt through the requeued
        lane (``recovered``); a mid-stream one fails with a typed
        ``engine_restart`` reject (503 + Retry-After); a cancelled one
        closes."""
        policy = self.config.restart_policy
        if policy is None or not self._running or self._lockstep is not None:
            # a mesh rank's state cannot be rebuilt alone
            return False
        if self._restarts >= policy.max_restarts:
            self.incidents.trigger(
                "restart_budget",
                cause=f"{self._restarts} restarts >= budget "
                      f"{policy.max_restarts}; last crash: "
                      f"{type(exc).__name__}: {exc}")
            return False
        try:
            # before any slot is touched: a dead context must not spend
            # the budget on restarts that cannot serve
            self._reset_runtime_state()
        except DeviceLost as lost:
            self.incidents.trigger(
                "restart_budget",
                cause=f"restart refused: {lost}; last crash: "
                      f"{type(exc).__name__}: {exc}")
            return False
        self._restarts += 1
        self._last_crash = f"{type(exc).__name__}: {exc}"
        backoff = policy.backoff_for(self._restarts)
        if self.logger is not None:
            self.logger.error(
                f"engine loop crashed ({self._last_crash}); restarting "
                f"{self._restarts}/{policy.max_restarts} after "
                f"{backoff:.2f}s backoff")
            self.recorder.dump(self.logger, reason=self._last_crash)
        if self.metrics is not None:
            self.metrics.increment_counter("app_engine_restarts")
        self.events.emit("engine.restart", severity="error",
                         cause=self._last_crash, restart=self._restarts,
                         max_restarts=policy.max_restarts,
                         backoff_s=round(backoff, 3))
        recovered = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.active[i] = None
            if req.finished_at is not None:
                continue
            if req.cancelled:
                req.finished_at = time.time()
                self._finalize_obs(req)
                req._end()
            elif req.first_token_at is None:
                req.pending_prefill = False
                req.prefill_epoch += 1
                req.prefill_offset = 0
                req.slot = -1
                req.recovered = True
                self._requeue(req)
                recovered += 1
            else:
                req.reject = SchedReject(
                    code="engine_restart", tenant=req.tenant,
                    retry_after_s=max(1.0, backoff),
                    detail="engine restarted mid-stream; the partial "
                           "output is stale — retry the request")
                self._fail(req, req.reject.message)
        if recovered:
            if self.metrics is not None:
                self.metrics.add_counter("app_engine_requests_recovered",
                                         float(recovered))
            if self.logger is not None:
                self.logger.warn(f"recovery buffer: {recovered} request(s) "
                                 "replay after restart")
        deadline = time.time() + backoff
        while self._running and time.time() < deadline:
            # a stop() during the backoff resumes the loop, which then
            # exits through the clean path
            time.sleep(min(0.05, max(0.0, deadline - time.time())))
        self._last_beat = time.time()
        self.events.emit("engine.recovery", cause=self._last_crash,
                         restart=self._restarts, recovered=recovered)
        return True

    def _crash(self, exc: BaseException) -> None:
        """The loop threw and no restart follows: health goes DOWN, every
        request in flight or queued fails, submits are refused; the
        crash is recorded as an ``engine.crash`` event and logged with
        the flight recorder's ring."""
        self._failed = f"{type(exc).__name__}: {exc}"
        self._running = False
        self.events.emit("engine.crash", severity="error",
                         cause=self._failed, restarts=self._restarts)
        if self.logger is not None:
            self.logger.error(f"engine loop crashed: {exc!r}")
            self.recorder.dump(self.logger, reason=self._failed)
        self._shutdown_cleanup(f"engine crashed: {self._failed}")
        if self._lockstep is not None:
            self._lockstep.release("abort")

    def _admit(self) -> None:
        """One admission round: the requeued lane goes first (mid-walk
        resumes keep their slot and take no free one), then up to
        ``free - needing_slots`` requests from the waiting queue, waiting
        up to 50 ms for one when the engine is idle. Cancelled requests
        are dropped here; the rest go to ``_admit_batch``."""
        free = sum(1 for r in self.active if r is None)
        if free == 0 and not self._requeued:
            # a full batch: an interactive request starving behind
            # background work may take the newest background slot
            if not self._sched_starvation_preempt():
                return
            free = sum(1 for r in self.active if r is None)
        busy = free < self.config.max_batch
        try:
            batch = self._requeued
            # set before the lane empties, so drain() never sees the
            # requests nowhere
            self._admitting = bool(batch)
            self._requeued = []
            self._requeued_set.clear()
            needing_slots = sum(
                1 for r in batch
                if not (r.pending_prefill and r.slot >= 0
                        and self.active[r.slot] is r))
            take = free - needing_slots
            if take > 0:
                batch += self._pop_waiting(
                    take, 0.0 if (busy or batch) else 0.05)
            live = []
            for r in batch:
                if not r.cancelled:
                    live.append(r)
                elif (r.pending_prefill and r.slot >= 0
                      and self.active[r.slot] is r):
                    self._retire(r.slot)          # mid walk: free the slot
                elif r.finished_at is None:
                    r.finished_at = time.time()
                    self._finalize_obs(r)
                    r._end()
            if live:
                self._admit_batch(live)
        finally:
            self._admitting = False

    def _pop_waiting(self, n: int, wait_s: float) -> list[GenRequest]:
        """Up to ``n`` waiting requests in the scheduler's order, waiting
        up to ``wait_s`` for the first one."""
        if self.waiting.qsize():
            # set before the queue empties, so drain() never sees the
            # requests nowhere
            self._admitting = True
        popped = self.waiting.pop_batch(
            n, first_wait_s=wait_s if self._running else 0.0) or []
        if popped:
            self._admitting = True
        return popped

    @hot_path_boundary(
        "starvation-triggered preemption decision at the admission "
        "boundary; rate-capped by the scheduler, not steady-state")
    def _sched_starvation_preempt(self) -> bool:
        """With the batch full: when the scheduler reports an
        interactive request starving (``starvation_s``, rate-capped by
        ``preempt_min_interval_s``), preempt the newest decoding
        background slot by recompute and hand its request back to the
        scheduler at the head of its lane (``readmit``), not to the
        requeued lane, which would give it the freed slot straight
        back. True when a slot was freed."""
        sched = self.waiting
        if not sched.starving_interactive():
            return False
        victims = [i for i, r in enumerate(self.active)
                   if r is not None and not r.pending_prefill
                   and not r.cancelled and r.lane == "background"]
        if not victims:
            return False
        slot = max(victims, key=lambda i: (self.active[i].admit_order,
                                           self.active[i].submitted_at))
        req = self.active[slot]
        self._preempt(slot)
        if id(req) in self._requeued_set:
            self._requeued_set.discard(id(req))
            self._requeued = [r for r in self._requeued if r is not req]
            sched.readmit(req)
        sched.note_preempted()
        return True

    @hot_path_boundary(
        "terminal error path; observability assembly mirrors _retire")
    def _fail(self, req: GenRequest, error: str) -> None:
        req.error = error
        req.finished_at = time.time()
        self._finalize_obs(req)
        req._end()

    @hot_path_boundary(
        "lifecycle refusal path (drain/crash window), not steady-state")
    def _refuse(self, req: GenRequest, code: str, detail: str, *,
                retry_after_s: float = 1.0) -> None:
        """Fail ``req`` with a typed reject, the scheduler's
        :class:`SchedReject` shape (the handlers answer 503 with
        ``Retry-After`` and ``details.code``); a typed reject stays out
        of the SLO burn."""
        req.reject = SchedReject(code=code, tenant=req.tenant,
                                 retry_after_s=retry_after_s, detail=detail)
        self._fail(req, req.reject.message)

    def _shutdown_cleanup(self, reason: str) -> None:
        """Terminal teardown (a stop, or a crash without a restart): the
        queue closes (submits are refused until ``start()``), every
        queued, requeued and active request fails with ``reason``, and an
        armed autoprofiler capture stops (the process holds one
        ``torch.profiler`` session, and no pass would count it down)."""
        self._cleaned = True
        self.autoprof.finish()
        self.waiting.close()
        waiting = self.waiting.pop_batch(1 << 16, first_wait_s=0.0) or []
        requeued, self._requeued = self._requeued, []
        self._requeued_set.clear()
        self._discard_in_flight()
        for i, req in enumerate(self.active):
            if req is not None:
                self.active[i] = None
                self._release_pages(i)
                self.lengths[i] = 0
                self._fail(req, reason)
        for req in waiting + requeued:
            if req.finished_at is None:
                self._fail(req, reason)

    def _discard_in_flight(self) -> None:
        """Drop the records of work that will not be collected: each
        decode dispatch's ring buffer is freed (``DecodeGraph.discard``),
        the prefills' first tokens are dropped, and every device-resident
        state buffer (rows, the last tokens' lineage, the tables) is
        marked for upload."""
        while self._pending:
            self._decode_graph.discard(self._pending.popleft()["handle"])
        self._pending_prefills.clear()
        self._dev_last_reqs = [None] * self.config.max_batch
        self._sched_dirty = True
        self._tables_dirty = True

    def _reset_runtime_state(self) -> None:
        """Stand the runtime back up on the resident weights, pools and
        captured graphs (``start()`` after a stop, and the supervisor):
        nothing in flight, a pristine page allocator (the prefix cache
        empty), every slot's length 0, each slot's speculation state
        void. The pools are never reallocated: the captured decode
        graphs write them by address.

        Unlike the JAX engine it synchronises the card after discarding
        the dispatches in flight and before any page is handed out again,
        so nothing still running writes a page its next owner holds. A
        sync that raises means a sticky CUDA error (every later call on
        this context fails too): it raises :class:`DeviceLost`."""
        self._discard_in_flight()
        self._decode_busy_until = 0.0
        self._prefill_busy_until = 0.0
        if self.device.type == "cuda":
            try:
                torch.cuda.synchronize(self.device)
            except Exception as exc:  # noqa: BLE001 — reported as lost
                raise DeviceLost(f"CUDA context unusable: {exc}") from exc
        if self._paged:
            self._reset_pages()
        else:
            # in place: the captured decode graphs hold their addresses
            self.k_cache.zero_()
            self.v_cache.zero_()
        self.lengths[:] = 0
        self._spec_ctrl_owner = [None] * self.config.max_batch

    def _reset_pages(self) -> None:
        """Every page free, every table out of range, the prefix cache
        empty."""
        self._free_pages = list(range(self._n_pages))
        self._tables[:] = self._n_pages
        self._slot_pages[:] = 0
        self._page_refs[:] = 0
        self._prefix_cache.clear()
        self._prefix_lens.clear()
        self._cached_pages = 0
        self._prefix_digest_dirty = True
        self._tables_dirty = True

    def _kv_lost(self) -> bool:
        """True when a failed call left the card unusable (a sticky CUDA
        error: every slot's K/V is unreadable). Torch pools are written
        in place and never consumed by a call, unlike the JAX engine's
        donated caches, so a failure that left the card healthy lost
        nothing but its own rows."""
        if self.device.type != "cuda":
            return False
        try:
            torch.cuda.synchronize(self.device)
            return False
        except Exception:  # noqa: BLE001 — the answer is "lost"
            return True

    @hot_path_boundary(
        "device-loss recovery path: the engine is already off the fast "
        "path when this runs")
    def _recover_lost_cache(self, exc: BaseException) -> None:
        """After a failed prefill: if the cache went with it
        (``_kv_lost``), fail every active stream honestly and reset the
        allocator (the pools stay: the decode graphs hold their
        addresses); the next device call then reaches the supervisor."""
        if not self._kv_lost():
            return
        for i, other in enumerate(self.active):
            if other is not None:
                self.active[i] = None
                self._fail(other, f"kv cache lost to failed prefill: {exc}")
        self.lengths[:] = 0
        self._sched_dirty = True
        if self._paged:
            self._reset_pages()

    # ------------------------------------------------------------- pages
    def _decref_page(self, page: int) -> None:
        self._page_refs[page] -= 1
        if self._page_refs[page] <= 0:
            self._page_refs[page] = 0
            self._free_pages.append(page)

    @hot_path_boundary(
        "pool-pressure eviction event; runs only after an allocation "
        "already missed")
    def _evict_prefix_entries(self, pages_needed: int) -> None:
        """Drop cache entries, least recently used first, until the free
        list holds ``pages_needed`` pages or the cache is empty."""
        while len(self._free_pages) < pages_needed and self._prefix_cache:
            key = next(iter(self._prefix_cache))
            pages = self._prefix_cache.pop(key)
            self.stats["prefix_evictions"] += 1
            if self.metrics is not None:
                self.metrics.increment_counter("app_engine_prefix_evictions")
            count = self._prefix_lens[len(key)] - 1
            if count:
                self._prefix_lens[len(key)] = count
            else:
                del self._prefix_lens[len(key)]
            self._cached_pages -= len(pages)
            self._prefix_digest_dirty = True
            for page in pages:
                self._decref_page(page)

    def _alloc_pages(self, slot: int, rows: int) -> bool:
        """Grow ``slot``'s table to cover ``rows`` logical rows (at most
        ``max_seq``'s pages), evicting cached prefixes if the free list
        is short; False when even that does not cover it (the caller
        preempts or requeues)."""
        need = min(-(-rows // self.config.page_size), self._pages_per_slot)
        have = int(self._slot_pages[slot])
        if need <= have:
            return True
        if need - have > len(self._free_pages):
            self._evict_prefix_entries(need - have)
        if need - have > len(self._free_pages):
            return False
        for i in range(have, need):
            page = self._free_pages.pop()
            self._tables[slot, i] = page
            self._page_refs[page] = 1
        self._slot_pages[slot] = need
        self._tables_dirty = True
        return True

    def _release_pages(self, slot: int) -> None:
        if not self._paged:
            return             # the slot layout's rows are the slot's own
        n = int(self._slot_pages[slot])
        if n:
            self._tables_dirty = True
        for i in range(n):
            self._decref_page(int(self._tables[slot, i]))
        self._tables[slot, :] = self._n_pages
        self._slot_pages[slot] = 0

    def _ensure_headroom(self, slot: int, rows: int) -> bool:
        """Allocate ``slot``'s pages for ``rows`` rows, preempting the
        newest request younger than its own as often as needed: an older
        request, closer to completion, is never evicted for a newer one.
        False when no younger victim is left and the pool still cannot
        cover it (the caller preempts ``slot`` itself)."""
        mine = self.active[slot].admit_order
        while not self._alloc_pages(slot, rows):
            victims = [i for i, r in enumerate(self.active)
                       if r is not None and i != slot
                       and r.admit_order > mine]
            if not victims:
                return False
            self._preempt(max(victims,
                              key=lambda i: self.active[i].admit_order))
        return True

    @hot_path_boundary(
        "event-driven eviction; its host work is amortized over the "
        "recompute prefill it schedules, not paid per pass")
    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request and keep it alive: its pages go back
        now, and it re-enters the requeued lane with its original prompt
        + every token it emitted as its prompt, whose prefill recomputes
        its K/V at the same positions and samples its next token
        (preemption by recompute).
        Its device-token lineage and any batch prefill in flight for it
        (``prefill_epoch``) are cut off."""
        req = self.active[slot]
        if req is None:
            return
        self.stats["preemptions"] += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_engine_preemptions")
        self._dev_last_reqs[slot] = None
        self._sched_dirty = True
        req.pending_prefill = False
        req.prefill_epoch += 1
        self.active[slot] = None
        self.lengths[slot] = 0
        self._release_pages(slot)
        # the continuation is what the cache held: the prompt and every
        # token emitted, each once (an earlier preemption folded some in
        # already; the JAX engine appends them all again, ROADMAP Queue C)
        # — at most max_seq rows, and the walk takes any width, so
        # nothing is cut in practice; without a walk the widest prefill
        # bucket cuts it, as in the JAX engine
        req.prompt_tokens = (list(req.prompt_tokens)
                             + list(req.generated[req.folded:]))
        req.folded = len(req.generated)
        limit = self.config.max_seq if self._chunk_fn is not None \
            else self._usable_buckets[-1]
        if len(req.prompt_tokens) > limit:
            req.prompt_tokens = req.prompt_tokens[-limit:]
        # the chunks walked are gone with the pages: a cached prefix may
        # attach again at re-admission
        req.prefill_offset = 0
        self._requeue(req)

    @hot_path_boundary(
        "event-driven backpressure bookkeeping (admission races, pool "
        "pressure), not steady-state")
    def _requeue(self, req: GenRequest) -> None:
        if id(req) not in self._requeued_set:
            self._requeued_set.add(id(req))
            self._requeued.append(req)
            self.stats["requeues"] += 1
            if self.metrics is not None:
                self.metrics.increment_counter("app_engine_requeues")

    # ------------------------------------------------------ prefix cache
    def _probe_prefix(self, prompt: list[int]) -> int:
        """Rows covered by the longest cached prefix of ``prompt`` (0 =
        miss), leaving at least one token to compute: the first sample
        needs a position to come from."""
        if not self._prefix_enabled:
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
        # the LRU order changed: the digest hashes the newest keys
        self._prefix_digest_dirty = True
        for i, page in enumerate(pages):
            self._tables[slot, i] = page
            self._page_refs[page] += 1
        self._slot_pages[slot] = len(pages)
        self._tables_dirty = True
        self.stats["prefix_hits"] += 1

    def _register_prefix(self, slot: int, req: GenRequest) -> None:
        """At retire: pin the page-aligned prompt prefix (leaving its
        last token out, as a probe does), or the longest aligned part
        of it that the budget still allows. Decode wrote only past the
        prompt, so these pages hold exactly the prefix's K/V."""
        if not self._prefix_enabled:
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
        self._prefix_digest_dirty = True

    @hot_path_boundary(
        "prefix-digest assembly at the throttled gauge cadence: host-"
        "side hashing over cache keys already resident, skipped "
        "entirely unless a cache mutation set the dirty flag, published"
        " by atomic reference swap for the heartbeat thread")
    def _refresh_prefix_digest(self) -> None:
        """Rebuild the fleet router's digest if the prefix cache changed
        since the last gauge pass: one truncated content hash per
        resident cache key (the newest ``prefix_digest_hashes``: the LRU
        end the router should bet on), published by reference swap."""
        if not self._prefix_digest_dirty:
            return
        self._prefix_digest_dirty = False
        limit = max(0, int(self.config.prefix_digest_hashes))
        if not self._prefix_enabled or not limit:
            self._prefix_digest = None
            return
        keys = list(self._prefix_cache)
        if len(keys) > limit:
            keys = keys[-limit:]
        self._prefix_digest = {
            "page": int(self.config.page_size),
            "entries": len(self._prefix_cache),
            "pages": int(self._cached_pages),
            "hashes": [prefix_hash(k) for k in keys],
        }

    def prefix_digest(self) -> dict | None:
        """The latest published digest (a reference read, safe from the
        heartbeat thread); None when disabled or without a cache."""
        return self._prefix_digest

    # ----------------------------------------------------------- admission
    def _free_slot(self) -> int:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return -1

    def _admit_batch(self, reqs: list[GenRequest]) -> None:
        """Place a burst: walkers resume in the slot they hold (or a new
        one, from scratch, when theirs was taken back); a prompt with a
        cached prefix attaches it and walks its suffix; a prompt wider
        than every bucket walks; the rest prefill in bucket groups of at
        most ``prefill_batch``. A request that finds no slot goes back
        to the requeued lane."""
        by_bucket: dict[int, list[GenRequest]] = {}
        walkers: list[tuple[GenRequest, int]] = []
        widest = self._usable_buckets[-1]

        def reserve_for_walk(req: GenRequest, slot: int) -> None:
            # hold the slot now: the walkers go after the bucket groups,
            # which must not be handed it
            self.active[slot] = req
            req.slot = slot
            walkers.append((req, slot))

        for req in reqs:
            if req.finished_at is not None:
                continue                     # failed or retired since
            if (not req.pending_prefill and req.slot >= 0
                    and self.active[req.slot] is req):
                continue                     # already serving
            if req.pending_prefill:          # resuming a walk
                if req.slot >= 0 and self.active[req.slot] is req:
                    walkers.append((req, req.slot))
                else:                        # its slot was taken back
                    slot = self._free_slot()
                    if slot < 0:
                        self._requeue(req)
                    else:
                        reserve_for_walk(req, slot)
                continue
            if req.prefill_offset == 0:
                covered = self._probe_prefix(req.prompt_tokens)
                if covered:
                    slot = self._free_slot()
                    if slot < 0:
                        self._requeue(req)
                    else:
                        self._attach_prefix(slot, req.prompt_tokens, covered)
                        req.prefill_offset = covered
                        reserve_for_walk(req, slot)
                    continue
            if len(req.prompt_tokens) > widest:
                slot = self._free_slot()
                if slot < 0:
                    self._requeue(req)
                else:
                    reserve_for_walk(req, slot)
                continue
            by_bucket.setdefault(self._bucket_for(len(req.prompt_tokens)),
                                 []).append(req)
        p_max = max(1, self.config.prefill_batch)
        for bucket, group in by_bucket.items():
            for i in range(0, len(group), p_max):
                self._prefill_group(bucket, group[i:i + p_max])
        if walkers:
            self._walk_chunks(walkers)
        # below the pipelining threshold TTFT is the scarce resource:
        # take the first tokens now, not after the next decode pass
        if self._pending_prefills and self._pipeline_depth() == 0:
            self._collect_prefills()

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

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On CUDA it goes through
        pinned memory without blocking the host (the pinned block is not
        reused before its copy has run), so the call that follows does
        not wait for the work in flight on the card."""
        tensor = torch.from_numpy(array)
        if self.device.type != "cuda":
            return tensor
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def _row_arrays(self, reqs: list, n: int) -> tuple:
        """The sampling parameters of ``n`` rows (pad rows greedy) as host
        arrays: (temps, top_ps, top_ks)."""
        temps = np.zeros(n, np.float32)
        top_ps = np.ones(n, np.float32)
        top_ks = np.zeros(n, np.int64)
        for row, req in enumerate(reqs):
            temps[row] = req.params.temperature
            top_ps[row] = req.params.top_p
            top_ks[row] = req.params.top_k
        return temps, top_ps, top_ks

    @hot_path
    def _prefill_group(self, bucket: int, chunk: list[GenRequest]) -> None:
        """Place each request of ``chunk`` in a free slot, on the paged
        layout with pages for prompt + 1 rows (requeued when no slot or
        no pages are free; failed when the prompt can never fit the
        pool), and launch one ``[P, bucket]`` prefill for them: sample,
        write the K/V (``_write_prompt``) and send the first tokens to
        pinned host memory behind an event. The launch returns before the
        card is done; ``_collect_prefills`` emits the tokens."""
        cfg = self.config
        placed: list[GenRequest] = []
        for req in chunk:
            slot = self._free_slot()
            if slot < 0:
                self._requeue(req)
                continue
            if self._paged:
                if -(-(len(req.prompt_tokens) + 1) // cfg.page_size) \
                        > self._n_pages:
                    self._fail(req, "prompt exceeds kv pool")
                    continue
                if not self._alloc_pages(slot, len(req.prompt_tokens) + 1):
                    self._requeue(req)       # pool busy: wait for retires
                    continue
            if req.admit_order < 0:
                req.admit_order = self._admit_seq
                self._admit_seq += 1
            req.slot = slot
            self._dev_last_reqs[slot] = None
            self.active[slot] = req
            self._note_admitted(req)
            placed.append(req)
        if not placed:
            return
        p = next(g for g in self._group_sizes() if g >= len(placed))
        self._note_dispatch_shape("prefill", bucket, p)
        tokens = np.zeros((p, bucket), np.int64)
        kv_len = np.ones(p, np.int32)            # dummy rows: length 1
        tables = np.full((p, self._pages_per_slot), self._n_pages,
                         np.int32)               # dummy rows: all OOB
        for row, req in enumerate(placed):
            n = len(req.prompt_tokens)
            tokens[row, :n] = req.prompt_tokens
            kv_len[row] = n
            tables[row] = self._tables[req.slot]
        t0 = time.perf_counter()
        self.goodput.note_dispatch(t0)
        wall0 = time.time()  # gofrlint: allow(hot-path-purity) -- span timestamps use wall clock; once per prefill dispatch, never per decode pass
        try:
            first, ready = self._op(
                "prefill", tokens, kv_len, tables, [r.slot for r in placed],
                self._row_arrays(placed, p), _all_greedy(placed))
        except Exception as exc:  # noqa: BLE001 — fail this group only
            if self._lockstep is not None:
                raise                        # the ranks are out of step
            for req in placed:
                self.active[req.slot] = None
                self._release_pages(req.slot)
                self._fail(req, str(exc))
            if self.logger is not None:
                self.logger.error(f"prefill failed: {exc!r}")  # gofrlint: allow(hot-path-purity) -- failure path: the prefill already raised; the engine is off the fast path
            self._recover_lost_cache(exc)
            return
        self.stats["prefill_calls"] += 1
        self._sched_dirty = True                 # the slots go pending
        for req in placed:
            req.pending_prefill = True
            req.prefill_epoch += 1
        self._pending_prefills.append({
            "toks": first, "ready": ready, "placed": placed,
            "slots": [r.slot for r in placed],
            "epochs": [r.prefill_epoch for r in placed], "t0": t0,
            "wall0": wall0, "bucket": bucket, "group": p})

    @hot_path
    def _op_prefill(self, tokens: np.ndarray, kv_len: np.ndarray,
                    tables: np.ndarray, slots: list[int], row_arrays: tuple,
                    all_greedy: bool):
        """A group prefill on the device: the ``[P, S]`` prefill, its
        first tokens' sampling, the prompt's K/V written
        (``_write_prompt``) and the tokens queued to pinned host memory
        behind an event -> (host tokens, event)."""
        kv_len_t = self._upload(kv_len)
        tables_t = self._upload(tables) if self._paged else None
        temps, top_ps, top_ks = (self._upload(a) for a in row_arrays)
        logits, (k, v) = self._prefill_fn(self.params, self._upload(tokens),
                                          kv_len_t)
        toks = sample_batch(logits, temps, top_ps, top_ks,
                            generator=self._generator, all_greedy=all_greedy)
        self._write_prompt(k, v, kv_len_t, tables_t, slots)
        return self._to_host(toks)

    def _write_prompt(self, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor, tables: torch.Tensor,
                      slots: list[int]) -> None:
        """A group prefill's K/V slabs [L, P, S, Hkv, hd] into the cache:
        on the paged layout each row's first ``kv_len`` rows through its
        table (dummy rows have all-OOB tables: dropped), in one launch of
        the slab kernel on CUDA (``scatter_chunk_kv``); on the slot
        layout the whole bucket width of each real row into its slot's
        first S rows (``kc[:, slots, :S] = k``, the dummy rows past
        ``len(slots)`` left out)."""
        if self._paged:
            scatter_chunk_kv(self.k_cache, self.v_cache, tables, k, v,
                             torch.zeros_like(kv_len), kv_len)
            return
        n, width = len(slots), k.shape[2]
        index = self._upload(np.fromiter(slots, np.int64, n))
        self.k_cache[:, index, :width] = k[:, :n].to(self.k_cache.dtype)
        self.v_cache[:, index, :width] = v[:, :n].to(self.v_cache.dtype)

    def _to_host(self, tensor: torch.Tensor):
        """(host copy, event): on CUDA a copy into pinned memory queued
        behind the work that makes ``tensor``, and the event after it;
        on the CPU the tensor itself and None."""
        if self.device.type != "cuda":
            return tensor, None
        host = torch.empty(tensor.shape, dtype=tensor.dtype,
                           pin_memory=True)
        host.copy_(tensor, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    @hot_path
    def _collect_prefills(self) -> None:
        """Emit the first tokens of the batch prefills in flight and open
        their slots for decode. A row whose request was preempted,
        re-admitted or retired since its dispatch (epoch or slot
        changed) is dropped: its current life owns its own prefill."""
        if self._pending_prefills:
            self._sched_dirty = True
        while self._pending_prefills:
            rec = self._pending_prefills.popleft()
            try:
                if rec["ready"] is not None:
                    rec["ready"].synchronize()  # gofrlint: allow(hot-path-purity) -- this sync IS the prefill collect: first tokens cross to host here by design
                first = rec["toks"].numpy()  # gofrlint: allow(hot-path-purity) -- this sync IS the prefill collect: first tokens cross to host here by design
            except Exception as exc:  # noqa: BLE001 — fail this group only
                for req, slot, epoch in zip(rec["placed"], rec["slots"],
                                            rec["epochs"]):
                    if req.prefill_epoch != epoch:
                        continue             # re-dispatched since
                    req.pending_prefill = False
                    if self.active[slot] is req:
                        self.active[slot] = None
                        self._release_pages(slot)
                    if req.finished_at is None:
                        self._fail(req, str(exc))
                if self.logger is not None:
                    self.logger.error(f"prefill failed: {exc!r}")  # gofrlint: allow(hot-path-purity) -- failure path: device collect raised; slots are being failed, not served
                self._recover_lost_cache(exc)
                continue
            self._note_prefill_span(rec["t0"])
            now = time.time()  # gofrlint: allow(hot-path-purity) -- wall-clock span assembly at the prefill collect boundary, once per batch
            pass_dur = time.perf_counter() - rec["t0"]
            pass_share = pass_dur / len(rec["placed"])
            group, bucket = rec["group"], rec["bucket"]
            sig = self._sig_str("prefill", bucket, group)
            if self.recorder.enabled:
                self.recorder.record_pass(
                    "prefill", rows=len(rec["placed"]), bucket=bucket,
                    sig=sig, dur=round(pass_dur, 6),
                    occupancy=sum(r is not None for r in self.active),
                    queue_depth=self.waiting.qsize())
            fresh_rows = recompute_rows = 0
            for row, (req, slot, epoch) in enumerate(
                    zip(rec["placed"], rec["slots"], rec["epochs"])):
                if (req.prefill_epoch != epoch
                        or self.active[slot] is not req
                        or req.finished_at is not None):
                    # preempted, retired or re-admitted since: the row's
                    # compute is thrown away
                    recompute_rows += 1
                    continue
                req.device_s += pass_share
                if req.first_token_at is not None or req.recovered:
                    # a recompute after a preemption or a restart: this
                    # K/V was computed once already
                    recompute_rows += 1
                    req.waste_recompute_s += pass_share
                else:
                    fresh_rows += 1
                self._req_event(req, "prefill", rec["wall0"], now,
                                {"bucket": bucket,
                                 "rows": len(rec["placed"])})
                self._first_token(req, int(first[row]))
            self.goodput.add_prefill("prefill", pass_dur, group, fresh_rows,
                                     recompute_rows)
            self._note_pass_cost("prefill", sig, pass_dur, rows=group,
                                 tokens=group * bucket)
            self._update_kv_watermarks()
        self._note_device_idle()

    def _note_prefill_span(self, start: float) -> None:
        """``prefill_s`` sums the union of the prefill spans (launch to
        collect): two groups collected after the same pass cover nearly
        one interval."""
        end = time.perf_counter()
        self.stats["prefill_s"] += end - max(start, self._prefill_busy_until)
        self._prefill_busy_until = end

    def _first_token(self, req: GenRequest, token: int) -> None:
        """The prompt is in the cache: emit the first sampled token and
        open the slot for decode. A recompute after preemption keeps its
        request's first TTFT."""
        req.pending_prefill = False
        self._sched_dirty = True
        if self.faults is not NO_FAULTS and \
                self.faults.trip("logit_corrupt", req.tenant):
            token = self._corrupt_token(token)
        if req.first_token_at is None:
            now = time.time()  # gofrlint: allow(hot-path-purity) -- first-token boundary of a finished walk: once per request lifetime
            req.first_token_at = now
            if self.metrics is not None:
                self.metrics.record_histogram(  # gofrlint: allow(hot-path-purity) -- TTFT observation at the walk's collect boundary, once per request lifetime
                    "app_chat_ttft_seconds", now - req.submitted_at,
                    exemplar_trace_id=req.trace[0] if req.trace else None)
        req.generated.append(token)
        req.out_queue.put(token)
        self.total_generated += 1
        self.lengths[req.slot] = len(req.prompt_tokens)
        if self._finished(req, token):
            self._retire(req.slot)

    # ---------------------------------------------------------- chunk walk
    @hot_path
    def _walk_chunks(self, pairs: list) -> None:
        """Walk the prompts of ``pairs`` (request, slot) chunk by chunk:
        up to ``prefill_chunks_per_pass`` rounds, each grouping the live
        walkers by the smallest bucket covering what is left of their
        prompt (the widest when none does) into chunk calls of at most
        ``prefill_batch``. Before each chunk the slot's table grows to
        cover it, preempting younger requests if the pool is dry; a
        walker that cannot be covered gives its pages back and restarts
        from offset 0 later. Unfinished walkers go back to the requeued
        lane."""
        cfg = self.config
        widest = self._usable_buckets[-1]
        p_max = max(1, cfg.prefill_batch)
        walkers: list[GenRequest] = []
        if pairs:
            self._sched_dirty = True
        for req, slot in pairs:
            if self._paged and -(-(len(req.prompt_tokens) + 1)
                                 // cfg.page_size) > self._n_pages:
                # an attached prefix must not stay in the slot's table
                self._release_pages(slot)
                if self.active[slot] is req:
                    self.active[slot] = None
                req.prefill_offset = 0
                self._fail(req, "prompt exceeds kv pool")
                continue
            self._dev_last_reqs[slot] = None
            req.prefill_epoch += 1
            self.active[slot] = req
            req.slot = slot
            req.pending_prefill = True
            self._note_admitted(req)
            if req.admit_order < 0:
                req.admit_order = self._admit_seq
                self._admit_seq += 1
            walkers.append(req)
        if not walkers:
            return

        def owns_slot(r: GenRequest) -> bool:
            return (r.finished_at is None and r.slot >= 0
                    and self.active[r.slot] is r)

        start = time.perf_counter()
        dispatched: list[GenRequest] = []
        try:
            for _ in range(max(1, int(cfg.prefill_chunks_per_pass))):
                live = [r for r in walkers if owns_slot(r)
                        and r.prefill_offset < len(r.prompt_tokens)]
                if not live:
                    break
                by_width: dict[int, list[GenRequest]] = {}
                for r in live:
                    left = len(r.prompt_tokens) - r.prefill_offset
                    width = next((b for b in self._usable_buckets
                                  if b >= left), widest)
                    by_width.setdefault(width, []).append(r)
                for width, group in by_width.items():
                    for i in range(0, len(group), p_max):
                        ready = []
                        for r in group[i:i + p_max]:
                            if not owns_slot(r):
                                continue     # a peer's headroom preempted it
                            chunk = min(width, len(r.prompt_tokens)
                                        - r.prefill_offset)
                            rows = min(r.prefill_offset + chunk + 1,
                                       cfg.max_seq)
                            if self._paged and not self._ensure_headroom(
                                    r.slot, rows):
                                # the pool cannot hold this walk even
                                # after preempting younger requests:
                                # restart it from scratch once pages free
                                self._release_pages(r.slot)
                                self._dev_last_reqs[r.slot] = None
                                self.active[r.slot] = None
                                r.prefill_offset = 0
                                self._requeue(r)
                                continue
                            ready.append(r)
                        ready = [r for r in ready if owns_slot(r)]
                        if ready:
                            dispatched = ready
                            self._chunk_call(width, ready)
                            dispatched = []
        except Exception as exc:  # noqa: BLE001 — fail this call only
            if self._lockstep is not None:
                raise                        # the ranks are out of step
            # the rows of the failing call fail; walkers outside it keep
            # their state and requeue below
            for r in (dispatched or [w for w in walkers if owns_slot(w)
                                     and w.pending_prefill]):
                if r.slot >= 0 and self.active[r.slot] is r:
                    self.active[r.slot] = None
                    self._release_pages(r.slot)
                r.pending_prefill = False
                self._fail(r, str(exc))
            if self.logger is not None:
                self.logger.error(f"chunked prefill failed: {exc!r}")  # gofrlint: allow(hot-path-purity) -- failure path: the chunk dispatch raised; rows are being failed, not served
            self._recover_lost_cache(exc)
        self._note_prefill_span(start)
        self._update_kv_watermarks()
        self._note_device_idle()
        for r in walkers:                    # more chunks next round
            if owns_slot(r) and r.pending_prefill \
                    and r.prefill_offset < len(r.prompt_tokens):
                self._requeue(r)

    def _chunk_call(self, width: int, group: list[GenRequest]) -> None:
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
        window = self._chunk_window(int((offsets + lens).max()), width)
        self._note_dispatch_shape("chunk", width, g, window or None)
        c0 = time.perf_counter()
        self.goodput.note_dispatch(c0)
        w0 = time.time()  # gofrlint: allow(hot-path-purity) -- span timestamps use wall clock; once per chunk dispatch (the walk is synchronous by design)
        toks = self._op("chunk", tokens, [r.slot for r in group], tables,
                        offsets, lens, window, self._row_arrays(group, g),
                        _all_greedy(group))
        self.stats["prefill_calls"] += 1
        # the host span of the launch, as the JAX engine bills a chunk
        # dispatch (its first tokens' readout below is not in it)
        c_dur = time.perf_counter() - c0
        sig = self._sig_str("chunk", width, g, window or None)
        if self.recorder.enabled:
            self.recorder.record_pass(
                "prefill_chunk", rows=len(group), width=width, sig=sig,
                dur=round(c_dur, 6), queue_depth=self.waiting.qsize())
        # a walker whose first token is out already, or that a restart
        # salvaged, re-prefills K/V it computed once (recompute); pad
        # rows are padding
        recomp = sum(1 for r in group
                     if r.first_token_at is not None or r.recovered)
        self.goodput.add_prefill("prefill_chunk", c_dur, g,
                                 len(group) - recomp, recomp)
        self._note_pass_cost("chunk", sig, c_dur, rows=len(group),
                             tokens=g * width)
        w1 = time.time()  # gofrlint: allow(hot-path-purity) -- span timestamps use wall clock; once per chunk dispatch
        share = c_dur / len(group)
        for row, req in enumerate(group):
            req.device_s += share
            if req.first_token_at is not None or req.recovered:
                req.waste_recompute_s += share
            self._req_event(req, "prefill", w0, w1,
                            {"bucket": width,
                             "offset": int(req.prefill_offset)})
        first = None
        for row, req in enumerate(group):
            req.prefill_offset += int(lens[row])
            if req.prefill_offset >= len(req.prompt_tokens):
                if first is None:            # the walk's collect
                    first = toks.cpu().numpy()  # gofrlint: allow(hot-path-purity) -- this sync IS the walk's collect: finished walkers' first tokens cross to host here
                self._first_token(req, int(first[row]))

    @hot_path
    def _op_chunk(self, tokens: np.ndarray, slots: list[int],
                  tables: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
                  window: int, row_arrays: tuple,
                  all_greedy: bool) -> torch.Tensor:
        """One chunk call on the device (``_run_chunk``) and the sampling
        of its rows -> the sampled tokens [G] on the device."""
        temps, top_ps, top_ks = (self._upload(a) for a in row_arrays)
        logits = self._run_chunk(
            self._upload(tokens), slots, self._upload(tables),
            self._upload(offsets), self._upload(lens), window)
        return sample_batch(logits, temps, top_ps, top_ks,
                            generator=self._generator, all_greedy=all_greedy)

    def _chunk_window(self, needed: int, width: int) -> int:
        """The view's chunk window (the JAX engine's rule): the largest
        decode window when it covers ``needed`` rows and the chunk
        ``width``, else 0, the full view. The native walk reads only
        each row's own pages and the slot layout has no view: 0."""
        if not self._paged or self._native or not self._decode_windows:
            return 0
        w = self._decode_windows[-1]
        return w if needed <= w and width <= w else 0

    def _dense_rows(self, slots: list[int], g: int, tables: torch.Tensor,
                    window: int = 0):
        """(k, v, tables): a copy of the dense caches [L, g, W, Hkv, hd]
        that a chunk or verify call on a dense layout runs on. Slot
        layout: the rows of ``slots``, pad rows past them reading the
        first slot's (read only); the view: the pool gathered through
        ``tables`` [g, Mp] (pad rows all out of range), only the columns
        covering the first ``window`` rows when it is set, in the model's
        dtype; the tables the view was gathered through come back."""
        if self._paged:
            if window:
                tables = tables[:, :-(-window // self.config.page_size)]
            return (gather_view(self.k_cache, tables, self._view_dtype),
                    gather_view(self.v_cache, tables, self._view_dtype),
                    tables)
        rows = slots + [slots[0] if slots else 0] * (g - len(slots))
        index = self._upload(np.fromiter(rows, np.int64, g))
        return (self.k_cache.index_select(1, index),
                self.v_cache.index_select(1, index), tables)

    def _dense_write_back(self, k: torch.Tensor, v: torch.Tensor,
                          slots: list[int], tables: torch.Tensor,
                          offsets: torch.Tensor, width: int) -> None:
        """Write back what a dense call wrote into its copy
        (:meth:`_dense_rows`): on the view each row's rows ``[offsets,
        offsets + width)`` through its table (``scatter_decode_kv``:
        unallocated pages and pad rows drop); on the slot layout the
        whole rows of ``slots`` (pad rows are left out)."""
        if self._paged:
            scatter_decode_kv(self.k_cache, self.v_cache, tables, k, v,
                              offsets, width)
            return
        if slots:
            n = len(slots)
            index = self._upload(np.fromiter(slots, np.int64, n))
            self.k_cache.index_copy_(1, index, k[:, :n])
            self.v_cache.index_copy_(1, index, v[:, :n])

    def _run_chunk(self, tokens: torch.Tensor, slots: list[int],
                   tables: torch.Tensor, offsets: torch.Tensor,
                   lens: torch.Tensor, window: int = 0) -> torch.Tensor:
        """One chunk call of the walk on the engine's layout -> logits
        [G, V] of each row's last valid position: natively through the
        tables, else the dense chunk function on the rows' copy, written
        back."""
        if self._native:
            logits, self.k_cache, self.v_cache = self._chunk_fn(
                self.params, tokens, self.k_cache, self.v_cache, tables,
                offsets, lens)
            return logits
        k, v, tables = self._dense_rows(slots, tokens.shape[0], tables,
                                        window)
        logits, k, v = self._chunk_fn(self.params, tokens, k, v, offsets,
                                      lens)
        self._dense_write_back(k, v, slots, tables, offsets,
                               tokens.shape[1])
        return logits

    def _verify_and_compact(self, tokens, parents, depths, masks,
                            slots: list[int], tables, offsets, lens,
                            row_params):
        """One tree-verify call on the engine's layout, its resolution
        (``resolve_tree``) and the compaction of each row's accepted
        path: natively ``pool_move_rows`` through the tables, on a dense
        layout ``dense_move_rows`` inside the rows' copy before its
        write-back. Returns (accepted depth [B], bonus [B], path [B,
        W])."""
        width = tokens.shape[1]
        if self._native:
            logits, self.k_cache, self.v_cache = self._verify_fn(
                self.params, tokens, self.k_cache, self.v_cache, tables,
                offsets, lens, tree_depths=depths, tree_masks=masks)
        else:
            k, v, tables = self._dense_rows(slots, tokens.shape[0], tables)
            logits, k, v = self._verify_fn(
                self.params, tokens, k, v, offsets, lens,
                tree_depths=depths, tree_masks=masks)
        n_acc, bonus, path = resolve_tree(
            logits, tokens, parents, depths, lens, *row_params,
            generator=self._generator)
        if self._native:
            src, dst = path_moves(offsets, path, n_acc, self.config.max_seq)
            pool_move_rows(self.k_cache, tables, src, dst)
            pool_move_rows(self.v_cache, tables, src, dst)
        else:
            dense_move_rows(k, offsets, path, n_acc)
            dense_move_rows(v, offsets, path, n_acc)
            self._dense_write_back(k, v, slots, tables, offsets, width)
        return n_acc, bonus, path

    @hot_path_boundary(
        "speculative verify collect: the accept/path/bonus download IS "
        "the pass's sanctioned device sync, and the controller/ledger "
        "bookkeeping is priced against the multi-token verify pass it "
        "rides, not per decode pass")
    def _op_verify(self, tokens: np.ndarray, parents: np.ndarray,
                   depths: np.ndarray, masks: np.ndarray, slots: list[int],
                   tables: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
                   row_arrays: tuple) -> np.ndarray:
        """A speculative pass on the device (``_verify_and_compact``) ->
        its host result [B, 2 + W]: accepted depth, bonus token, path
        (checked across the ranks of a mesh)."""
        up = self._upload
        n_acc, bonus, path = self._verify_and_compact(
            up(tokens), up(parents), up(depths), up(masks), slots,
            up(tables), up(offsets), up(lens),
            tuple(up(a) for a in row_arrays))
        out = torch.cat([n_acc[:, None], bonus[:, None].long(), path],
                        1).cpu().numpy()
        if self._lockstep is not None:
            self._lockstep.check(out)
        return out

    # -------------------------------------------------------------- decode
    def _finished(self, req: GenRequest, token: int) -> bool:
        if token == self.config.eos_id:
            return True
        return len(req.generated) >= req.params.max_new_tokens

    @hot_path_boundary(
        "terminal per-request path: host-side span/metric/ledger "
        "assembly at retire is the architecture; runs once per request, "
        "never per pass")
    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        if req is None:
            return
        self._dev_last_reqs[slot] = None
        self._sched_dirty = True
        self.active[slot] = None
        self.lengths[slot] = 0
        if req.error is None and not req.cancelled:
            self._register_prefix(slot, req)
        self._release_pages(slot)
        req.finished_at = time.time()
        self._finalize_obs(req)
        req._end()

    def _retire_unservable(self) -> None:
        """The sweep before a decode or verify pass: cancelled slots and
        slots at the ``max_seq`` ceiling leave first. Lengths advance at
        dispatch, so a pass in flight may still hold a ceiling slot's
        last tokens: it is collected before the slot is declared
        spent."""
        for i, req in enumerate(self.active):
            if req is None:
                continue
            if req.cancelled:
                self._retire(i)
            elif self.lengths[i] >= self.config.max_seq:
                if any(rec["mask"][i] and rec["reqs"][i] is req
                       for rec in self._pending):
                    self._drain_pending()
                if (self.active[i] is req
                        and self.lengths[i] >= self.config.max_seq):
                    self._retire(i)

    def _pipeline_depth(self) -> int:
        """Dispatches to leave in flight now: ``pipeline_depth``, or
        adaptively 1 while at least ``pipeline_min_slots`` slots decode
        (where the overlap pays for the pass a retirement wastes), else
        0."""
        cfg = self.config
        if cfg.pipeline_depth is not None:
            return max(0, int(cfg.pipeline_depth))
        decoding = sum(1 for r in self.active
                       if r is not None and not r.pending_prefill)
        return 1 if decoding >= cfg.pipeline_min_slots else 0

    @hot_path
    def _decode_step(self) -> None:
        """Dispatch one decode pass, then collect until at most the
        pipeline depth stays in flight; with nothing to dispatch (every
        slot walking), collect everything."""
        before = len(self._pending)
        self._decode_dispatch()
        if len(self._pending) == before:
            self._drain_pending()
        else:
            depth = self._pipeline_depth()
            while len(self._pending) > depth:
                self._decode_collect()

    @hot_path
    def _drain_pending(self) -> None:
        while self._pending:
            self._decode_collect()

    @hot_path
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
            if req is None:
                continue
            if req.pending_prefill:
                if not self._native:
                    # a dense step has no active mask: parked at max_seq,
                    # the row's writes drop and its prompt rows stay
                    arrays["lengths"][i] = cfg.max_seq
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
        self._note_uploads(self._op("upload", arrays))
        self.stats["sched_syncs"] += 1
        self._sched_dirty = False

    @hot_path
    def _sync_tables(self) -> None:
        """Upload the block tables, only when a page was allocated,
        released or attached since the last upload."""
        self._note_uploads(self._op("upload", {"tables": self._tables}))
        self._tables_dirty = False

    @hot_path
    def _op_upload(self, arrays: dict) -> int:
        """Host arrays into the decode graph's buffers (``upload``)."""
        return self._decode_graph.upload(**arrays)

    def _note_uploads(self, n: int) -> None:
        """Host-to-device uploads by the decode path (event-driven: none
        in a steady-state pass)."""
        self.stats["h2d_transfers"] += n
        if self.metrics is not None and n:
            self.metrics.add_counter("app_engine_h2d_transfers", float(n))  # gofrlint: allow(hot-path-purity) -- event-driven upload (sched sync, page growth): this write records the h2d-invariant counter (zero per steady-state pass)

    def _note_graph_stats(self) -> None:
        graph = self._decode_graph
        self.stats["graph_captures"] = graph.captures
        self.stats["graph_replays"] = graph.replays
        self.stats["graph_capture_s"] = graph.capture_s

    @hot_path
    def _decode_dispatch(self) -> None:
        """Launch one decode dispatch without waiting for it: sweep the
        unservable slots, on the paged layout grow every decoding slot's
        table to ``len + T`` rows oldest request first (preempting the
        newest when the pool runs dry), upload the state and tables if an
        event dirtied them, pick the decode window, advance the host's
        ``lengths`` by each row's valid steps, and queue a record of the
        pass for ``_decode_collect``."""
        cfg = self.config
        steps = self._tokens_per_pass
        h2d0 = self.stats["h2d_transfers"]
        self._retire_unservable()
        order = sorted((i for i, r in enumerate(self.active) if r is not None),
                       key=lambda i: self.active[i].admit_order)
        for i in order if self._paged else ():
            req = self.active[i]
            if req is None or req.pending_prefill:
                continue       # preempted just now, or walking its prompt
            rows = min(int(self.lengths[i]) + steps, cfg.max_seq)
            if not self._ensure_headroom(i, rows):
                self._preempt(i)     # the pool cannot hold even this one
        host0 = time.perf_counter()
        mask = np.fromiter((r is not None and not r.pending_prefill
                            for r in self.active), bool, len(self.active))
        if not mask.any():
            return
        if self._sched_dirty:
            self._sync_decode_state()
        if self._tables_dirty and self._paged:
            self._sync_tables()
        reqs = list(self.active)
        window = self._pick_window(int(self.lengths[mask].max()) + steps)
        self._note_dispatch_shape("decode", window)
        # steps whose write would land at or past max_seq are garbage
        # (their K/V writes drop): only the valid prefix is emitted
        valid = np.where(mask, np.minimum(steps, cfg.max_seq - self.lengths),
                         0).astype(np.int32)
        self.lengths += valid
        start = time.perf_counter()
        self.goodput.note_dispatch(start)
        handle = self._op("launch",
                          _all_greedy([r for r, m in zip(reqs, mask) if m]),
                          window)
        self._note_graph_stats()
        self._dev_last_reqs = [r if m else None for r, m in zip(reqs, mask)]
        disp = time.perf_counter() - host0
        self._pending.append({"handle": handle, "reqs": reqs, "mask": mask,
                              "valid": valid, "t0": start, "disp": disp,
                              "window": window,
                              "h2d": self.stats["h2d_transfers"] - h2d0})
        self.stats["dispatch_s"] += disp

    @hot_path
    def _op_launch(self, all_greedy: bool, window: int) -> int:
        """Start one decode dispatch (``DecodeGraph.launch``)."""
        return self._decode_graph.launch(self.k_cache, self.v_cache,
                                         all_greedy, window)

    @hot_path
    def _op_collect(self, handle: int) -> np.ndarray:
        """Wait for a dispatch's tokens [T, rows] (``DecodeGraph.collect``),
        checked across the ranks of a mesh."""
        out = self._decode_graph.collect(handle)
        if self._lockstep is not None:
            self._lockstep.check(out)
        return out

    def _pick_window(self, needed: int) -> int:
        """The smallest decode window that covers ``needed`` rows (every
        decoding slot's length + T; parked slots decode garbage either
        way and bound nothing), else 0: the full graph."""
        return next((w for w in self._decode_windows if needed <= w), 0)

    @hot_path
    def _decode_collect(self) -> None:
        """Wait for the oldest dispatch in flight, emit its tokens and
        retire the slots it finished. A row whose request was retired or
        preempted since its dispatch decoded garbage: it is discarded."""
        if not self._pending:
            return
        if self.faults is not NO_FAULTS:
            # a pass is in flight: its tokens are lost with the engine
            self.faults.trip("nan_logits")
        rec = self._pending.popleft()
        out = self._op("collect", rec["handle"])
        end = time.perf_counter()
        busy = end - max(rec["t0"], self._decode_busy_until)
        self._decode_busy_until = end
        self.stats["decode_passes"] += 1
        self.stats["decode_s"] += busy
        occupancy = int(rec["mask"].sum())
        if self.metrics is not None:
            self.metrics.record_histogram("app_gpu_execute_seconds", busy)  # gofrlint: allow(hot-path-purity) -- per-pass observation at the collect sync point, host floats already paid for
            self.metrics.record_histogram("app_engine_batch_occupancy",  # gofrlint: allow(hot-path-purity) -- per-pass observation at the collect sync point, host floats already paid for
                                          float(occupancy))
        self._step_count += 1
        # the pass's peak, before its retires free pages
        self._update_kv_watermarks()
        steps = self._tokens_per_pass
        emitted = 0
        credited = 0                         # rows whose request kept it
        share = busy / occupancy if occupancy else 0.0
        for i, req in enumerate(rec["reqs"]):
            if req is None or not rec["mask"][i]:
                continue
            if self.active[i] is not req or req.finished_at is not None:
                continue                     # retired or preempted since
            req.device_s += share
            credited += 1
            done = False
            for k in range(int(rec["valid"][i])):
                token = int(out[k, i])
                if self.faults is not NO_FAULTS and \
                        self.faults.trip("logit_corrupt", req.tenant):
                    token = self._corrupt_token(token)
                req.generated.append(token)
                req.out_queue.put(token)
                self.total_generated += 1
                emitted += 1
                if self._finished(req, token):
                    done = True
                    break
            if done or rec["valid"][i] < steps:
                self._retire(i)
        self.stats["decode_tokens"] += emitted
        collect = time.perf_counter() - end
        self.stats["collect_s"] += collect
        # rows that kept the pass are useful; empty slots, walking slots
        # and requests retired since the dispatch are padding
        self.goodput.add_decode(busy, credited, self.config.max_batch)
        # the price an accepted draft token undercuts
        self._spec_ctrl.note_decode(busy, emitted)
        sig = self._sig_str("decode", rec["window"])
        self._note_pass_cost("decode", sig, busy, rows=credited,
                             tokens=emitted)
        if self.recorder.enabled:
            self.recorder.record_pass(
                "decode", dur=round(busy, 6),
                dispatch_s=round(rec["disp"], 6),
                collect_s=round(collect, 6), occupancy=occupancy,
                sig=sig, queue_depth=self.waiting.qsize(), tokens=emitted,
                h2d=rec["h2d"], preemptions=self.stats["preemptions"])
        self._note_device_idle()

    # --------------------------------------------------------- speculation
    def _step(self) -> None:
        """One pass over the decoding slots. With speculation, every
        greedy slot drafts first; a verify pass runs when every
        decoding slot drafted, and in a mixed batch every other time
        (a verify pass advances a slot that did not draft by one token,
        so it gets a full K-step decode pass in between), else a decode
        step."""
        proposals: dict[int, Any] = {}
        decoding = 0
        if self._spec_enabled:
            for i, r in enumerate(self.active):
                if r is None or r.pending_prefill or r.cancelled:
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
            self._decode_step()

    @hot_path_boundary(
        "drafting policy: O(1)-amortized n-gram index maintenance plus "
        "controller pricing, host work that runs only for greedy slots "
        "on a speculation pass — never inside the plain decode pass")
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
        if (idx is None or idx.n != n
                or idx.prompt_len != len(req.prompt_tokens)):
            # first drafting pass, or a preemption folded the generated
            # tokens into the prompt: rebuild
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

    @hot_path_boundary(
        "speculative verify collect: the accept/path/bonus download IS "
        "the pass's sanctioned device sync, and the controller/ledger "
        "bookkeeping is priced against the multi-token verify pass it "
        "rides, not per decode pass")
    def _spec_pass(self, proposals: dict[int, DraftTree]) -> None:
        """One tree-verify pass over every decoding slot (``proposals``:
        slot -> its draft tree); a slot without a tree rides along as a
        lone root node, which is exactly one decode step for it. The
        decode pipeline is drained first (verify feeds each row's last
        token from the host), and each slot's table grows to cover its
        tree, preempting the newest requests if the pool is dry.
        Accepted tokens and the bonus token are emitted host-side; the
        accepted path's K/V rows were compacted on the device."""
        cfg = self.config
        self._drain_pending()
        self._dev_last_reqs = [None] * cfg.max_batch
        self._sched_dirty = True
        self._retire_unservable()
        trees: dict[int, DraftTree] = {
            i: tree for i, tree in proposals.items()
            if self.active[i] is not None
            and not self.active[i].pending_prefill}
        # pow-2 width buckets: the widest tree of the pass picks it
        widest = max((t.n_nodes for t in trees.values()), default=1)
        width = 2
        while width < widest:
            width *= 2
        # headroom for every fed row: draft nodes write cache rows too,
        # and an earlier row's headroom may preempt a later one
        for i, req in enumerate(self.active):
            if req is None or req.pending_prefill:
                continue
            tree = trees.get(i)
            fed = min(int(self.lengths[i])
                      + (tree.n_nodes if tree is not None else 1),
                      cfg.max_seq)
            if self._paged and self.active[i] is req \
                    and not self._ensure_headroom(i, fed):
                self._preempt(i)
        rows = [i for i, r in enumerate(self.active)
                if r is not None and not r.pending_prefill]
        if not rows:
            return
        n = len(rows)
        reqs = [self.active[i] for i in rows]
        tokens = np.zeros((n, width), np.int64)
        parents = np.zeros((n, width), np.int64)
        depths = np.zeros((n, width), np.int64)
        masks = np.ones((n, width), np.int64)
        chunk_lens = np.ones(n, np.int32)
        for j, (slot, req) in enumerate(zip(rows, reqs)):
            tree = trees.get(slot)
            if tree is not None:
                m = tree.n_nodes
                tokens[j, :m] = tree.tokens
                parents[j, :m] = tree.parents
                depths[j, :m] = tree.depths
                masks[j, :m] = tree.masks
                chunk_lens[j] = m
            # the root is the stream's last token as it stands after the
            # drain: a tree drafted while a decode dispatch was in flight
            # was rooted at an older one, which the verify pass would
            # write at this row's position (its drafts stay: the verify
            # accepts only what the model would have decoded)
            tokens[j, 0] = req.generated[-1]
        self._note_dispatch_shape("spec_verify", width)
        t0 = time.perf_counter()
        self.goodput.note_dispatch(t0)
        w0 = time.time()
        # the 32-bit ancestor masks travel as int32 bit patterns
        out = self._op("verify", tokens, parents, depths,
                       masks.astype(np.uint32).view(np.int32), rows,
                       self._tables[rows], self.lengths[rows].copy(),
                       chunk_lens, self._row_arrays(reqs, n))
        dur = time.perf_counter() - t0
        w1 = time.time()
        self.stats["spec_passes"] += 1
        self.stats["spec_s"] += dur
        self.stats["decode_s"] += dur
        if self.metrics is not None:
            self.metrics.record_histogram("app_gpu_execute_seconds", dur)
        self._step_count += 1
        emitted_total = 0
        pass_drafted = pass_accepted = 0
        row_stats: list[tuple[int, int]] = []      # (drafted, accepted)
        share = dur / n
        for j, (slot, req) in enumerate(zip(rows, reqs)):
            req.device_s += share
            tree = trees.get(slot)
            n_drafted = tree.n_draft if tree is not None else 0
            accepted = min(int(out[j, 0]), n_drafted)
            if n_drafted:
                # the rejected drafts' part of this row's time, billed to
                # the request that drafted them
                req.waste_spec_s += share * (n_drafted - accepted) \
                    / (1 + n_drafted)
                self._spec_ctrl.note_result(slot, n_drafted, accepted)
                self._req_event(req, "spec_verify", w0, w1,
                                {"drafted": n_drafted,
                                 "accepted": accepted})
            row_stats.append((n_drafted, accepted))
            pass_drafted += n_drafted
            pass_accepted += accepted
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
                if self.faults is not NO_FAULTS and \
                        self.faults.trip("logit_corrupt", req.tenant):
                    token = self._corrupt_token(token)
                req.generated.append(token)
                req.out_queue.put(token)
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
        if self.metrics is not None and pass_drafted:
            self.metrics.add_counter("app_engine_spec_drafted",
                                     float(pass_drafted))
            self.metrics.add_counter("app_engine_spec_accepted",
                                     float(pass_accepted))
        # the pass runs the decoding rows only: no pad rows to price
        self.goodput.add_spec(dur, n, row_stats)
        self._spec_ctrl.note_verify(dur, n, width)
        sig = self._sig_str("spec_verify", width)
        self._note_pass_cost("spec_verify", sig, dur, rows=n,
                             tokens=pass_accepted + n)
        self._update_kv_watermarks()
        if self.recorder.enabled:
            self.recorder.record_pass(
                "spec_verify", rows=n, drafted=pass_drafted,
                accepted=pass_accepted, dur=round(dur, 6), occupancy=n,
                sig=sig, queue_depth=self.waiting.qsize())
        self._note_device_idle()

    # ------------------------------------------------------ observability
    def _sig(self, *parts: Any) -> tuple:
        """A dispatch's shape signature; a non-default ``kv_dtype`` is
        folded in (the JAX engine's rule, so signatures read alike)."""
        if self.config.kv_dtype != "bf16":
            return (*parts, self.config.kv_dtype)
        return parts

    def _sig_str(self, *parts: Any) -> str:
        """The signature as the cost table, the pass records and
        ``/debug/costs`` key it: ``decode/0``, ``prefill/64/1``,
        ``chunk/1024/1/None``, ``spec_verify/8``."""
        return "/".join(str(p) for p in self._sig(*parts))

    @hot_path_boundary(
        "O(1) host set probe per dispatch; the metric/log fire only on "
        "an anomalous post-warmup recompile")
    def _note_dispatch_shape(self, *parts: Any) -> None:
        """The recompile sentinel at every dispatch: a shape the sealed
        warmup never ran is counted and WARNed once."""
        sig = self._sig(*parts)
        if not self.sentinel.dispatch(sig):
            return
        text = "/".join(str(p) for p in sig)
        self.stats["recompiles"] += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_engine_recompiles")
        if self.logger is not None:
            self.logger.warn("unexpected post-warmup dispatch shape: "
                             "warmup never ran it", signature=text)
        self.events.emit("obs.recompile", severity="warn", signature=text)

    @hot_path_boundary(
        "cost-model fold at the collect boundary: host float EWMA "
        "updates over the pass duration the collect already measured; "
        "the event/metric/WARN/incident and the profiler arm fire only "
        "on a rare drift-episode entry")
    def _note_pass_cost(self, kind: str, sig: str, dur: float, *,
                        rows: int = 0, tokens: int = 0) -> None:
        """Feed one collected pass to the cost model with the duration
        the goodput ledger billed; the autoprofiler's pass budget and the
        golden-probe cadence tick here too. A drift episode's entry is
        counted, WARNed, recorded as an ``obs.cost_drift`` event, arms the
        autoprofiler and opens a ``cost_drift`` incident bundle naming
        the capture's directory."""
        self.autoprof.note_pass()
        probe = self.integrity.note_pass()
        if probe is not None:
            self._launch_probe(probe)
        if not self.costs.enabled:
            return
        skew = 0.0
        if self.faults is not NO_FAULTS \
                and self.faults.trip("cost_skew", sig):
            # drift induction: the observed duration only, no sleep
            skew = self.faults.payload("cost_skew")
        drift = self.costs.observe(kind, sig, dur, rows=rows, tokens=tokens,
                                   skew_s=skew)
        if drift is None:
            return
        self.stats["cost_drifts"] += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_engine_cost_drift",
                                           kind=kind)
        if self.logger is not None:
            self.logger.warn("pass cost drifted off its sealed baseline",
                             signature=sig, ewma_s=drift["ewma_s"],
                             baseline_s=drift["baseline_s"],
                             ratio=drift["ratio"])
        self.events.emit("obs.cost_drift", severity="warn", signature=sig,
                         pass_kind=kind, ratio=drift["ratio"],
                         ewma_s=drift["ewma_s"],
                         baseline_s=drift["baseline_s"])
        capture = self.autoprof.arm("cost_drift", f"pass cost drift: {sig}")
        self.incidents.trigger(
            "cost_drift", cause=f"pass cost drift: {sig}",
            attrs={**drift, "autoprof_dir": (capture or {}).get("dir")})

    def cost_state(self) -> dict:
        """The ``GET /debug/costs`` payload: the cost table and the
        autoprofiler's state (also an incident-bundle source)."""
        return {"costs": self.costs.state(),
                "autoprof": self.autoprof.state()}

    def integrity_state(self) -> dict:
        """The ``GET /debug/integrity`` payload."""
        return self.integrity.state()

    def efficiency_state(self) -> dict:
        """The ``GET /debug/efficiency`` payload: goodput, watermarks,
        the recompile sentinel, speculation and the cost table."""
        self._update_watermarks()
        cfg = self.config
        cap_tokens = (self._n_pages * cfg.page_size if self._paged
                      else cfg.max_batch * cfg.max_seq)
        return {"goodput": self.goodput.state(),
                "watermarks": self.watermarks.state(),
                "recompiles": self.sentinel.state(),
                "spec": self._spec_ctrl.state(),
                "costs": self.costs.state(),
                "kv_bytes": self._kv_bytes_total,
                "kv_bytes_per_token": round(
                    self._kv_bytes_total / max(1, cap_tokens), 3)}

    def _launch_probe(self, entry) -> None:
        """Submit one golden probe through admission on the background
        lane (it yields to interactive traffic and rides the path users
        ride), tenant ``_integrity``; a refused probe frees the cadence."""
        p = entry.params
        params = SamplingParams(temperature=p["temperature"],
                                top_p=p["top_p"], top_k=p["top_k"],
                                max_new_tokens=p["max_new_tokens"])
        req = GenRequest(
            prompt_tokens=self._clamp_prompt(list(entry.prompt_tokens),
                                             params.max_new_tokens),
            params=params, tenant="_integrity", lane="background")
        req.probe = entry.id
        req.probe_expected = entry.digest
        if self._draining or not self.waiting.put(req):
            self.integrity.probe_aborted()

    @hot_path_boundary(
        "integrity fold at the retire boundary: one blake2b over token "
        "ids the collects already emitted plus host dict bookkeeping "
        "for probe results; the WARN/event/metric/incident fire only on"
        " a rare probe-mismatch episode entry — runs once per request, "
        "never per pass")
    def _note_integrity(self, req: GenRequest) -> None:
        """Stamp the request's digest; for a golden probe, re-price its
        device time to ``integrity_probe`` waste and record its result
        (an ``obs.integrity`` event); a mismatch episode's entry is
        counted, WARNed and opens an ``integrity`` incident bundle."""
        mismatch = self.integrity.fold(req)
        if req.probe:
            self.goodput.reprice_probe(req.device_s)
            self.integrity.probe_device_s += req.device_s
            rec = self.integrity.last.get(req.probe)
            if rec is not None and req.error is None and not req.cancelled:
                self.events.emit(
                    "obs.integrity", severity="info" if rec["ok"] else "warn",
                    golden_id=req.probe, digest=rec["digest"],
                    expected=req.probe_expected, ok=rec["ok"],
                    seq=rec["seq"])
        if mismatch is None:
            return
        self.stats["integrity_failures"] += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_engine_integrity_failures",
                                           kind="probe_mismatch")
        if self.logger is not None:
            self.logger.warn(
                "golden probe digest mismatch: this host's greedy output "
                "diverged from its sealed expectation",
                golden_id=mismatch["golden_id"], digest=mismatch["digest"],
                expected=mismatch["expected"])
        self.incidents.trigger(
            "integrity",
            cause=f"golden probe digest mismatch: {mismatch['golden_id']}",
            attrs=dict(mismatch))

    def _corrupt_token(self, token: int) -> int:
        """``logit_corrupt``'s effect: the sampled token replaced, never
        by ``eos_id``, so stream lengths stay and only digests move."""
        alt = token ^ 1
        if alt == self.config.eos_id:
            alt = token ^ 2
        return alt

    def _note_device_idle(self) -> None:
        """A collect finished with nothing in flight: the card is idle
        from here; whether work waits decides if the gap to the next
        dispatch is a bubble."""
        if not self.goodput.enabled or self._pending \
                or self._pending_prefills:
            return
        backlog = (bool(self._requeued) or self.waiting.qsize() > 0
                   or any(r is not None and not r.pending_prefill
                          for r in self.active))
        self.goodput.note_pass_end(time.perf_counter(), backlog)

    def _req_event(self, req: GenRequest, name: str, t0: float, t1: float,
                   attrs: dict | None = None) -> None:
        if len(req.events) < 64:
            req.events.append((name, t0, t1, attrs or {}))

    @hot_path_boundary(
        "admission boundary: closes the queue-wait span exactly once "
        "per request")
    def _note_admitted(self, req: GenRequest) -> None:
        """The first slot assignment ends the queue wait (a recompute
        keeps the first one)."""
        if req.admitted_at is None:
            now = time.time()
            req.admitted_at = now
            if self.metrics is not None:
                self.metrics.record_histogram(
                    "app_chat_queue_seconds", now - req.submitted_at,
                    exemplar_trace_id=req.trace[0] if req.trace else None)

    def _finalize_obs(self, req: GenRequest) -> None:
        """A request's end, exactly once (retire, fail or cancel): the
        latency histograms (with the request's trace id as exemplar), the
        usage ledger, the SLO verdict (typed refusals, cancels and probes
        stay out of it) and the scheduler's burn column, the digest and
        probe judgement, the recorder's request log, the workload
        capture (probes stay out of it) and the ``engine.*`` spans."""
        if req._obs_done:
            return
        req._obs_done = True
        end = req.finished_at or time.time()
        exemplar = req.trace[0] if req.trace else None
        n = len(req.generated)
        ttft_s = (req.first_token_at - req.submitted_at
                  if req.first_token_at is not None else None)
        tpot_s = ((end - req.first_token_at) / (n - 1)
                  if req.first_token_at is not None and n > 1 else None)
        e2e_s = end - req.submitted_at
        if self.metrics is not None and req.error is None \
                and not req.cancelled:
            self.metrics.record_histogram("app_chat_e2e_seconds", e2e_s,
                                          exemplar_trace_id=exemplar)
            if tpot_s is not None:
                self.metrics.record_histogram("app_chat_tpot_seconds",
                                              tpot_s,
                                              exemplar_trace_id=exemplar)
        status = ("cancelled" if req.cancelled
                  else "error" if req.error is not None else "ok")
        queue_s = (req.admitted_at - req.submitted_at
                   if req.admitted_at is not None else 0.0)
        self.usage_ledger.record(
            tenant=req.tenant or "anonymous", status=status,
            prompt_tokens=len(req.prompt_tokens), completion_tokens=n,
            queue_s=queue_s, e2e_s=e2e_s, device_s=req.device_s,
            waste_recompute_s=req.waste_recompute_s,
            waste_spec_s=req.waste_spec_s, t=end)
        if self.slo is not None and not req.cancelled \
                and req.reject is None and not req.probe:
            good = self.slo.judge(error=req.error, ttft_s=ttft_s,
                                  tpot_s=tpot_s, e2e_s=e2e_s)
            self.slo.record(good, t=end)
            self.waiting.note_retire(req.tenant, good, t=end)
        if self.integrity.enabled:
            self._note_integrity(req)
        if self.recorder.enabled:
            self.recorder.record_request(request_summary(req))
        if self.workload.capturing and not req.probe:
            self.workload.record(req)
        if self.tracer is not None and req.trace is not None:
            try:
                emit_engine_spans(self.tracer, req)
            except Exception:  # noqa: BLE001 — tracing never ends a stream
                pass

    def _update_kv_watermarks(self) -> None:
        """KV high-water marks at the collects (a burst's peak is caught
        before its slots retire): O(1) page counts."""
        wm = self.watermarks
        if not wm.enabled:
            return
        if not self._paged:       # the slot layout: live rows
            rows = float(self.lengths.sum())
            wm.update("kv_rows", rows)
            wm.update("kv_bytes", rows * self._kv_bytes_total
                      / (self.config.max_batch * self.config.max_seq))
            return
        used = self._n_pages - len(self._free_pages)
        wm.update("kv_pages", float(used))
        wm.update("prefix_pages", float(self._cached_pages))
        wm.update("kv_bytes", used * self._kv_bytes_total / self._n_pages)

    def _update_watermarks(self) -> None:
        if self.watermarks.enabled:
            self._update_kv_watermarks()
            self.watermarks.update_rss()

    def _update_gauges(self) -> None:
        """Every loop iteration: slots and queue; every 0.25 s the
        derived gauges (tokens/s, MFU, goodput ratio and waste deltas,
        watermarks, the pool, the scheduler's). Host arithmetic over
        counters the loop keeps."""
        m = self.metrics
        if m is not None:
            m.set_gauge("app_engine_active_slots",
                        float(sum(r is not None for r in self.active)))
            m.set_gauge("app_engine_waiting", float(self.waiting.qsize()))
        now = time.time()
        dt = now - self._gauge_wall
        if dt < 0.25:
            return
        self._update_watermarks()
        self._refresh_prefix_digest()
        tps = (self.total_generated - self._gauge_tokens) / dt
        self._gauge_wall = now
        self._gauge_tokens = self.total_generated
        if m is None:
            return
        m.set_gauge("app_engine_tokens_per_second", round(tps, 2))
        gp = self.goodput
        if gp.enabled and gp.busy_s > 0:
            ratio = gp.useful_s / gp.busy_s
            m.set_gauge("app_engine_goodput_ratio", round(ratio, 6))
            # a goodput-floor breach arms a bounded capture (off at the
            # default floor 0; the 1 s guard keeps a cold engine's first
            # noisy ratio from tripping it)
            floor = self.config.autoprof_goodput_floor
            if floor > 0.0 and gp.busy_s > 1.0 and ratio < floor:
                self.autoprof.arm(
                    "goodput_floor",
                    f"goodput ratio {ratio:.3f} below floor {floor:.3f}")
            for cause, total in gp.waste_s.items():
                delta = total - self._waste_published.get(cause, 0.0)
                if delta > 0:          # counters take deltas of the totals
                    m.add_counter("app_engine_waste_seconds", delta,
                                  cause=cause)
                    self._waste_published[cause] = total
        wm = self.watermarks
        if wm.enabled:
            for mark, gauge in (
                    ("kv_pages", "app_engine_kv_pages_watermark"),
                    ("kv_rows", "app_engine_kv_rows_watermark"),
                    ("kv_bytes", "app_engine_kv_bytes_watermark"),
                    ("prefix_pages", "app_engine_prefix_pages_watermark"),
                    ("host_rss_bytes",
                     "app_engine_host_rss_bytes_watermark")):
                value = wm.get(mark)
                if value is not None:
                    m.set_gauge(gauge, value)
        mfu = (tps * self._flops_per_token / self._peak_flops
               if self._flops_per_token and self._peak_flops else 0.0)
        m.set_gauge("app_engine_mfu", round(mfu, 6))
        if self._spec_enabled:
            m.set_gauge("app_engine_spec_accept_rate",
                        round(self._spec_ctrl.accept_rate(), 6))
        self.waiting.publish_gauges(m)
        cfg = self.config
        if not self._paged:
            m.set_gauge("app_engine_kv_pool_utilization",
                        round(float(self.lengths.sum())
                              / (cfg.max_batch * cfg.max_seq), 4))
            m.set_gauge("app_engine_kv_pool_fragmentation", 0.0)
            return
        used = self._n_pages - len(self._free_pages)
        m.set_gauge("app_engine_kv_pool_utilization",
                    round(used / self._n_pages, 4))
        # allocated page capacity holding no live rows (walking slots
        # report their walk's progress)
        cap_rows = int(self._slot_pages.sum()) * cfg.page_size
        live = int(self.lengths.sum()) + sum(
            r.prefill_offset for r in self.active
            if r is not None and r.pending_prefill)
        frag = 1.0 - live / cap_rows if cap_rows else 0.0
        m.set_gauge("app_engine_kv_pool_fragmentation",
                    round(min(1.0, max(0.0, frag)), 4))
        m.set_gauge("app_engine_prefix_cache_entries",
                    float(len(self._prefix_cache)))
        m.set_gauge("app_engine_prefix_cache_pages",
                    float(self._cached_pages))


def _takes_window(fn) -> bool:
    """Whether a dense decode_fn takes ``attn_window`` (probed by
    signature, as the JAX engine probes it)."""
    try:
        return fn is not None and "attn_window" in inspect.signature(
            fn).parameters
    except (TypeError, ValueError):
        return False


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


def dense_move_rows(cache: torch.Tensor, offsets: torch.Tensor,
                    path: torch.Tensor, n_acc: torch.Tensor) -> None:
    """:func:`path_moves`' plan on a dense cache [L, B, W, Hkv, hd], in
    place: for each row, the node at depth k (row ``offsets + path[k]``)
    moves to row ``offsets + k`` in every layer, for k <= ``n_acc``.
    Every source is read before any row is written; the depths past the
    accepted one write back what they read at ``offsets + k`` (mod W:
    no two writes of a row meet). No host sync."""
    w = cache.shape[2]
    k = torch.arange(path.shape[1], device=path.device)[None, :]
    base = offsets.long()[:, None]
    at = (base + k) % w
    src = (base + path.long()).clamp(max=w - 1)
    rows = torch.arange(cache.shape[1], device=cache.device)[:, None]
    keep = (k <= n_acc[:, None].long())[None, :, :, None, None]
    cache[:, rows, at] = torch.where(keep, cache[:, rows, src],
                                     cache[:, rows, at])
