"""Tenant- and lane-aware admission: the engine's waiting queue
(the port's copy of ``gofr_tpu/serving/scheduler.py``, same names and
semantics; host code, no torch).

:class:`Scheduler` holds the requests that wait for a slot, behind the
``put`` / ``pop_batch`` / ``qsize`` / ``close`` / ``reopen`` contract
the engine calls, with four policies configured by
:class:`SchedulerConfig`:

1. **Weighted fair share**: one sub-queue per tenant and lane; each
   dequeue picks the tenant with the lowest device-time share (a usage
   ledger's windowed ``device_s`` plus an in-flight debt estimate, over
   the tenant's weight). One tenant is one sub-queue, strict FIFO, so
   single-tenant traffic leaves in arrival order.
2. **Priority lanes**: ``interactive`` always dequeues before
   ``background``. When an interactive request has waited past
   ``starvation_s`` with the batch full (``starving_interactive``), the
   engine preempts its newest background slot and hands the victim back
   through ``readmit``, at the head of its sub-queue.
3. **Token-bucket rate limits** per tenant (requests/s and prompt
   tokens/s), refused with a typed ``rate_limited``
   :class:`SchedReject` (429 + ``Retry-After`` at the HTTP surface);
   ``capacity`` bounds the queue (``queue_full``, 503).
4. **Burn-rate shedding** driven by an SLO tracker (``slo_source``).

The engine builds it with its usage ledger (the windowed device-time
shares) and ``slo_source`` (its SLO tracker, which the app attaches);
``attach_metrics`` gives it the metrics sink and the engine its event
ledger. A scheduler built without them takes its shares from the
in-flight debt alone, never sheds and records nothing.
"""

from __future__ import annotations

import math
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from ..analysis.annotations import hot_path_boundary
from .events import NO_EVENTS


INTERACTIVE = "interactive"
BACKGROUND = "background"
LANES = (INTERACTIVE, BACKGROUND)

#: rejection causes (the typed-error ``code`` and the metric label)
QUEUE_FULL = "queue_full"
RATE_LIMITED = "rate_limited"
SHED = "shed"


@dataclass
class RateLimit:
    """Per-tenant token buckets. 0 disables that dimension; burst
    defaults to 2x the sustained rate (min 1 request / 1 token)."""

    #: sustained requests per second (0 = unlimited)
    rps: float = 0.0
    #: request burst capacity; None = max(1, 2 * rps)
    burst: float | None = None
    #: sustained prompt tokens per second (0 = unlimited)
    prompt_tps: float = 0.0
    #: prompt-token burst capacity; None = max(1, 2 * prompt_tps)
    prompt_burst: float | None = None


@dataclass
class SchedulerConfig:
    """Admission/scheduling/shedding policy (docs/configs.md has the
    knob table; docs/operations.md the overload runbook)."""

    #: "fair" = weighted fair-share DRR over tenant sub-queues;
    #: "fifo" = global arrival order (the pre-scheduler behavior, kept
    #: as the replay baseline)
    policy: str = "fair"
    #: per-tenant fair-share weights (share is divided by the weight,
    #: so weight 2.0 = entitled to twice the device time); absent
    #: tenants get ``default_weight``
    weights: dict = field(default_factory=dict)
    default_weight: float = 1.0
    #: ledger window the device-time shares are read over
    share_window_s: float = 300.0
    #: tenants whose traffic lands in the background lane (explicit
    #: ``submit(..., lane=...)`` wins over this mapping)
    background_tenants: tuple = ()
    #: per-tenant rate limits keyed by TenantResolver label; the "*"
    #: key applies to every tenant without an explicit entry
    rate_limits: dict = field(default_factory=dict)
    #: interactive head-of-line wait beyond which the engine may
    #: preempt a background slot (0 disables starvation preemption)
    starvation_s: float = 1.0
    #: floor between scheduler-initiated preemptions — one recompute
    #: at a time, never a thrash storm
    preempt_min_interval_s: float = 0.5
    #: burn-rate-driven shedding master switch (inert without an
    #: attached SLOTracker)
    shed: bool = True
    #: hysteresis: a shed episode ends only once the fast burn falls
    #: to ``threshold * shed_exit_ratio`` — flapping admission around
    #: the trip point would shed and re-admit the same tenant per pass
    shed_exit_ratio: float = 0.5
    #: during an episode, interactive traffic is also shed for tenants
    #: whose windowed device-time share exceeds this multiple of the
    #: equal share (background traffic always sheds first)
    shed_overshare: float = 2.0
    #: Retry-After hint (seconds) for queue_full / shed rejections
    retry_after_s: float = 1.0
    #: per-tenant fast-burn window for the ``state()`` burn column and
    #: the contention smoke's victim assertion
    burn_window_s: float = 300.0
    #: per-tenant retire events retained for the burn column
    burn_events: int = 2048


@dataclass
class SchedReject:
    """Typed admission rejection, stamped on the request before
    ``put`` returns False — handlers turn it into 429/503 with a
    ``Retry-After`` header instead of an undifferentiated 503."""

    code: str                 # queue_full | rate_limited | shed
    tenant: str
    retry_after_s: float
    detail: str = ""

    @property
    def message(self) -> str:
        return self.detail or f"admission refused: {self.code}"


class _TokenBucket:
    """Classic token bucket; times come from the caller so the clock
    is mockable and shared across buckets."""

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = max(0.0, float(rate))
        self.burst = max(1.0, float(burst))
        self.level = self.burst
        self._last = None  # type: float | None

    def try_take(self, n: float, now: float) -> float:
        """0.0 on success; else seconds until ``n`` tokens exist (the
        Retry-After hint). Disabled buckets (rate 0) always admit."""
        if self.rate <= 0:
            return 0.0
        if self._last is None:
            self._last = now
        self.level = min(self.burst,
                         self.level + (now - self._last) * self.rate)
        self._last = now
        if self.level >= n:
            self.level -= n
            return 0.0
        return (n - self.level) / self.rate


class _TenantState:
    """Per-tenant scheduler bookkeeping (guarded by the Scheduler
    lock): sub-queues per lane, fair-share debt, rate buckets, and the
    retire-outcome ring behind the per-tenant burn column."""

    def __init__(self, limit: RateLimit | None,
                 burn_events: int) -> None:
        self.queues: dict[str, deque] = {lane: deque() for lane in LANES}
        #: in-flight device-time debt (seconds-equivalent) accumulated
        #: per dequeue and cleared at every ledger refresh — without
        #: it, a burst tenant would win every pick between refreshes
        self.debt = 0.0
        #: ledger-fed windowed device seconds at the last refresh
        self.share_s = 0.0
        self.req_bucket: _TokenBucket | None = None
        self.tok_bucket: _TokenBucket | None = None
        if limit is not None:
            if limit.rps > 0:
                self.req_bucket = _TokenBucket(
                    limit.rps,
                    limit.burst if limit.burst is not None
                    else max(1.0, 2.0 * limit.rps))
            if limit.prompt_tps > 0:
                self.tok_bucket = _TokenBucket(
                    limit.prompt_tps,
                    limit.prompt_burst if limit.prompt_burst is not None
                    else max(1.0, 2.0 * limit.prompt_tps))
        #: (t, bad) retire outcomes over the burn window
        self.outcomes: deque = deque(maxlen=max(16, int(burn_events)))
        self.outcomes_bad = 0

    def depth(self) -> int:
        return sum(len(q) for q in self.queues.values())


class Scheduler:
    """Drop-in replacement for the engine's waiting queue with
    tenant/lane/SLO-aware admission. Thread-safe: ``put`` runs on
    submitter (HTTP handler) threads, ``pop_batch``/``qsize`` on the
    engine thread, ``state()`` on debug-route threads."""

    def __init__(self, config: SchedulerConfig | None = None,
                 capacity: int = 0, *, ledger: Any = None,
                 slo_source: Any = None, metrics: Any = None,
                 logger: Any = None) -> None:
        self.config = config if config is not None else SchedulerConfig()
        if self.config.policy not in ("fair", "fifo"):
            raise ValueError(f"scheduler policy must be 'fair' or "
                             f"'fifo', got {self.config.policy!r}")
        self.capacity = max(0, int(capacity))
        #: UsageLedger the fair-share device-time shares are read from
        self.ledger = ledger
        #: zero-arg callable returning the engine's SLOTracker (or
        #: None) — resolved per check because ``app.serve_model``
        #: attaches the tracker after the engine (and this queue) exist
        self.slo_source = slo_source
        self.metrics = metrics
        self.logger = logger
        #: EventLedger admission decisions are recorded on; replaced by
        #: ``app.serve_model`` with the engine's ledger (NO_EVENTS is a
        #: no-op sink, so standalone schedulers stay silent, not broken)
        self.events = NO_EVENTS
        self._lock = threading.Condition()
        self._tenants: dict[str, _TenantState] = {}
        self._size = 0
        self._closed = False
        self._seq = 0                 # global arrival order (fifo mode
        #                               and FIFO-within-sub-queue ties)
        self._share_refreshed = 0.0   # ledger-share cache timestamp
        self._spt = 1e-4              # est. device seconds per token,
        #                               re-fit from the ledger rollup
        self._shed_active = False
        self._shed_since: float | None = None
        self._last_preempt = 0.0
        self._slo_checked = 0.0
        self._slo_tripped = False     # cached fast-burn trip state
        self._slo_burn = 0.0
        self.counters = {"admitted": 0, "dequeued": 0, "readmitted": 0,
                         "preemptions": 0, "shed_episodes": 0,
                         "rejected": {QUEUE_FULL: 0, RATE_LIMITED: 0,
                                      SHED: 0}}

    # ------------------------------------------------------------ config
    def reconfigure(self, config: SchedulerConfig) -> None:
        """Swap the policy in place (``app.serve_model(scheduler=...)``
        runs after the engine — and this queue — were constructed).
        Queued requests are re-bucketed under the new config in global
        arrival order; counters and burn history survive."""
        if config.policy not in ("fair", "fifo"):
            raise ValueError(f"scheduler policy must be 'fair' or "
                             f"'fifo', got {config.policy!r}")
        with self._lock:
            queued: list = []
            for ts in self._tenants.values():
                for lane in LANES:
                    queued.extend(ts.queues[lane])
                    ts.queues[lane].clear()
            queued.sort(key=lambda pair: pair[0])
            old = self._tenants
            self.config = config
            self._tenants = {}
            for name, ts in old.items():
                fresh = self._tenant_locked(name)
                fresh.outcomes = ts.outcomes
                fresh.outcomes_bad = ts.outcomes_bad
            for seq, req in queued:
                lane = self._lane_for(req)
                req.lane = lane
                self._tenant_locked(self._label(req)).queues[lane] \
                    .append((seq, req))
            self._share_refreshed = 0.0  # force a share re-read
            self._lock.notify_all()

    # ----------------------------------------------------------- helpers
    @staticmethod
    def _label(req: Any) -> str:
        return getattr(req, "tenant", None) or "anonymous"

    def _lane_for(self, req: Any) -> str:
        lane = getattr(req, "lane", None)
        if lane in LANES and lane != INTERACTIVE:
            return lane  # explicit background assignment wins
        if self._label(req) in self.config.background_tenants:
            return BACKGROUND
        return lane if lane in LANES else INTERACTIVE

    def _tenant_locked(self, name: str) -> _TenantState:
        ts = self._tenants.get(name)
        if ts is None:
            limits = self.config.rate_limits
            limit = limits.get(name, limits.get("*"))
            ts = _TenantState(limit, self.config.burn_events)
            self._tenants[name] = ts
        return ts

    def _weight(self, name: str) -> float:
        return max(1e-6, float(self.config.weights.get(
            name, self.config.default_weight)))

    def _refresh_shares_locked(self, now: float) -> None:
        """Pull windowed per-tenant device seconds from the usage
        ledger (throttled — rollup takes the ledger lock) and re-fit
        the seconds-per-token estimate the in-flight debt uses."""
        if now - self._share_refreshed < 0.5:
            return
        self._share_refreshed = now
        for ts in self._tenants.values():
            ts.share_s = 0.0
            ts.debt = 0.0
        if self.ledger is None:
            return
        try:
            rollup = self.ledger.rollup(
                window_s=self.config.share_window_s)
        except Exception:
            return  # accounting must never block admission
        device_total = tokens_total = 0.0
        for name, tot in (rollup.get("tenants") or {}).items():
            device_s = float(tot.get("device_s", 0.0))
            self._tenant_locked(name).share_s = device_s
            device_total += device_s
            tokens_total += (tot.get("prompt_tokens", 0)
                             + tot.get("completion_tokens", 0))
        if device_total > 0 and tokens_total > 0:
            self._spt = device_total / tokens_total

    def _est_cost_s(self, req: Any) -> float:
        """In-flight device-time debt for one dequeue: prompt plus the
        full generation budget, priced at the fitted sec/token."""
        tokens = len(getattr(req, "prompt_tokens", ()) or ())
        params = getattr(req, "params", None)
        tokens += int(getattr(params, "max_new_tokens", 0) or 0)
        return max(1, tokens) * self._spt

    def _pick_locked(self, now: float) -> Any | None:
        """Dequeue one request: interactive lane strictly first; within
        a lane, the tenant with the lowest weighted device-time share
        (ledger share + in-flight debt, over the weight) — the DRR
        deficit, fed by real accounting instead of a fixed quantum.
        FIFO policy ignores all of it and takes global arrival order."""
        if self.config.policy == "fifo":
            best = None
            for ts in self._tenants.values():
                for lane in LANES:
                    q = ts.queues[lane]
                    if q and (best is None or q[0][0] < best[0][0]):
                        best = (q[0], q)
            if best is None:
                return None
            (seq, req), q = best
            q.popleft()
            return req
        self._refresh_shares_locked(now)
        for lane in LANES:
            best_name = None
            best_score = (0.0, 0)
            for name, ts in self._tenants.items():
                q = ts.queues[lane]
                if not q:
                    continue
                score = ((ts.share_s + ts.debt) / self._weight(name),
                         q[0][0])  # arrival order breaks share ties
                if best_name is None or score < best_score:
                    best_name, best_score = name, score
            if best_name is not None:
                ts = self._tenants[best_name]
                _, req = ts.queues[lane].popleft()
                ts.debt += self._est_cost_s(req)
                return req
        return None

    # ------------------------------------------------------------- admit
    def _check_shed_locked(self, now: float) -> None:
        """Refresh the cached fast-burn state (throttled — state()
        takes the tracker lock) and run the episode hysteresis: enter
        at the trip threshold, exit at threshold * shed_exit_ratio."""
        if not self.config.shed:
            self._shed_active = False
            return
        if now - self._slo_checked < 0.25:
            pass
        else:
            self._slo_checked = now
            slo = self.slo_source() if callable(self.slo_source) else None
            if slo is None:
                self._slo_tripped = False
                self._slo_burn = 0.0
            else:
                try:
                    fast = slo.state().get("fast_burn") or {}
                except Exception:
                    fast = {}
                self._slo_burn = float(fast.get("burn_rate") or 0.0)
                threshold = float(fast.get("threshold") or 0.0)
                if not self._shed_active:
                    self._slo_tripped = bool(fast.get("tripped"))
                else:  # hysteresis: stay shedding until well below
                    exit_at = threshold * self.config.shed_exit_ratio
                    self._slo_tripped = (threshold > 0
                                         and self._slo_burn > exit_at)
        if self._slo_tripped and not self._shed_active:
            self._shed_active = True
            self._shed_since = now
            self.counters["shed_episodes"] += 1
            if self.logger is not None:
                self.logger.warn(
                    "overload shed episode: SLO fast burn tripped — "
                    "shedding background and over-share traffic until "
                    "the burn recovers",
                    burn_rate=round(self._slo_burn, 2))
            self.events.emit("sched.shed_open", severity="warn",
                             cause="fast_burn",
                             burn_rate=round(self._slo_burn, 2))
        elif not self._slo_tripped and self._shed_active:
            self._shed_active = False
            self._shed_since = None
            self.events.emit("sched.shed_close",
                             burn_rate=round(self._slo_burn, 2))

    def _shed_verdict_locked(self, req: Any, lane: str,
                             now: float) -> bool:
        """True = refuse this request under the active shed episode.
        Cheapest traffic first: all background, then interactive from
        tenants holding more than ``shed_overshare`` x the equal
        share of the windowed device time."""
        if not self._shed_active:
            return False
        if lane == BACKGROUND:
            return True
        self._refresh_shares_locked(now)
        active = [ts.share_s for ts in self._tenants.values()
                  if ts.share_s > 0]
        total = sum(active)
        if total <= 0 or len(active) < 2:
            return False  # nobody is measurably over-share yet
        fair = total / len(active)
        mine = self._tenant_locked(self._label(req)).share_s
        return mine > self.config.shed_overshare * fair

    def _reject_locked(self, req: Any, code: str, tenant: str,
                       retry_after_s: float, detail: str) -> bool:
        req.reject = SchedReject(code=code, tenant=tenant,
                                 retry_after_s=retry_after_s,
                                 detail=detail)
        self.counters["rejected"][code] += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_sched_rejections",
                                           cause=code, tenant=tenant)
        self.events.emit("sched.reject", severity="warn",
                         request_id=getattr(req, "request_id", None),
                         tenant=tenant, cause=code,
                         retry_after_s=round(retry_after_s, 3))
        return False

    @hot_path_boundary(
        "admission boundary: runs on submitter threads before any work "
        "reaches the engine loop")
    def put(self, item: Any) -> bool:
        """Admit or refuse one request. False = refused; a typed
        :class:`SchedReject` is stamped on the request for every
        policy refusal (closed queues stamp nothing — the engine's
        'not accepting requests' failure stands)."""
        now = time.monotonic()
        with self._lock:
            if self._closed:
                return False
            tenant = self._label(item)
            lane = self._lane_for(item)
            item.lane = lane
            ts = self._tenant_locked(tenant)
            readmit = bool(getattr(item, "_sched_readmit", False))
            if not readmit:
                # 1) per-tenant rate limits: refused before the work
                #    touches anything (the 429 + Retry-After surface)
                wait = 0.0
                if ts.req_bucket is not None:
                    wait = ts.req_bucket.try_take(1.0, now)
                if wait <= 0 and ts.tok_bucket is not None:
                    n = float(len(getattr(item, "prompt_tokens", ())
                                  or ()) or 1)
                    wait = ts.tok_bucket.try_take(n, now)
                if wait > 0:
                    return self._reject_locked(
                        item, RATE_LIMITED, tenant, wait,
                        f"rate limit exceeded for tenant {tenant!r}")
                # 2) burn-rate shedding: cheapest traffic first
                self._check_shed_locked(now)
                if self._shed_verdict_locked(item, lane, now):
                    return self._reject_locked(
                        item, SHED, tenant, self.config.retry_after_s,
                        "shedding load: SLO error budget burning too "
                        "fast (fast-burn episode active)")
                # 3) admission bound (already-admitted work re-entering
                #    through readmit() is exempt, like the old
                #    _requeued list was)
                if self.capacity and self._size >= self.capacity:
                    return self._reject_locked(
                        item, QUEUE_FULL, tenant,
                        self.config.retry_after_s,
                        "engine overloaded: waiting queue full")
            self._seq += 1
            entry = (self._seq, item)
            if readmit:
                item._sched_readmit = False
                ts.queues[lane].appendleft((-self._seq, item))
                self.counters["readmitted"] += 1
            else:
                ts.queues[lane].append(entry)
                self.counters["admitted"] += 1
            self._size += 1
            self._lock.notify()
            return True

    def readmit(self, req: Any) -> None:
        """Re-enter already-admitted work (a scheduler-initiated
        preemption victim) at the HEAD of its lane sub-queue, exempt
        from the bound, buckets and shedding — its admission was
        already paid. The engine calls this after pulling the victim
        back out of its ``_requeued`` fast lane, which would otherwise
        hand the freed slot straight back."""
        req._sched_readmit = True
        self.put(req)

    # ----------------------------------------------------------- dequeue
    def pop_batch(self, max_n: int, first_wait_s: float = 0.1,
                  drain_wait_s: float = 0.0) -> list | None:
        """Same contract as ``native/batch_queue.py``: block up to
        ``first_wait_s`` for one item, drain up to ``max_n`` (waiting
        ``drain_wait_s`` for stragglers). ``None`` = closed and
        drained; ``[]`` = timed out."""
        max_n = max(0, int(max_n))
        out: list = []
        with self._lock:
            deadline = time.monotonic() + max(0.0, first_wait_s)
            while self._size == 0:
                if self._closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return out
                self._lock.wait(timeout=min(remaining, 0.05))
            now = time.monotonic()
            while len(out) < max_n and self._size > 0:
                req = self._pick_locked(now)
                if req is None:  # size drifted (defensive)
                    break
                self._size -= 1
                self.counters["dequeued"] += 1
                out.append(req)
            if out and len(out) < max_n and drain_wait_s > 0:
                straggler_deadline = time.monotonic() + drain_wait_s
                while len(out) < max_n:
                    if self._size == 0:
                        remaining = (straggler_deadline
                                     - time.monotonic())
                        if remaining <= 0 or self._closed:
                            break
                        self._lock.wait(timeout=min(remaining, 0.05))
                        continue
                    req = self._pick_locked(time.monotonic())
                    if req is None:
                        break
                    self._size -= 1
                    self.counters["dequeued"] += 1
                    out.append(req)
        return out

    def get_nowait(self) -> Any:
        """queue.Queue-compatible accessor (raises queue.Empty)."""
        batch = self.pop_batch(1, first_wait_s=0.0)
        if not batch:
            raise queue_mod.Empty
        return batch[0]

    def qsize(self) -> int:
        with self._lock:
            return self._size

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def reopen(self) -> None:
        """Reverse :meth:`close` — the restartable-engine lifecycle:
        ``Engine.start()`` after ``stop()`` reopens admission on the
        same scheduler, keeping tenant state, counters and rate-bucket
        levels (a restart is not an amnesty)."""
        with self._lock:
            self._closed = False

    # ------------------------------------------------------- starvation
    def starving_interactive(self) -> bool:
        """True when the engine should preempt a background slot: the
        interactive head-of-line request has waited past
        ``starvation_s`` with the batch full, and the preemption rate
        cap allows another recompute. Called once per engine pass with
        zero free slots — cheap lock-guarded reads."""
        cfg = self.config
        if cfg.policy != "fair" or cfg.starvation_s <= 0:
            return False
        now = time.monotonic()
        wall = time.time()
        with self._lock:
            if now - self._last_preempt < cfg.preempt_min_interval_s:
                return False
            for ts in self._tenants.values():
                q = ts.queues[INTERACTIVE]
                if not q:
                    continue
                head = q[0][1]
                age = wall - getattr(head, "submitted_at", wall)
                if age > cfg.starvation_s:
                    # arm the rate cap on the DECISION (victimless
                    # attempts must not re-fire every pass); the
                    # engine reports the actual preemption via
                    # note_preempted()
                    self._last_preempt = now
                    return True
        return False

    def note_preempted(self) -> None:
        """The engine actually preempted a background slot for the
        starving interactive lane — count it."""
        with self._lock:
            self.counters["preemptions"] += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_sched_preemptions")
        self.events.emit("sched.preempt", severity="warn",
                         cause="starvation")

    # ----------------------------------------------------------- retire
    @hot_path_boundary(
        "retire boundary: per-tenant burn bookkeeping fed from "
        "_finalize_obs, off the decode loop")
    def note_retire(self, tenant: str | None, good: bool,
                    t: float | None = None) -> None:
        """Record one retired request's SLO verdict against its
        tenant — the per-tenant fast-burn column ``state()`` and the
        contention smoke read. The verdict is the same ``judge()``
        result the global tracker gets; this just keys it by tenant."""
        t = time.time() if t is None else t
        with self._lock:
            ts = self._tenant_locked(tenant or "anonymous")
            if len(ts.outcomes) == ts.outcomes.maxlen:
                ts.outcomes_bad -= ts.outcomes[0][1]
            bad = 0 if good else 1
            ts.outcomes.append((t, bad))
            ts.outcomes_bad += bad

    def _tenant_burn_locked(self, ts: _TenantState, now: float,
                            availability: float) -> dict:
        window = self.config.burn_window_s
        cutoff = now - window
        while ts.outcomes and ts.outcomes[0][0] < cutoff:
            _, bad = ts.outcomes.popleft()
            ts.outcomes_bad -= bad
        total = len(ts.outcomes)
        err = (ts.outcomes_bad / total) if total else 0.0
        budget = max(1e-9, 1.0 - availability)
        return {"total": total, "bad": ts.outcomes_bad,
                "burn_rate": round(err / budget, 4)}

    # ------------------------------------------------------------- state
    def state(self, fresh: bool = False) -> dict:
        """The ``GET /debug/scheduler`` payload: policy, lane depths,
        per-tenant shares/weights/queues/burn, rate-limit levels, shed
        episode state and the admission counters. ``fresh=True``
        bypasses the 0.5s share-cache throttle so the view reflects
        every retire that already landed — the ``?fresh=1`` debug
        query the smokes use instead of sleeping out the window."""
        now_m = time.monotonic()
        wall = time.time()
        slo = self.slo_source() if callable(self.slo_source) else None
        availability = getattr(getattr(slo, "config", None),
                               "availability", 0.999)
        with self._lock:
            if fresh:
                self._share_refreshed = 0.0
            self._refresh_shares_locked(now_m)
            lanes = {lane: sum(len(ts.queues[lane])
                               for ts in self._tenants.values())
                     for lane in LANES}
            total_share = sum(ts.share_s
                              for ts in self._tenants.values())
            tenants = {}
            for name, ts in sorted(self._tenants.items()):
                info = {
                    "queued": {lane: len(ts.queues[lane])
                               for lane in LANES},
                    "weight": self._weight(name),
                    "device_share_s": round(ts.share_s, 6),
                    "device_share": round(
                        ts.share_s / total_share, 4)
                    if total_share > 0 else 0.0,
                    "burn": self._tenant_burn_locked(ts, wall,
                                                     availability),
                }
                if ts.req_bucket is not None:
                    info["rps_bucket_level"] = round(
                        ts.req_bucket.level, 3)
                if ts.tok_bucket is not None:
                    info["tps_bucket_level"] = round(
                        ts.tok_bucket.level, 3)
                tenants[name] = info
            counters = {**self.counters,
                        "rejected": dict(self.counters["rejected"])}
            return {
                "policy": self.config.policy,
                "capacity": self.capacity,
                "depth": self._size,
                "lanes": lanes,
                "tenants": tenants,
                "share_window_s": self.config.share_window_s,
                "burn_window_s": self.config.burn_window_s,
                "shedding": {
                    "enabled": self.config.shed,
                    "active": self._shed_active,
                    "for_s": round(now_m - self._shed_since, 3)
                    if self._shed_since is not None else None,
                    "fast_burn_rate": round(self._slo_burn, 4),
                    "exit_ratio": self.config.shed_exit_ratio,
                },
                "counters": counters,
            }

    def publish_gauges(self, metrics: Any) -> None:
        """Throttled gauge pass, called from the engine's
        ``_update_gauges``: lane depths, per-tenant windowed share and
        the shed flag. Counters (rejections, preemptions) are written
        at the events themselves."""
        with self._lock:
            self._refresh_shares_locked(time.monotonic())
            lanes = {lane: float(sum(len(ts.queues[lane])
                                     for ts in self._tenants.values()))
                     for lane in LANES}
            total = sum(ts.share_s for ts in self._tenants.values())
            shares = {name: (ts.share_s / total if total > 0 else 0.0)
                      for name, ts in self._tenants.items()}
            shed = self._shed_active
        for lane, depth in lanes.items():
            metrics.set_gauge("app_sched_lane_depth", depth, lane=lane)
        for name, share in shares.items():
            metrics.set_gauge("app_sched_tenant_share",
                              round(share, 4), tenant=name)
        metrics.set_gauge("app_sched_shed_active", 1.0 if shed else 0.0)


def retry_after_header(reject: SchedReject) -> dict:
    """``Retry-After`` header for a typed rejection (whole seconds,
    rounded up, floor 1 — RFC 7231 wants an integer)."""
    return {"Retry-After": str(max(1, math.ceil(reject.retry_after_s)))}


__all__ = ["Scheduler", "SchedulerConfig", "SchedReject", "RateLimit",
           "retry_after_header", "INTERACTIVE", "BACKGROUND",
           "QUEUE_FULL", "RATE_LIMITED", "SHED"]
