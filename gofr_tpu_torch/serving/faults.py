"""Deterministic fault injection for chaos testing the serving stack
(the port's copy of ``gofr_tpu/serving/faults.py``: the same sites,
plan syntax and triggers).

A :class:`FaultPlan` names *sites* — fixed points in the engine and
control plane where a failure can be made to happen — and arms each
with a trigger expressed in **invocation counts** (and optionally a
request id), never wall clock and never RNG: the same plan against the
same traffic fires at exactly the same step every run, so a chaos test
that passes once passes always and a failure reproduces bit-identically
under ``git bisect``.

Sites:

========================  =====================================================
``pass_raise``            raise :class:`InjectedFault` at the top of an engine
                          loop iteration (before any dispatch) — exercises the
                          crash-recovery supervisor's requeue-and-replay path
``pass_stall``            ``time.sleep(seconds)`` inside a loop iteration —
                          simulates a wedged device call; drives the stall
                          watchdog → DEGRADED → leader-evict path
``pass_latency``          same sleep, by convention a *small* one — simulates
                          a slow pass without tripping the watchdog
``nan_logits``            raise :class:`InjectedFault` at decode *collect* —
                          the pass already dispatched, tokens are in flight,
                          so recovery must take the mid-stream
                          typed-retryable branch, never the replay branch
``page_exhaustion``       report the KV page pool exhausted at admission —
                          the request is refused with a typed 503, the
                          engine keeps running
``heartbeat_drop``        ``WorkerAgent`` silently skips a heartbeat —
                          simulates a lossy control network
``join_refused``          ``WorkerAgent.join()`` raises — simulates a leader
                          that is down or rejecting, exercising join backoff
``leader_down``           the leader answers every control RPC with a 503 —
                          simulates a dead front door without killing the
                          process; drives the missed-ack failover path
``leader_partition``      the leader refuses control RPCs from one host
                          (``request=host_id``) — an asymmetric network
                          partition: only that host elects
``ack_drop``              ``WorkerAgent`` discards a *successful* heartbeat
                          ack — the leader saw the beat, the worker counts a
                          miss; exercises one-way control-network loss
``stale_epoch_replay``    the leader answers a heartbeat with ``epoch - 1``
                          — a replayed/stale ack; exercises worker-side
                          epoch fencing (the ack must be rejected)
``cost_skew``             report-only: the engine inflates the duration it
                          feeds the pass-cost model by ``seconds`` for the
                          dispatch signature in ``request`` — deterministic
                          drift induction with zero sleep and zero token
                          perturbation (greedy outputs stay bit-identical)
``logit_corrupt``         report-only: the engine perturbs a collected token
                          at the emit boundary — the host-visible consequence
                          of corrupted device logits (the real logits never
                          cross to the host). Nothing crashes, stream lengths
                          are preserved, but output digests diverge — what
                          exercises the integrity observatory
                          (serving/integrity.py). Scope to one request class
                          with ``request=<tenant>``; scope to one host by
                          arming only that host's plan
========================  =====================================================

The disabled plan is the module-level :data:`NO_FAULTS` singleton; call
sites guard with ``plan is not NO_FAULTS`` so the default hot path pays
one identity comparison and nothing else.

The port's engine arms seven of these sites: ``pass_raise``,
``pass_stall``, ``pass_latency``, ``nan_logits``, ``page_exhaustion``,
``logit_corrupt`` and ``cost_skew``. The fleet plane
(``serving/control_plane.py``) arms the rest: the ``WorkerAgent`` trips
``heartbeat_drop``, ``join_refused`` and ``ack_drop``, the
``ControlPlaneLeader`` ``leader_down``, ``leader_partition`` and
``stale_epoch_replay``.

Plan syntax (``EngineConfig.faults`` / ``GOFR_FAULTS``)::

    site[:key=value[,key=value...]][;site...]

    GOFR_FAULTS="pass_raise:at=3"
    GOFR_FAULTS="pass_stall:at=5,seconds=2.5;heartbeat_drop:at=2,times=4"

Keys: ``at`` (1-based invocation index where firing starts, default 1),
``times`` (number of consecutive firings, default 1; ``0`` means every
invocation from ``at`` on), ``seconds`` (sleep payload for the stall /
latency sites), ``request`` (only invocations carrying this request id
are counted or fired).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from ..analysis.annotations import hot_path_boundary
from .events import NO_EVENTS

SITES = frozenset({
    "pass_raise", "pass_stall", "pass_latency", "page_exhaustion",
    "nan_logits", "heartbeat_drop", "join_refused",
    "leader_down", "leader_partition", "ack_drop", "stale_epoch_replay",
    "cost_skew", "logit_corrupt",
})

# sites whose firing is a raise vs. a sleep; the rest report True and
# let the call site decide what "exhausted"/"dropped" means locally
_RAISE_SITES = frozenset({"pass_raise", "nan_logits"})
_SLEEP_SITES = frozenset({"pass_stall", "pass_latency"})


class InjectedFault(RuntimeError):
    """A deliberately injected failure. Distinguishable from organic
    errors in logs and in ``health_check()['last_crash']``."""


@dataclass
class FaultSpec:
    """One armed site. ``seen`` is the deterministic trigger state: it
    counts matching invocations of :meth:`FaultPlan.trip`, nothing
    else — no clocks, no RNG."""
    site: str
    at: int = 1          # 1-based invocation index where firing starts
    times: int = 1       # consecutive firings; 0 = forever from ``at``
    seconds: float = 0.0  # sleep payload (stall / latency sites)
    request: str = ""    # only count/fire invocations with this request id
    seen: int = field(default=0, repr=False)

    def armed_for(self, count: int) -> bool:
        if count < self.at:
            return False
        return self.times <= 0 or count < self.at + self.times


class FaultPlan:
    """An immutable set of :class:`FaultSpec` with per-spec
    deterministic counters. Build with :meth:`parse` or pass specs
    directly; the empty plan should be :data:`NO_FAULTS`."""

    def __init__(self, specs=()):  # noqa: D401 - simple container
        self.specs = list(specs)
        self._by_site: dict[str, list[FaultSpec]] = {}
        for spec in self.specs:
            if spec.site not in SITES:
                raise ValueError(
                    f"unknown fault site {spec.site!r}; known: "
                    f"{', '.join(sorted(SITES))}")
            self._by_site.setdefault(spec.site, []).append(spec)
        # observability for tests and /debug surfaces
        self.fired: dict[str, int] = {}
        #: EventLedger fault firings are recorded on; the engine wires
        #: its ledger onto armed plans only (NO_FAULTS stays pristine)
        self.events = NO_EVENTS

    # ------------------------------------------------------------ state
    @property
    def enabled(self) -> bool:
        return bool(self.specs)

    def reset(self) -> None:
        """Rewind every trigger counter (reuse one plan across runs)."""
        for spec in self.specs:
            spec.seen = 0
        self.fired.clear()

    def payload(self, site: str) -> float:
        """Largest ``seconds`` payload armed for ``site`` — the side
        channel the report-only sites carry a magnitude through (e.g.
        ``cost_skew``'s synthetic duration inflation). Static per plan,
        so the injected value is as deterministic as the trigger."""
        return max((s.seconds for s in self._by_site.get(site, ())),
                   default=0.0)

    def describe(self) -> list[dict]:
        return [{"site": s.site, "at": s.at, "times": s.times,
                 "seconds": s.seconds, "request": s.request,
                 "seen": s.seen} for s in self.specs]

    # ----------------------------------------------------------- firing
    @hot_path_boundary(
        "fault injection: when a plan is armed, the raise/sleep/counter"
        " work here IS the injected fault — sites guard with 'plan is "
        "not NO_FAULTS' so the disabled default pays one identity "
        "comparison")
    def trip(self, site: str, request_id=None) -> bool:
        """Count one invocation of ``site`` and fire if a spec's window
        covers it. Raises :class:`InjectedFault` for the raise sites,
        sleeps for the stall/latency sites, returns True for the
        report-only sites (page_exhaustion / heartbeat_drop /
        join_refused / cost_skew / logit_corrupt)."""
        specs = self._by_site.get(site)
        if not specs:
            return False
        fired = False
        for spec in specs:
            if spec.request and spec.request != (request_id or ""):
                continue
            spec.seen += 1
            if not spec.armed_for(spec.seen):
                continue
            fired = True
            self.fired[site] = self.fired.get(site, 0) + 1
            if site in _SLEEP_SITES and spec.seconds > 0.0:
                time.sleep(spec.seconds)
        if fired:
            self.events.emit("fault.trip", severity="warn",
                             request_id=request_id, cause=site,
                             fired=self.fired[site])
        if fired and site in _RAISE_SITES:
            raise InjectedFault(f"injected fault: {site}")
        return fired

    # ---------------------------------------------------------- parsing
    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse ``site[:k=v[,k=v...]][;site...]`` (module docstring).
        An empty/blank string parses to :data:`NO_FAULTS`. Malformed
        plans fail loudly with the offending token in the message —
        a typo'd ``GOFR_FAULTS`` silently arming nothing would make a
        chaos drill vacuously green."""
        text = (text or "").strip()
        if not text:
            return NO_FAULTS
        specs = []
        for clause in text.split(";"):
            clause = clause.strip()
            if not clause:
                raise ValueError(
                    f"empty fault clause (stray ';') in {text!r}")
            site, _, argstr = clause.partition(":")
            site = site.strip()
            if not site:
                raise ValueError(
                    f"bad fault clause {clause!r}: missing site name "
                    f"before ':'; valid sites: {', '.join(sorted(SITES))}")
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} in clause {clause!r}; "
                    f"valid sites: {', '.join(sorted(SITES))}")
            kw: dict = {}
            for pair in filter(None, (p.strip() for p in argstr.split(","))):
                key, sep, val = pair.partition("=")
                key = key.strip()
                if not sep or key not in ("at", "times", "seconds", "request"):
                    raise ValueError(
                        f"bad fault clause {clause!r}: {pair!r} is not "
                        "key=value with key in at/times/seconds/request")
                if key == "request":
                    kw[key] = val.strip()
                elif key == "seconds":
                    try:
                        kw[key] = float(val)
                    except ValueError:
                        raise ValueError(
                            f"bad fault clause {clause!r}: seconds "
                            f"expects a number, got {val!r}") from None
                else:
                    try:
                        kw[key] = int(val)
                    except ValueError:
                        raise ValueError(
                            f"bad fault clause {clause!r}: {key} "
                            f"expects an integer, got {val!r}") from None
            if kw.get("at", 1) < 1:
                raise ValueError(f"bad fault clause {clause!r}: at >= 1")
            specs.append(FaultSpec(site=site, **kw))
        return cls(specs) if specs else NO_FAULTS

    def __repr__(self) -> str:
        if not self.specs:
            return "FaultPlan(disabled)"
        return f"FaultPlan({'; '.join(s.site for s in self.specs)})"


#: The disabled plan. Call sites compare identity (``is not NO_FAULTS``)
#: so the default path costs one pointer comparison; never mutate it.
NO_FAULTS = FaultPlan(())


def plan_from_env(env: str = "GOFR_FAULTS") -> FaultPlan:
    return FaultPlan.parse(os.environ.get(env, ""))


def resolve_plan(value) -> FaultPlan:
    """Normalize ``EngineConfig.faults``: None → ``GOFR_FAULTS`` env
    (unset → :data:`NO_FAULTS`), a string → :meth:`FaultPlan.parse`,
    a plan → itself (empty plans collapse to the singleton so identity
    guards stay valid)."""
    if value is None:
        return plan_from_env()
    if isinstance(value, str):
        return FaultPlan.parse(value)
    if isinstance(value, FaultPlan):
        return value if value.specs else NO_FAULTS
    raise TypeError(f"faults must be None, str or FaultPlan, got "
                    f"{type(value).__name__}")


__all__ = ["FaultPlan", "FaultSpec", "InjectedFault", "NO_FAULTS",
           "SITES", "plan_from_env", "resolve_plan"]
