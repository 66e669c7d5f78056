"""The engine's causal event ledger (the port's copy of the ledger half
of ``gofr_tpu/serving/events.py``: the same kind catalog, record shape
and ``gofr-events`` v1 JSONL).

Every action the serving stack takes (admission rejects, preemptions,
shed episodes, a crash, fault trips, recompiles, watermark crossings,
cost drift, integrity probe results) is recorded as one structured
event:

``{seq, ts, host, kind, severity, request_id?, tenant?, trace_id?,
epoch?, cause?, attrs}``

- The ring is **fixed**: ``EventLedgerConfig.capacity`` events, after
  which the oldest rotates out and is counted in a per-kind drop
  counter, so a truncated history is visible.
- Emission happens only at admission, retire, failure and sentinel
  sites, never per decoded token.
- The disabled ledger is the :data:`NO_EVENTS` singleton (capacity 0);
  ``emit`` returns before taking the lock.

Serialization: JSONL with a one-line header ``{"format": "gofr-events",
"version": 1, ...}``; :func:`parse_events` refuses unknown formats and
versions.

Left out: the fleet merger (``FleetEventMerger``, the heartbeat
``digest``) and the incident bundles (``IncidentDetector``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

#: header contract, mirroring WORKLOAD_FORMAT/WORKLOAD_VERSION
EVENTS_FORMAT = "gofr-events"
EVENTS_VERSION = 1

SEVERITIES = ("info", "warn", "error")

#: the kind catalog (docs/observability.md). Emitting an unknown kind
#: raises — a typo'd kind silently fragmenting the timeline would make
#: every ``?kind=`` query and replay diff quietly wrong.
KINDS = frozenset({
    # scheduler.py — admission and overload actions
    "sched.reject", "sched.preempt", "sched.shed_open",
    "sched.shed_close",
    # engine.py — lifecycle transitions
    "engine.restart", "engine.recovery", "engine.crash",
    "engine.drain", "engine.stranded_slot",
    # faults.py — injected failures firing
    "fault.trip",
    # control_plane.py — fleet membership and leadership
    "fleet.evict", "fleet.straggler", "fleet.stall",
    "fleet.failover", "fleet.epoch_bump", "fleet.fence_reject",
    # router.py — front-door actions
    "router.retry", "router.failover", "router.affinity_drop",
    "router.scale",
    # observability.py / costmodel.py — efficiency sentinels
    "obs.recompile", "obs.watermark", "obs.fast_burn",
    "obs.cost_drift",
    # integrity.py — output-integrity observatory: golden-probe
    # results/mismatch episodes (engine side) and the leader's
    # divergence-vote verdicts + quarantine/rejoin actions
    "obs.integrity", "fleet.integrity_divergence", "fleet.quarantine",
    # events.py itself — an incident bundle was spooled
    "incident.open",
})


@dataclass
class EventLedgerConfig:
    """Knobs for the ledger."""

    #: fixed ring bound; beyond it the oldest event rotates out and is
    #: counted in the per-kind drop counter. 0 disables the ledger.
    capacity: int = 4096


class EventLedger:
    """Bounded, thread-safe ring of structured events.

    ``emit`` runs on whichever thread owns the transition (submitter
    threads for admission, the engine thread for recovery, heartbeat
    threads for fleet changes) — all host-side, never device code."""

    def __init__(self, config: EventLedgerConfig | None = None, *,
                 host: str = "", metrics=None,
                 clock=time.time) -> None:
        self.config = config if config is not None else EventLedgerConfig()
        self.host = host
        self.metrics = metrics
        self.clock = clock
        self._capacity = max(0, int(self.config.capacity))
        self._lock = threading.Lock()
        self._ring: OrderedDict[int, dict] = OrderedDict()
        self._seq = 0
        #: per-kind counts of events rotated out of the ring
        self.dropped: dict[str, int] = {}
        #: per-kind lifetime emission counts
        self.totals: dict[str, int] = {}

    # ------------------------------------------------------------ state
    @property
    def enabled(self) -> bool:
        return self._capacity > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------- emit
    def emit(self, kind: str, *, severity: str = "info",
             request_id=None, tenant=None, trace_id=None, epoch=None,
             cause=None, t: float | None = None, **attrs):
        """Record one event; returns the record, or None when disabled.

        Unknown kinds and severities raise (fail loudly — see
        :data:`KINDS`)."""
        if not self._capacity:
            return None
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r}; known: "
                             f"{', '.join(sorted(KINDS))}")
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}; known: "
                             f"{', '.join(SEVERITIES)}")
        evicted_kind = None
        with self._lock:
            self._seq += 1
            event = {"seq": self._seq,
                     "ts": self.clock() if t is None else float(t),
                     "host": self.host, "kind": kind,
                     "severity": severity}
            if request_id is not None:
                event["request_id"] = request_id
            if tenant is not None:
                event["tenant"] = tenant
            if trace_id is not None:
                event["trace_id"] = trace_id
            if epoch is not None:
                event["epoch"] = int(epoch)
            if cause is not None:
                event["cause"] = cause
            if attrs:
                event["attrs"] = attrs
            if len(self._ring) >= self._capacity:
                _, old = self._ring.popitem(last=False)
                evicted_kind = old["kind"]
                self.dropped[evicted_kind] = \
                    self.dropped.get(evicted_kind, 0) + 1
            self._ring[self._seq] = event
            self.totals[kind] = self.totals.get(kind, 0) + 1
        m = self.metrics
        if m is not None:
            m.increment_counter("app_events_total", kind=kind)
            if evicted_kind is not None:
                m.increment_counter("app_events_dropped",
                                    kind=evicted_kind)
        return event

    # --------------------------------------------------------- snapshot
    def snapshot(self, *, kind: str | None = None,
                 since: float | None = None,
                 n: int | None = None) -> list[dict]:
        """Filtered copy of the retained events, oldest first."""
        with self._lock:
            events = list(self._ring.values())
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        if since is not None:
            events = [e for e in events if e["ts"] >= since]
        if n is not None and n >= 0:
            events = events[-n:] if n else []
        return [dict(e) for e in events]

    def header(self) -> dict:
        """The ``gofr-events`` JSONL header line object."""
        with self._lock:
            return {"format": EVENTS_FORMAT, "version": EVENTS_VERSION,
                    "host": self.host, "seq": self._seq,
                    "retained": len(self._ring),
                    "dropped": dict(self.dropped)}

    def to_jsonl(self, *, kind: str | None = None,
                 since: float | None = None,
                 n: int | None = None) -> str:
        lines = [json.dumps(self.header(), sort_keys=True)]
        lines.extend(json.dumps(e, sort_keys=True) for e in
                     self.snapshot(kind=kind, since=since, n=n))
        return "\n".join(lines) + "\n"

    def state(self) -> dict:
        """The ``GET /debug/events`` sidecar state (ring accounting)."""
        with self._lock:
            return {"enabled": self.enabled,
                    "capacity": self._capacity,
                    "retained": len(self._ring), "seq": self._seq,
                    "totals": dict(self.totals),
                    "dropped": dict(self.dropped)}


#: The disabled ledger. Wiring compares identity (``is not NO_EVENTS``)
#: where it matters; ``emit`` on it is a two-comparison no-op. Never
#: mutate it.
NO_EVENTS = EventLedger(EventLedgerConfig(capacity=0))


def resolve_ledger(value, *, host: str = "", metrics=None,
                   clock=time.time) -> EventLedger:
    """Normalize an ``events`` config knob: an :class:`EventLedger` →
    itself; ``None``/``True`` → a default-capacity ledger (unless
    ``GOFR_EVENTS`` is ``0``/``false``/``off``); ``False`` →
    :data:`NO_EVENTS`; an :class:`EventLedgerConfig` → a ledger built
    from it (capacity 0 collapses to the singleton)."""
    if isinstance(value, EventLedger):
        return value
    if value is False:
        return NO_EVENTS
    if value is None or value is True:
        if os.environ.get("GOFR_EVENTS", "").strip().lower() in \
                ("0", "false", "off"):
            return NO_EVENTS
        return EventLedger(host=host, metrics=metrics, clock=clock)
    if isinstance(value, EventLedgerConfig):
        if value.capacity <= 0:
            return NO_EVENTS
        return EventLedger(value, host=host, metrics=metrics,
                           clock=clock)
    raise TypeError(f"events must be None, bool, EventLedgerConfig or "
                    f"EventLedger, got {type(value).__name__}")


# ---------------------------------------------------------------- parse
def parse_events(text: str) -> tuple[dict, list[dict]]:
    """Parse a ``gofr-events`` JSONL capture; refuses unknown formats
    and versions (same contract as ``replay.parse_workload``)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty events capture")
    header = json.loads(lines[0])
    if not isinstance(header, dict) or \
            header.get("format") != EVENTS_FORMAT:
        raise ValueError(
            f"not a {EVENTS_FORMAT} capture: header {lines[0][:120]!r}")
    if header.get("version") != EVENTS_VERSION:
        raise ValueError(
            f"unsupported {EVENTS_FORMAT} version "
            f"{header.get('version')!r} (this reader speaks "
            f"{EVENTS_VERSION})")
    events = [json.loads(ln) for ln in lines[1:]]
    for ev in events:
        if not isinstance(ev, dict) or "kind" not in ev or "ts" not in ev:
            raise ValueError(f"malformed event record: {ev!r}")
    return header, events


__all__ = [
    "EVENTS_FORMAT", "EVENTS_VERSION", "KINDS", "SEVERITIES",
    "EventLedger", "EventLedgerConfig", "NO_EVENTS", "parse_events",
    "resolve_ledger",
]
