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

:class:`IncidentDetector` turns a condition an operator will be asked
about (an SLO fast burn, a restart budget overrun, a pass-cost drift, a
golden-probe mismatch) into a **bundle**: the event timeline around the
trigger, the engine's state blocks (SLO, scheduler, goodput,
watermarks, flight recorder, config, costs, integrity) and the
checkout's git identity, kept in a bounded in-memory spool (optionally
mirrored to disk) and served at ``GET /debug/incidents``.
:func:`event_timeline_diff` compares two timelines kind by kind for a
workload replay.

Fleet federation rides the control-plane heartbeat: each worker attaches
:meth:`EventLedger.digest` (its newest ``digest_size`` events and its
wall clock ``now``), and the leader's :class:`FleetEventMerger` folds the
digests into one timeline, each host's clock offset estimated from its
last digest (``GET /debug/fleet/events``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass

from ..analysis.annotations import hot_path_boundary

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
    """Knobs for the ledger and the incident spool."""

    #: fixed ring bound; beyond it the oldest event rotates out and is
    #: counted in the per-kind drop counter. 0 disables the ledger.
    capacity: int = 4096
    #: newest events attached to each heartbeat digest
    digest_size: int = 32
    #: incident bundles capture the timeline this far around the
    #: trigger (seconds)
    incident_window_s: float = 60.0
    #: one bundle per reason per this many seconds: a flapping
    #: condition must not fill the spool with near-identical bundles
    incident_debounce_s: float = 30.0
    #: bundles kept in memory (and on disk when ``spool_dir`` is set);
    #: the oldest is pruned beyond it
    spool_max: int = 8
    #: optional on-disk mirror of the bundles; None keeps them in memory
    spool_dir: str | None = None


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
    @hot_path_boundary(
        "event emission: only invoked from sites that already declared "
        "a boundary (admission, preemption, recovery, fault trips, "
        "fleet transitions) — the dict build and ring rotation here are"
        " host-side; the disabled NO_EVENTS singleton returns before "
        "the lock")
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

    def digest(self) -> dict:
        """The heartbeat piggyback: the newest ``digest_size`` events and
        this host's wall clock, from which the leader estimates the
        host's clock offset."""
        size = max(0, int(self.config.digest_size))
        with self._lock:
            events = list(self._ring.values())[-size:] if size else []
            return {"now": self.clock(), "host": self.host,
                    "seq": self._seq,
                    "dropped": dict(self.dropped),
                    "events": [dict(e) for e in events]}

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
NO_EVENTS = EventLedger(EventLedgerConfig(capacity=0, digest_size=0))


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


# ------------------------------------------------------------- incidents
# ---------------------------------------------------------------- merge
class FleetEventMerger:
    """The leader's accumulator of heartbeat event digests.

    Each host's events are deduplicated by ``seq`` into a bounded store;
    the host's clock offset is re-estimated at every ingest as
    ``received_wall - digest["now"]`` (network latency rides inside the
    estimate: enough for ordering). :meth:`timeline` merges every host
    into one list ordered by ``(corrected ts, epoch, host, seq)``: the
    epoch breaks ties, so a fence reject at epoch 1 sorts before the
    takeover at epoch 2 under skew smaller than a heartbeat."""

    def __init__(self, capacity_per_host: int = 1024,
                 clock=time.time) -> None:
        self.capacity_per_host = max(1, int(capacity_per_host))
        self.clock = clock
        self._lock = threading.Lock()
        #: host -> {"events": OrderedDict[seq, event], "offset_s": ...}
        self._hosts: dict[str, dict] = {}

    def ingest(self, host_id: str, digest: dict,
               received: float | None = None) -> None:
        if not isinstance(digest, dict):
            return
        received = self.clock() if received is None else received
        sent = digest.get("now")
        offset = (received - float(sent)) \
            if isinstance(sent, (int, float)) else 0.0
        with self._lock:
            entry = self._hosts.setdefault(
                host_id, {"events": OrderedDict(), "offset_s": 0.0,
                          "dropped": {}, "last_seen": 0.0})
            entry["offset_s"] = offset
            entry["last_seen"] = received
            entry["dropped"] = dict(digest.get("dropped") or {})
            store = entry["events"]
            for ev in digest.get("events") or ():
                if not isinstance(ev, dict) or "seq" not in ev:
                    continue
                store.setdefault(int(ev["seq"]), ev)
            while len(store) > self.capacity_per_host:
                store.popitem(last=False)

    def forget(self, host_id: str) -> None:
        with self._lock:
            self._hosts.pop(host_id, None)

    def timeline(self, *, kind: str | None = None,
                 since: float | None = None,
                 until: float | None = None,
                 n: int | None = None) -> list[dict]:
        """The merged, skew-corrected fleet timeline, oldest first;
        ``since`` / ``until`` filter on the corrected timestamps."""
        merged: list[dict] = []
        with self._lock:
            for host_id, entry in self._hosts.items():
                offset = entry["offset_s"]
                for ev in entry["events"].values():
                    rec = dict(ev)
                    if not rec.get("host"):
                        rec["host"] = host_id
                    rec["ts_corrected"] = round(
                        float(rec.get("ts", 0.0)) + offset, 6)
                    rec["skew_s"] = round(offset, 6)
                    merged.append(rec)
        if kind is not None:
            merged = [e for e in merged if e.get("kind") == kind]
        if since is not None:
            merged = [e for e in merged if e["ts_corrected"] >= since]
        if until is not None:
            merged = [e for e in merged if e["ts_corrected"] <= until]
        merged.sort(key=lambda e: (e["ts_corrected"],
                                   e.get("epoch") or 0,
                                   str(e.get("host") or ""),
                                   e.get("seq") or 0))
        if n is not None and n >= 0:
            merged = merged[-n:] if n else []
        return merged

    def header(self) -> dict:
        with self._lock:
            return {"format": EVENTS_FORMAT,
                    "version": EVENTS_VERSION, "merged": True,
                    "hosts": {h: {"offset_s": round(e["offset_s"], 6),
                                  "retained": len(e["events"]),
                                  "dropped": e["dropped"]}
                              for h, e in sorted(self._hosts.items())}}

    def to_jsonl(self, *, kind: str | None = None,
                 since: float | None = None,
                 n: int | None = None) -> str:
        lines = [json.dumps(self.header(), sort_keys=True)]
        lines.extend(json.dumps(e, sort_keys=True) for e in
                     self.timeline(kind=kind, since=since, n=n))
        return "\n".join(lines) + "\n"


def _git_digest(start: str | None = None) -> dict:
    """The checkout's identity for bundles, read straight from ``.git``
    (no subprocess) at the package's root or above it in ``start``, never
    further up. Unknown -> Nones, never a guess."""
    path = start or os.path.dirname(os.path.abspath(__file__))
    for _ in range(3):
        git = os.path.join(path, ".git")
        if os.path.isdir(git):
            try:
                with open(os.path.join(git, "HEAD"),
                          encoding="utf-8") as fh:
                    head = fh.read().strip()
                if not head.startswith("ref:"):
                    return {"commit": head, "ref": None}
                ref = head.partition(":")[2].strip()
                ref_path = os.path.join(git, *ref.split("/"))
                if os.path.exists(ref_path):
                    with open(ref_path, encoding="utf-8") as fh:
                        return {"commit": fh.read().strip(), "ref": ref}
                packed = os.path.join(git, "packed-refs")
                if os.path.exists(packed):
                    with open(packed, encoding="utf-8") as fh:
                        for line in fh:
                            if line.strip().endswith(" " + ref) or \
                                    line.strip().endswith("\t" + ref):
                                return {"commit": line.split()[0],
                                        "ref": ref}
                return {"commit": None, "ref": ref}
            except OSError:
                return {"commit": None, "ref": None}
        parent = os.path.dirname(path)
        if parent == path:
            break
        path = parent
    return {"commit": None, "ref": None}


class IncidentDetector:
    """Snapshots a diagnostic bundle when the engine does something an
    operator will be asked about: an SLO **fast_burn** trip, a
    crash-restart budget overrun (**restart_budget**), a dispatch
    signature's pass cost departing its sealed baseline
    (**cost_drift**; the trigger's attrs carry the autoprofiler's
    capture directory), or a golden probe whose digest departed its
    sealed one (**integrity**). ``failover`` and
    ``integrity_divergence`` are the fleet leader's reasons (a takeover,
    a divergence vote naming an outlier; ``serving/control_plane.py``).

    A bundle is assembled from zero-arg ``sources`` (a broken source
    contributes its error string, never aborts the capture) and the
    event timeline around the trigger. It opens with the pre-trigger
    half of the window and is **sealed** with the post-trigger half on
    the first read after ``ts + window``."""

    REASONS = ("fast_burn", "failover", "restart_budget", "cost_drift",
               "integrity", "integrity_divergence")

    def __init__(self, config: EventLedgerConfig | None = None, *,
                 ledger: EventLedger | None = None, host: str = "",
                 logger=None, clock=time.time) -> None:
        self.config = config if config is not None else EventLedgerConfig()
        self.ledger = ledger if ledger is not None else NO_EVENTS
        self.host = host
        self.logger = logger
        self.clock = clock
        #: name -> zero-arg callable returning a JSON-able state block
        self.sources: dict = {}
        #: optional callable(since, until) -> timeline; None = the
        #: ledger's own snapshot
        self.timeline_source = None
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}
        self._bundles: OrderedDict[str, dict] = OrderedDict()
        self._count = 0
        self.debounced: dict[str, int] = {}
        if self.config.spool_dir:
            try:
                os.makedirs(self.config.spool_dir, exist_ok=True)
            except OSError:
                pass

    # ---------------------------------------------------------- trigger
    def trigger(self, reason: str, *, cause: str | None = None,
                trace_id: str | None = None, epoch=None,
                attrs: dict | None = None) -> dict | None:
        """Open one incident bundle; returns its metadata, or None when
        the per-reason debounce suppressed it."""
        if reason not in self.REASONS:
            raise ValueError(f"unknown incident reason {reason!r}; "
                             f"known: {', '.join(self.REASONS)}")
        now = self.clock()
        with self._lock:
            last = self._last.get(reason)
            if last is not None and \
                    now - last < self.config.incident_debounce_s:
                self.debounced[reason] = self.debounced.get(reason, 0) + 1
                return None
            self._last[reason] = now
            self._count += 1
            incident_id = f"{self.host or 'local'}-{self._count:04d}-" \
                          f"{reason}"
        bundle = self._capture(incident_id, reason, now, cause, trace_id,
                               epoch, attrs)
        with self._lock:
            self._bundles[incident_id] = bundle
            evicted = []
            while len(self._bundles) > max(1, self.config.spool_max):
                old_id, _ = self._bundles.popitem(last=False)
                evicted.append(old_id)
        self._spool(bundle)
        for old_id in evicted:
            self._unspool(old_id)
        self.ledger.emit("incident.open", severity="error", cause=reason,
                         trace_id=trace_id, epoch=epoch,
                         incident_id=incident_id)
        if self.logger is not None:
            self.logger.warn(
                f"incident bundle {incident_id} opened: {reason}"
                + (f" ({cause})" if cause else ""),
                incident_id=incident_id, reason=reason)
        return self._meta(bundle)

    def _capture(self, incident_id, reason, now, cause, trace_id, epoch,
                 attrs) -> dict:
        window = max(0.0, float(self.config.incident_window_s))
        state = {}
        for name, source in sorted(self.sources.items()):
            try:
                state[name] = source()
            except Exception as exc:  # a broken source must not abort
                state[name] = {"error": f"{type(exc).__name__}: {exc}"}
        return {
            "format": "gofr-incident", "version": 1,
            "id": incident_id, "ts": now, "host": self.host,
            "reason": reason, "cause": cause, "trace_id": trace_id,
            "epoch": epoch, "attrs": attrs or {},
            "window_s": window, "sealed": window == 0.0,
            "timeline": self._timeline(now - window, now),
            "state": state, "git": _git_digest(),
            "ledger": self.ledger.state(),
        }

    def _timeline(self, since, until) -> list[dict]:
        source = self.timeline_source
        if source is not None:
            try:
                return source(since, until)
            except Exception:
                pass  # fall through to the local view
        return [e for e in self.ledger.snapshot(since=since)
                if float(e.get("ts", 0.0)) <= until]

    def _seal_locked(self, bundle: dict) -> None:
        """Top up the post-trigger half of the timeline on read; sealed
        once the window has fully elapsed."""
        if bundle.get("sealed"):
            return
        now = self.clock()
        until = min(now, bundle["ts"] + bundle["window_s"])
        tail = [e for e in self._timeline(bundle["ts"], until)
                if (e.get("seq"), e.get("host")) not in
                {(x.get("seq"), x.get("host")) for x in bundle["timeline"]}]
        bundle["timeline"] = bundle["timeline"] + tail
        if now >= bundle["ts"] + bundle["window_s"]:
            bundle["sealed"] = True
        self._spool(bundle)

    # ------------------------------------------------------------ spool
    def _path(self, incident_id: str) -> str | None:
        if not self.config.spool_dir:
            return None
        return os.path.join(self.config.spool_dir,
                            f"incident-{incident_id}.json")

    def _spool(self, bundle: dict) -> None:
        path = self._path(bundle["id"])
        if path is None:
            return
        try:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(bundle, fh, sort_keys=True, default=str)
            os.replace(tmp, path)
        except OSError:
            pass  # the in-memory spool is the source of truth

    def _unspool(self, incident_id: str) -> None:
        path = self._path(incident_id)
        if path is None:
            return
        try:
            os.remove(path)
        except OSError:
            pass

    # ------------------------------------------------------------- read
    @staticmethod
    def _meta(bundle: dict) -> dict:
        return {"id": bundle["id"], "ts": bundle["ts"],
                "host": bundle["host"], "reason": bundle["reason"],
                "cause": bundle["cause"], "trace_id": bundle["trace_id"],
                "sealed": bundle["sealed"],
                "events": len(bundle["timeline"])}

    def list(self) -> list[dict]:
        """Newest-last metadata for ``GET /debug/incidents``."""
        with self._lock:
            for bundle in self._bundles.values():
                self._seal_locked(bundle)
            return [self._meta(b) for b in self._bundles.values()]

    def get(self, incident_id: str) -> dict | None:
        with self._lock:
            bundle = self._bundles.get(incident_id)
            if bundle is None:
                return None
            self._seal_locked(bundle)
            return json.loads(json.dumps(bundle, default=str))

    def state(self) -> dict:
        with self._lock:
            return {"spooled": len(self._bundles),
                    "spool_max": self.config.spool_max,
                    "spool_dir": self.config.spool_dir,
                    "debounced": dict(self.debounced),
                    "last_trigger": dict(self._last)}


# ---------------------------------------------------------- replay diff
def event_timeline_diff(recorded: list[dict],
                        replayed: list[dict]) -> dict:
    """Compare two event timelines: which kinds appeared or disappeared,
    whose counts moved, and where the kind order first diverges.
    Timestamps are ignored (a replay runs at another wall clock;
    causality is the contract)."""
    rec_counts = Counter(e.get("kind") for e in recorded)
    rep_counts = Counter(e.get("kind") for e in replayed)
    missing = sorted(set(rec_counts) - set(rep_counts))
    extra = sorted(set(rep_counts) - set(rec_counts))
    counts = {kind: {"recorded": rec_counts.get(kind, 0),
                     "replayed": rep_counts.get(kind, 0)}
              for kind in sorted(set(rec_counts) | set(rep_counts))
              if rec_counts.get(kind, 0) != rep_counts.get(kind, 0)}
    rec_kinds = [e.get("kind") for e in recorded]
    rep_kinds = [e.get("kind") for e in replayed]
    first = None
    for i, (a, b) in enumerate(zip(rec_kinds, rep_kinds)):
        if a != b:
            first = {"index": i, "recorded": a, "replayed": b}
            break
    if first is None and len(rec_kinds) != len(rep_kinds):
        i = min(len(rec_kinds), len(rep_kinds))
        first = {"index": i,
                 "recorded": rec_kinds[i] if i < len(rec_kinds) else None,
                 "replayed": rep_kinds[i] if i < len(rep_kinds) else None}
    return {"diverged": bool(missing or extra or counts or first),
            "recorded_events": len(recorded),
            "replayed_events": len(replayed),
            "kinds_missing": missing, "kinds_extra": extra,
            "count_divergence": counts, "order_divergence": first}


__all__ = [
    "EVENTS_FORMAT", "EVENTS_VERSION", "KINDS", "SEVERITIES",
    "EventLedger", "EventLedgerConfig", "FleetEventMerger",
    "IncidentDetector", "NO_EVENTS",
    "event_timeline_diff", "parse_events", "resolve_ledger",
]
