"""Multi-host serving control plane: join, rank assignment, health
gossip, failure detection, elastic regeneration, leader high
availability and integrity voting (the port's copy of
``gofr_tpu/serving/control_plane.py``, with the same protocol, names and
routes).

The leader is a set of routes on a port server (``app.ChatServer``:
:meth:`ControlPlaneLeader.install`); workers dial it through the port's
synchronous service client (``gofr_tpu_torch.service``: retry and
circuit breaker) from a heartbeat thread (:class:`WorkerAgent`).
``app.serve_fleet_leader`` and ``app.join_fleet`` wire both to a server.
The data plane a rank feeds is ``torch.distributed``: an assignment's
:meth:`ShardAssignment.dist_init_args` are the arguments of its
``init_process_group``, and :func:`tp_engine` hands off from there to a
``{"tp": world_size}`` mesh and the tensor-parallel engine on it (the
JAX package's ``jax.distributed.initialize`` hand-off and its one SPMD
program over both processes).

Protocol (JSON over HTTP, the ``{"data": ...}`` envelope):

- ``POST /control/join`` {host_id, address, n_devices, health?, epoch?,
  takeover?} -> {generation, assignment, epoch}; bumps the generation:
  membership changed, every host must re-coordinate.
- ``POST /control/heartbeat`` {host_id, generation, health?, summary?,
  metrics?, events?, address?, epoch?} -> {ok, changed, generation,
  assignment, epoch}: a worker heartbeating with a stale generation
  learns its new assignment there (ranks are contiguous again after an
  eviction or a join). ``summary`` is the worker's flight-recorder
  digest (pass p50 / p95, occupancy, queue depth, tokens/s, goodput,
  the prefix-cache digest the router scores, golden-probe digests),
  ``metrics`` its ``Manager.snapshot()``, ``events`` its event ledger's
  digest: the fleet's observability rides the heartbeats.
- ``POST /control/leave`` {host_id, epoch?}: a graceful deregistration.
- ``GET /control/leader``: the lease (active, epoch, rank, candidates),
  safe on any candidate; ``GET /control/topology``: members, ranks and
  gossiped health (also the leader server's health route).
- ``GET /control/fleet/metrics``: the FEDERATED Prometheus surface, every
  member's snapshot under ``host`` / ``rank`` labels plus the leader's
  own ``app_fleet_*`` (and ``app_router_*``) series.
- ``GET /debug/fleet``: per-host summaries, pass / occupancy skew,
  stragglers, the integrity vote, counter totals, the router's state;
  ``GET /debug/fleet/events``: the merged skew-corrected timeline;
  ``GET /debug/fleet/incidents``: the leader's incident bundles.

Failure detection: the leader's sweeper evicts a host that missed
``eviction_misses`` heartbeat intervals and bumps the generation. The
leader's own pauses (a long garbage collection, a starved host) are not
counted as the members' silence: the sweeper notes each time it woke
late and credits that stall to every member that was silent across it.
Workers beat at a fixed cadence, one interval after the previous beat
began, so a slow beat does not add its own length to the silence. A
heartbeat gossiping DEGRADED health (the stall watchdog fired) is
evicted at once under ``FleetConfig.evict_degraded``; DOWN keeps
gossiping, visible, unrouted.

Leader high availability (``FleetConfig.leader_candidates``): rank 0
boots active at epoch 1, higher ranks standby at epoch 0. Election is
worker-driven and deterministic: a worker that misses
``missed_acks_before_failover`` acks (or meets a typed ``stale_leader`` /
``not_leader``) probes ``GET /control/leader`` across the candidates in
rank order and elects by a pure function of the probes: the active
candidate with the highest epoch (ties to the lowest rank), else the
lowest-ranked live one by a takeover join at ``max(epochs seen) + 1``.
Every control message carries the epoch both ways and both sides fence:
a leader receiving a higher epoch refuses with a typed ``stale_leader``
409 and demotes itself; a worker rejects a lower-epoch ack and
re-discovers. The new leader rebuilds membership, digests and routing
from the next heartbeat round.

Stragglers: max / median skew of p95 pass duration and of occupancy
(``app_fleet_pass_skew`` / ``_occupancy_skew`` / ``_straggler_ratio``),
per dispatch signature when two or more hosts federate cost tables.

Integrity divergence voting: with ``FleetConfig.integrity_quorum`` or
more hosts reporting a digest for the same golden probe, the leader
majority-votes; a minority host is QUARANTINED (the routing view stops
advertising it UP), with one ``fleet.integrity_divergence`` event and
one incident bundle an episode, and rejoins after
``integrity_clean_probes`` new agreeing probes.

Cross-host traces: join / heartbeat RPCs carry ``traceparent`` (a
``control.*`` span on the worker), and both sides set the process-wide
fleet context (host_id / rank / generation) that the tracer and the
logger merge into every span and record.

Everything here is host work on data the engine already records,
read on heartbeat threads.
"""

from __future__ import annotations

import random
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from ..metrics import merge_snapshots, render_federated
from ..tracing import current_span
from ..service import (CircuitBreaker, Retry, new_http_service,
                       probe_leader)
from .events import (NO_EVENTS, FleetEventMerger, IncidentDetector,
                     resolve_ledger)
from .faults import NO_FAULTS, resolve_plan
from .logger import set_fleet_context
from .responses import (ErrorEntityNotFound, ErrorInvalidParam,
                        ErrorServiceUnavailable, File, HTTPError)


class StaleGeneration(HTTPError):
    """The leader no longer knows this host: a 409 telling the worker
    to rejoin (which returns the fresh assignment)."""

    status_code = 409


class StaleLeader(HTTPError):
    """Epoch fence: the caller presented a HIGHER epoch than this
    leader holds, proving a newer leader was elected while this one
    was away — the write is refused and this leader demotes itself.
    409, not 503: the conflict is permanent for this epoch, retrying
    the same leader is pointless (re-discover instead)."""

    status_code = 409


class NotLeader(ErrorServiceUnavailable):
    """A control or data-plane request hit a standby candidate: a
    typed 503 whose details carry the epoch and candidate ranks so
    the caller can walk ``GET /control/leader`` and re-dial."""


@dataclass
class FleetConfig:
    """Knobs for the fleet plane."""

    #: workers attach ``Manager.snapshot()`` to heartbeats and the
    #: leader serves the federated surface; off = heartbeats carry
    #: only health + flight summary (cheaper wire, no /fleet/metrics
    #: series for this worker)
    federation: bool = True
    #: a host whose p95 pass duration exceeds this multiple of the
    #: fleet median is flagged a straggler (gauge + WARN)
    straggler_ratio: float = 2.0
    #: evict a member the moment its heartbeat gossips DEGRADED
    #: health (stall watchdog escalation) instead of waiting for
    #: heartbeat silence
    evict_degraded: bool = True
    #: ranked leader candidate base URLs for HA; index = rank. Empty
    #: (the default) is single-leader mode: the one leader is active
    #: and workers never run the discovery walk
    leader_candidates: tuple = ()
    #: convergence budget a takeover advertises to clients (the
    #: Retry-After on ``leader_takeover`` 503s); response shaping
    #: only — never an election input
    leader_lease_s: float = 10.0
    #: consecutive heartbeat acks a worker may miss before it runs
    #: the candidate discovery walk (typed stale_leader / not_leader
    #: evidence fails over immediately, without waiting this out)
    missed_acks_before_failover: int = 3
    #: minimum hosts reporting a digest for the SAME golden probe
    #: before the leader majority-votes on it (integrity divergence
    #: detection needs a tie-breaker: with 2 hosts a mismatch names
    #: nobody, with 3 the odd one out is the outlier)
    integrity_quorum: int = 3
    #: consecutive NEW (seq-advanced) majority-agreeing probe
    #: observations a quarantined host must post before the leader
    #: lifts the quarantine and the router routes to it again
    integrity_clean_probes: int = 2


def engine_fleet_sources(engine: Any) -> tuple[Callable[[], dict],
                                               Callable[[], dict],
                                               Callable[[], dict | None]]:
    """(health, summary, metrics) heartbeat sources for a WorkerAgent
    wrapping a serving engine: gossip-sized health, the flight
    recorder's fleet digest, and the attached metrics manager's
    snapshot. All host-side reads — safe at heartbeat cadence."""

    def health() -> dict:
        h = engine.health_check()
        out = {"status": h.get("status", "UP")}
        for key in ("error", "stalled_for_s", "stalls", "restarts",
                    "last_crash", "stranded_slots"):
            if key in h:
                out[key] = h[key]
        return out

    def summary() -> dict:
        recorder = getattr(engine, "recorder", None)
        out = recorder.fleet_summary() if recorder is not None \
            and recorder.enabled else {}
        out["active_slots"] = sum(r is not None for r in engine.active)
        out["waiting"] = engine.waiting.qsize()
        out["total_generated"] = engine.total_generated
        return out

    def metrics() -> dict | None:
        manager = getattr(engine, "metrics", None)
        if manager is None or not hasattr(manager, "snapshot"):
            return None
        return manager.snapshot()

    return health, summary, metrics


@dataclass
class ShardAssignment:
    """One host's slice of the serving group."""

    host_id: str
    rank: int
    world_size: int
    n_devices: int
    generation: int
    coordinator: str  # host:port the rank-0 process listens on

    def dist_init_args(self) -> dict[str, Any]:
        """kwargs for ``torch.distributed.init_process_group``: the
        hand-off from the control plane to the data plane (the JAX
        package's ``jax_initialize_args``)."""
        return {"init_method": f"tcp://{self.coordinator}",
                "world_size": self.world_size,
                "rank": self.rank}

    def to_dict(self) -> dict[str, Any]:
        return {"host_id": self.host_id, "rank": self.rank,
                "world_size": self.world_size,
                "n_devices": self.n_devices,
                "generation": self.generation,
                "coordinator": self.coordinator}


def tp_engine(assignment: ShardAssignment, params: Any, model_config: Any,
              engine_config: Any = None, *, device: Any = None,
              backend: str | None = None, timeout_s: float = 600.0,
              quantize: str | None = None):
    """The hand-off from the control plane to tensor-parallel serving:
    ``init_process_group(**assignment.dist_init_args())`` on ``device``
    (``backend``: ``nccl`` for CUDA by default, ``gloo`` where ranks
    share a card or run on the CPU; ``timeout_s`` bounds every
    collective), a ``{"tp": world_size}`` mesh over the ranks, and
    ``llama_engine(params, ..., mesh=)`` on it. Every rank calls this
    with the same ``params``; rank 0 gets the engine to start and
    serve, every other rank the one to pass to
    ``serving.lockstep.follow``."""
    from ..parallel.mesh import create_mesh, init_process_group
    from .glue import llama_engine
    init_process_group(device, timeout_s=timeout_s, backend=backend,
                       **assignment.dist_init_args())
    mesh = create_mesh({"tp": assignment.world_size})
    return llama_engine(params, model_config, engine_config, mesh=mesh,
                        quantize=quantize)


@dataclass
class _Member:
    host_id: str
    address: str
    n_devices: int
    last_seen: float
    health: dict = field(default_factory=dict)
    #: flight-recorder digest from the last heartbeat (straggler math)
    summary: dict = field(default_factory=dict)
    #: last attached Manager.snapshot() (metrics federation)
    metrics_snapshot: dict | None = None


#: gauge / counter families the leader writes; registered on the
#: leader's (and an agent's) manager where absent
_FLEET_GAUGES = (
    ("app_fleet_world_size", "control-plane serving-group members"),
    ("app_fleet_generation", "control-plane membership generation"),
    ("app_fleet_pass_skew",
     "max/median p95 pass duration across hosts (1 = balanced)"),
    ("app_fleet_occupancy_skew",
     "max/median mean batch occupancy across hosts"),
    ("app_fleet_straggler_ratio",
     "fraction of hosts whose p95 pass duration exceeds "
     "straggler_ratio x the fleet median"),
    ("app_fleet_goodput_ratio",
     "fleet-wide useful device time over busy device time, summed "
     "across member heartbeat goodput digests"),
    ("app_fleet_leader_epoch",
     "this leader's election epoch (monotone across failovers; the "
     "fleet-wide max identifies the active leader)"),
    ("app_fleet_quarantined_hosts",
     "hosts currently quarantined by the integrity divergence vote "
     "(routed traffic share held at zero until they rejoin)"),
)
_FLEET_COUNTERS = (
    ("app_fleet_evictions",
     "hosts evicted from the serving group (by reason label)"),
    ("app_fleet_heartbeats", "control-plane heartbeats received"),
    ("app_fleet_failovers",
     "leader failovers observed (by reason label: missed_acks, "
     "stale_leader, not_leader on workers; takeover on the leader "
     "that activated)"),
    ("app_fleet_stale_leader_rejects",
     "control writes refused by epoch fencing: a revived stale "
     "leader rejecting (and demoting on) higher-epoch messages"),
    ("app_fleet_quarantines",
     "integrity-divergence quarantine actions (by action label: "
     "quarantine when the vote names an outlier, rejoin when its "
     "clean-probe streak clears it)"),
)


class ControlPlaneLeader:
    """Leader state and the routes that expose it. Attach to a port
    server:

    >>> leader = ControlPlaneLeader(coordinator="10.0.0.1:8476")
    >>> leader.install(server)     # POST /control/join, /control/heartbeat
    """

    def __init__(self, *, coordinator: str = "",
                 heartbeat_interval_s: float = 2.0,
                 eviction_misses: int = 3,
                 fleet: FleetConfig | None = None,
                 host_id: str = "",
                 rank: int = 0,
                 metrics: Any = None,
                 logger: Any = None,
                 faults: Any = None,
                 events: Any = None) -> None:
        self.coordinator = coordinator
        self.heartbeat_interval_s = heartbeat_interval_s
        self.eviction_misses = eviction_misses
        self.fleet = fleet if fleet is not None else FleetConfig()
        self.host_id = host_id
        self.metrics = metrics
        self.logger = logger
        #: deterministic fault plan for the leader-side HA sites
        #: leader_down / leader_partition / stale_epoch_replay
        self.faults = resolve_plan(faults)
        #: this candidate's position in fleet.leader_candidates; rank
        #: 0 boots active at epoch 1, higher ranks boot standby at
        #: epoch 0 awaiting a takeover join
        self.rank = int(rank)
        self.epoch = 1 if self.rank == 0 else 0
        self.active = self.rank == 0
        #: activated-by-takeover and no member heartbeat landed yet:
        #: the router answers typed leader_takeover 503s until the
        #: first join converges the rebuilt state (count-based, not
        #: clock-based — deterministic)
        self._took_over = False
        self._stale_rejects = 0
        self.generation = 0
        self._members: dict[str, _Member] = {}
        self._stragglers: set[str] = set()
        #: hosts quarantined by the integrity divergence vote:
        #: host_id -> {golden_id, digest, majority, voters, last_seq,
        #: clean}. Membership here IS the episode latch — the
        #: divergence event/bundle fire exactly once, on entry — and
        #: the routing view reports these hosts QUARANTINED
        self._quarantined: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._sweeper: threading.Thread | None = None
        self._running = False
        #: the sweeper's own stalls, (woke_at, seconds late): silence a
        #: member owes to the leader's pause is not a missed heartbeat
        self.stalls: list[tuple[float, float]] = []
        #: every stall the sweeper noted, counted and the longest kept
        self.stall_count = 0
        self.stall_max_s = 0.0
        #: callbacks (host_id, reason) fired after a member leaves the
        #: group for any reason (leave, sweep, degraded, scale_down) —
        #: the fleet router drops its session-affinity entries here
        self.evict_listeners: list = []
        #: callbacks (host_id, action) fired on integrity quarantine
        #: transitions, action in {"quarantine", "rejoin"} — the fleet
        #: router drops affinity to a quarantined host and counts the
        #: action in its debug state
        self.quarantine_listeners: list = []
        #: extra named () -> dict blocks merged into fleet_status()
        #: (``/debug/fleet``) — the router publishes its state here
        self.status_sources: dict[str, Any] = {}
        #: the leader's own event ledger: failovers, fence rejects,
        #: evictions, stragglers, votes, the router's retries
        self.events = resolve_ledger(events, host=host_id,
                                     metrics=metrics)
        #: per-host heartbeat event digests merged into the
        #: skew-corrected fleet timeline (``GET /debug/fleet/events``);
        #: evicted hosts' events are retained — the bundle for an
        #: incident that killed a host must still show its last acts
        self.merger = FleetEventMerger()
        #: incident auto-snapshot riding the merged timeline — the
        #: ``failover`` trigger fires here when a takeover commits
        self.incidents = IncidentDetector(self.events.config,
                                          ledger=self.events,
                                          host=host_id, logger=logger)
        self.incidents.timeline_source = self._incident_timeline
        self.incidents.sources.update({
            "leadership": self.leadership,
            "fleet": self.fleet_status,
        })
        if metrics is not None:
            self._register_metrics(metrics)

    # ---------------------------------------------------- fleet metrics
    @staticmethod
    def _register_metrics(metrics: Any) -> None:
        for name, desc in _FLEET_GAUGES:
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        for name, desc in _FLEET_COUNTERS:
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)

    def _set_membership_gauges(self) -> None:
        if self.metrics is None:
            return
        self.metrics.set_gauge("app_fleet_world_size",
                               float(len(self._members)))
        self.metrics.set_gauge("app_fleet_generation",
                               float(self.generation))
        self.metrics.set_gauge("app_fleet_leader_epoch",
                               float(self.epoch))

    # ------------------------------------------------------- leadership
    def leadership(self) -> dict:
        """The lease state, consistently snapshotted: served by
        ``GET /control/leader`` and read by the router's data-plane
        gate."""
        with self._lock:
            return {"active": self.active, "epoch": self.epoch,
                    "rank": self.rank, "host_id": self.host_id,
                    "converging": self.active and self._took_over
                    and not self._members,
                    "candidates": list(self.fleet.leader_candidates),
                    "stale_rejects": self._stale_rejects}

    def ensure_active(self, worker_epoch: int = -1) -> bool:
        """Takeover activation: a worker that lost the old leader
        elects this candidate by joining with ``takeover``. Activates
        at ``max(own epoch, worker epoch) + 1`` — strictly above
        anything either side has seen, so every subsequent control
        message fences the old leader. Idempotent under concurrent
        takeover joins: once one wins, later joins with lower or
        equal evidence see ``active`` with a higher epoch and do not
        re-bump. Counts and epochs only — no clocks, no RNG."""
        with self._lock:
            if self.active and self.epoch > int(worker_epoch):
                return False  # an earlier takeover already won
            self.epoch = max(self.epoch, int(worker_epoch)) + 1
            self.active = True
            self._took_over = True
            epoch = self.epoch
        if self.metrics is not None:
            self.metrics.set_gauge("app_fleet_leader_epoch",
                                   float(epoch))
            self.metrics.increment_counter("app_fleet_failovers",
                                           reason="takeover")
        if self.logger:
            self.logger.warn("standby leader activated by takeover",
                             epoch=epoch, rank=self.rank)
        # The takeover join arrives over HTTP, so the middleware has a
        # server span open carrying the worker's trace — stamp its
        # trace_id onto the failover record and the incident so the
        # bundle resolves back to the exact request that elected us.
        span = current_span()
        trace_id = span.trace_id if span is not None else None
        self.events.emit("fleet.epoch_bump", epoch=epoch,
                         cause="takeover", trace_id=trace_id)
        self.events.emit("fleet.failover", severity="error",
                         cause="takeover", epoch=epoch, rank=self.rank,
                         trace_id=trace_id)
        self.incidents.trigger(
            "failover", epoch=epoch, trace_id=trace_id,
            cause=f"standby rank {self.rank} activated at epoch "
                  f"{epoch} by worker takeover")
        return True

    def _fence(self, worker_epoch: int) -> None:
        """Epoch fencing for control-plane writes. A request carrying
        a higher epoch than this leader holds proves a newer leader
        was elected while this one was away: refuse the write with a
        typed ``stale_leader`` 409, count it, and demote to standby —
        a revived old leader can never accept state, so there is no
        split brain to reconcile. A standby (including an already-
        demoted leader) refuses non-takeover writes with a typed
        ``not_leader`` 503 naming the candidate ranks, whatever epoch
        the caller carries — it never claimed the lease, so there is
        nothing stale to demote. Callers with no epoch (pre-HA
        workers) pass -1, which never out-ranks an active leader."""
        with self._lock:
            if self.active and worker_epoch > self.epoch:
                self.active = False
                self._stale_rejects += 1
                verdict, epoch = "stale", self.epoch
            elif not self.active:
                verdict, epoch = "standby", self.epoch
            else:
                return
        if verdict == "stale":
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_fleet_stale_leader_rejects")
            if self.logger:
                self.logger.warn(
                    "stale leader fenced: refusing control write and "
                    "demoting to standby", epoch=epoch,
                    caller_epoch=worker_epoch)
            self.events.emit("fleet.fence_reject", severity="warn",
                             cause="stale_leader", epoch=epoch,
                             caller_epoch=worker_epoch)
            raise StaleLeader(
                f"stale leader: caller epoch {worker_epoch} is ahead "
                f"of this leader's epoch {epoch}",
                details={"code": "stale_leader", "epoch": epoch})
        raise NotLeader(
            "not the active leader; walk GET /control/leader across "
            "the candidates and re-dial",
            details={"code": "not_leader", "epoch": epoch,
                     "candidates": list(self.fleet.leader_candidates)},
            headers={"Retry-After": "1"})

    # ------------------------------------------------------------ state
    def _ranks_locked(self) -> dict[str, int]:
        """THE rank mapping: deterministic contiguous ranks sorted by
        host_id, so every caller computes the same view for a given
        membership. Both assignments and topology derive from here."""
        return {h: i for i, h in enumerate(sorted(self._members))}

    def _assignment_locked(self, host_id: str) -> ShardAssignment:
        ranks = self._ranks_locked()
        return ShardAssignment(
            host_id=host_id, rank=ranks[host_id],
            world_size=len(ranks),
            n_devices=self._members[host_id].n_devices,
            generation=self.generation, coordinator=self.coordinator)

    def join(self, host_id: str, address: str, n_devices: int,
             health: dict | None = None, *, epoch: int = -1,
             takeover: bool = False) -> ShardAssignment:
        if not host_id:
            raise ErrorInvalidParam("host_id")
        if takeover:
            self.ensure_active(epoch)
        else:
            self._fence(epoch)
        with self._lock:
            self.generation += 1  # membership changed for everyone
            self._members[host_id] = _Member(
                host_id=host_id, address=address,
                n_devices=max(1, int(n_devices)),
                last_seen=time.time(), health=dict(health or {}))
            # first member after a takeover: the rebuilt view is live,
            # stop answering the data plane with leader_takeover 503s
            self._took_over = False
            assignment = self._assignment_locked(host_id)
        self._set_membership_gauges()
        if self.logger:
            self.logger.info(
                "host joined serving group", host=host_id,
                rank=assignment.rank, world=assignment.world_size,
                generation=self.generation)
        return assignment

    def heartbeat(self, host_id: str, generation: int,
                  health: dict | None = None,
                  summary: dict | None = None,
                  metrics_snapshot: dict | None = None,
                  address: str = "", epoch: int = -1,
                  events: dict | None = None
                  ) -> tuple[ShardAssignment | None, bool]:
        """-> (assignment, changed): ``changed`` is True when the
        worker's view was stale — its signal to re-coordinate.
        ``assignment`` is None when the heartbeat itself got the host
        evicted (DEGRADED health under ``FleetConfig.evict_degraded``)
        — the route answers with an eviction notice, not a 409, so
        the agent backs off instead of instantly rejoining wedged."""
        self._fence(epoch)
        degraded = False
        with self._lock:
            member = self._members.get(host_id)
            if member is None:
                raise StaleGeneration("unknown host: rejoin required")
            member.last_seen = time.time()
            if address and member.address != address:
                # ephemeral-port workers learn their dial address only
                # once their server binds — adopt it from the beat so
                # the data-plane router can reach them
                member.address = address
            if health is not None:
                member.health = dict(health)
            if summary is not None:
                member.summary = dict(summary)
            if metrics_snapshot is not None:
                member.metrics_snapshot = metrics_snapshot
            # DEGRADED (the stall-watchdog escalation) evicts NOW so
            # survivors re-rank; DOWN keeps gossiping — a dead engine
            # whose agent still heartbeats stays visible to operators
            # in topology/health rather than silently vanishing
            status = member.health.get("status", "UP")
            if status == "DEGRADED" and self.fleet.evict_degraded:
                degraded = True
            else:
                assignment = self._assignment_locked(host_id)
                changed = generation != self.generation
        if events:
            # the event-digest piggyback: fold this host's newest
            # events (and its wall clock, for the skew estimate) into
            # the fleet timeline
            self.merger.ingest(host_id, events)
        if self.metrics is not None:
            self.metrics.increment_counter("app_fleet_heartbeats",
                                           host=host_id)
        if degraded:
            self.evict(host_id, reason="degraded")
            return None, True
        self._recompute_skew()
        self._vote_integrity()
        return assignment, changed

    def evict(self, host_id: str, reason: str = "manual") -> None:
        with self._lock:
            if self._members.pop(host_id, None) is None:
                return
            self.generation += 1
            self._stragglers.discard(host_id)
            # an evicted host's quarantine episode ends with it — a
            # rejoin starts from a clean slate (fresh digests re-vote)
            self._quarantined.pop(host_id, None)
        self._set_membership_gauges()
        if self.metrics is not None:
            self.metrics.increment_counter("app_fleet_evictions",
                                           reason=reason)
        if self.logger:
            self.logger.warn("host evicted from serving group",
                             host=host_id, reason=reason,
                             generation=self.generation)
        self.events.emit("fleet.evict", severity="warn", cause=reason,
                         epoch=self.epoch, evicted=host_id,
                         generation=self.generation)
        for listener in list(self.evict_listeners):
            try:
                listener(host_id, reason)
            except Exception:
                pass  # a broken listener must not block membership

    def add_evict_listener(self, fn: Any) -> None:
        self.evict_listeners.append(fn)

    def add_quarantine_listener(self, fn: Any) -> None:
        self.quarantine_listeners.append(fn)

    def routing_view(self) -> list[dict]:
        """Snapshot for the data-plane router: one dict per member
        with the address to dial, health status, and the latest
        heartbeat summary (queue depth, pass timings, prefix digest).
        An integrity-quarantined host reports QUARANTINED here — the
        router only routes to UP members, so quarantine needs no
        router-side special case to stop traffic."""
        with self._lock:
            return [{"host_id": m.host_id, "address": m.address,
                     "status": "QUARANTINED"
                     if m.host_id in self._quarantined
                     else m.health.get("status", "UP"),
                     "summary": dict(m.summary)}
                    for m in self._members.values()]

    def topology(self) -> dict[str, Any]:
        with self._lock:
            ranks = self._ranks_locked()
            return {
                "generation": self.generation,
                "epoch": self.epoch,
                "active": self.active,
                "world_size": len(self._members),
                "members": {
                    m.host_id: {"address": m.address,
                                "n_devices": m.n_devices,
                                "rank": ranks[m.host_id],
                                "last_seen": m.last_seen,
                                "health": m.health}
                    for m in self._members.values()},
            }

    def health_check(self) -> dict[str, Any]:
        topo = self.topology()
        degraded = [h for h, m in topo["members"].items()
                    if m["health"].get("status") not in (None, "UP")]
        status = "UP" if not degraded else "DEGRADED"
        return {"status": status,
                "details": {"generation": topo["generation"],
                            "world_size": topo["world_size"],
                            "degraded_hosts": degraded}}

    # ------------------------------------------------------- stragglers
    @staticmethod
    def _skew(values: dict[str, float]) -> tuple[float, str | None]:
        """max/median of per-host values -> (skew, worst host). 1.0
        when balanced or under 2 hosts report."""
        if len(values) < 2:
            return 1.0, None
        med = statistics.median(values.values())
        if med <= 0:
            return 1.0, None
        worst = max(values, key=values.get)
        return values[worst] / med, worst

    @staticmethod
    def _dominant_waste(waste: Mapping | None) -> str | None:
        """Largest waste cause from a heartbeat summary's ``waste_s``
        map — the leader's one-word answer to WHY a host is slow."""
        if not isinstance(waste, Mapping) or not waste:
            return None
        cause = max(waste, key=lambda c: float(waste.get(c) or 0.0))
        return cause if float(waste.get(cause) or 0.0) > 0 else None

    def _recompute_skew(self) -> dict:
        """Leader-side straggler math over the latest heartbeat
        summaries: pure host arithmetic, called at heartbeat cadence.
        Returns the fleet digest served by ``/debug/fleet``."""
        with self._lock:
            p95s = {h: float(m.summary["pass_p95_s"])
                    for h, m in self._members.items()
                    if isinstance(m.summary.get("pass_p95_s"),
                                  (int, float))}
            occs = {h: float(m.summary["occupancy_mean"])
                    for h, m in self._members.items()
                    if isinstance(m.summary.get("occupancy_mean"),
                                  (int, float))}
            # goodput federation: heartbeat summaries carry each
            # host's busy/useful/waste digest (FlightRecorder.
            # fleet_summary via the engine's GoodputMeter)
            goodputs = {h: {"busy_s": float(m.summary["busy_s"]),
                            "useful_s": float(
                                m.summary.get("useful_s", 0.0)),
                            "waste_s": dict(m.summary.get("waste_s")
                                            or {})}
                        for h, m in self._members.items()
                        if isinstance(m.summary.get("busy_s"),
                                      (int, float))}
            # cost federation: heartbeat summaries carry each host's
            # per-signature cost table (FlightRecorder.fleet_summary
            # via the engine's CostModel)
            costs = {h: dict(m.summary["costs"])
                     for h, m in self._members.items()
                     if isinstance(m.summary.get("costs"), Mapping)
                     and m.summary.get("costs")}
            world = len(self._members)
        pass_skew, worst = self._skew(p95s)
        occ_skew, _ = self._skew(occs)
        threshold = self.fleet.straggler_ratio
        med = statistics.median(p95s.values()) if len(p95s) >= 2 else 0.0
        stragglers = sorted(h for h, v in p95s.items()
                            if med > 0 and v > threshold * med)
        # Signature-normalized straggler mode: the raw p95 comparison
        # above confounds "this host is slow" with "this host happens
        # to serve heavier shapes" — a host decoding at window 2048
        # legitimately posts fatter passes than one at 512. When >=2
        # hosts federate cost tables, compare each host's mean pass
        # cost for the SAME dispatch signature against the fleet
        # median for that signature, and name the offending signature
        # so the operator lands on the kernel, not the host.
        straggler_mode = "p95"
        straggler_signatures: dict[str, str] = {}
        sig_medians: dict[str, float] = {}
        if len(costs) >= 2:
            straggler_mode = "signature"
            by_sig: dict[str, dict[str, float]] = {}
            for host, table in costs.items():
                for sig, rec in table.items():
                    if not isinstance(rec, Mapping):
                        continue
                    mean = float(rec.get("mean_s") or 0.0)
                    if mean > 0 and int(rec.get("n") or 0) >= 2:
                        by_sig.setdefault(sig, {})[host] = mean
            # per-host worst offence: (signature, ratio over median)
            worst_sig: dict[str, tuple[str, float]] = {}
            for sig, means in by_sig.items():
                if len(means) < 2:
                    continue  # nobody to compare against
                med_sig = statistics.median(means.values())
                if med_sig <= 0:
                    continue
                sig_medians[sig] = round(med_sig, 6)
                for host, mean in means.items():
                    ratio_sig = mean / med_sig
                    if (ratio_sig > threshold
                            and ratio_sig > worst_sig.get(
                                host, ("", 0.0))[1]):
                        worst_sig[host] = (sig, ratio_sig)
            stragglers = sorted(worst_sig)
            straggler_signatures = {h: s for h, (s, _) in
                                    worst_sig.items()}
        # _stragglers is also mutated by the leave/evict path under
        # _lock from HTTP handler threads; an unlocked read-modify-write
        # here (sweeper thread) can race a concurrent discard
        with self._lock:
            new = set(stragglers) - self._stragglers
            self._stragglers = set(stragglers)
        ratio = len(stragglers) / world if world else 0.0
        fleet_goodput: dict = {}
        if goodputs:
            busy = sum(g["busy_s"] for g in goodputs.values())
            useful = sum(g["useful_s"] for g in goodputs.values())
            waste: dict[str, float] = {}
            for g in goodputs.values():
                for cause, v in g["waste_s"].items():
                    waste[cause] = waste.get(cause, 0.0) + float(v or 0)
            fleet_goodput = {
                "busy_s": round(busy, 6), "useful_s": round(useful, 6),
                "waste_s": {c: round(v, 6) for c, v in waste.items()},
                "dominant_waste": self._dominant_waste(waste)}
            if busy > 0:
                fleet_goodput["goodput_ratio"] = round(useful / busy, 6)
        straggler_causes = {
            h: self._dominant_waste(goodputs.get(h, {}).get("waste_s"))
            for h in stragglers}
        if self.metrics is not None:
            self.metrics.set_gauge("app_fleet_pass_skew",
                                   round(pass_skew, 4))
            self.metrics.set_gauge("app_fleet_occupancy_skew",
                                   round(occ_skew, 4))
            self.metrics.set_gauge("app_fleet_straggler_ratio",
                                   round(ratio, 4))
            if fleet_goodput.get("goodput_ratio") is not None:
                self.metrics.set_gauge("app_fleet_goodput_ratio",
                                       fleet_goodput["goodput_ratio"])
        for host in sorted(new):
            if self.logger:
                if straggler_mode == "signature":
                    sig = straggler_signatures.get(host)
                    self.logger.warn(
                        "straggler detected: pass cost skewed off the "
                        "fleet median for a shared dispatch signature",
                        host=host, signature=sig,
                        fleet_median_s=sig_medians.get(sig or ""),
                        threshold=threshold,
                        dominant_waste=straggler_causes.get(host))
                else:
                    self.logger.warn(
                        "straggler detected: pass duration skewed off "
                        "the fleet median", host=host,
                        p95_s=p95s.get(host), median_s=round(med, 6),
                        skew=round(pass_skew, 3), threshold=threshold,
                        # why is it slow? its own waste ledger answers
                        dominant_waste=straggler_causes.get(host))
            self.events.emit(
                "fleet.straggler", severity="warn", epoch=self.epoch,
                cause=straggler_causes.get(host) or "unknown",
                straggler=host, p95_s=p95s.get(host),
                signature=straggler_signatures.get(host),
                skew=round(pass_skew, 3))
        out = {"pass_skew": round(pass_skew, 4),
               "occupancy_skew": round(occ_skew, 4),
               "straggler_ratio": round(ratio, 4),
               "stragglers": stragglers,
               "straggler_causes": straggler_causes,
               "straggler_mode": straggler_mode,
               "straggler_signatures": straggler_signatures,
               "worst_host": worst,
               "goodput": fleet_goodput,
               "threshold": threshold}
        if costs:
            out["costs"] = {"signatures": sig_medians,
                            "hosts": sorted(costs)}
        return out

    # ------------------------------------------- integrity divergence
    def _vote_integrity(self) -> dict:
        """Majority-vote the golden-probe digests riding the heartbeat
        summaries (serving/integrity.py): per golden probe id reported
        by >= ``FleetConfig.integrity_quorum`` hosts, the strict-
        majority digest is taken as fleet truth and a minority host is
        the outlier — its own probe cannot catch corruption that also
        corrupted its sealed expectation, but the fleet can. Naming an
        outlier quarantines it (entry into ``_quarantined`` is the
        once-per-episode latch: one ``fleet.integrity_divergence``
        event + one incident bundle); a quarantined host rejoins after
        ``integrity_clean_probes`` consecutive NEW (probe-seq
        advanced) majority-agreeing observations. Leader-side digest
        comparison at heartbeat cadence — counts only, no clocks, no
        RNG, so a divergence drill reproduces under bisect."""
        quorum = max(2, int(self.fleet.integrity_quorum))
        clean_needed = max(1, int(self.fleet.integrity_clean_probes))
        with self._lock:
            reports: dict[str, dict] = {}
            for h, m in self._members.items():
                integ = m.summary.get("integrity")
                if not isinstance(integ, Mapping):
                    continue
                probes = integ.get("probe_digests")
                if not isinstance(probes, Mapping) or not probes:
                    continue
                reports[h] = {
                    "digests": {str(g): str(d)
                                for g, d in probes.items()},
                    "seq": int(integ.get("seq") or 0)}
        # ballot boxes: golden id -> {host: digest}
        by_golden: dict[str, dict[str, str]] = {}
        for host, rep in reports.items():
            for gid, digest in rep["digests"].items():
                by_golden.setdefault(gid, {})[host] = digest
        votes: dict[str, dict] = {}
        outliers: dict[str, str] = {}  # host -> golden id it lost on
        agree: dict[str, bool] = {}    # host agreed with every verdict
        for gid, ballots in sorted(by_golden.items()):
            if len(ballots) < quorum:
                continue  # not enough voters to break a tie
            tally: dict[str, int] = {}
            for digest in ballots.values():
                tally[digest] = tally.get(digest, 0) + 1
            winner = max(tally, key=lambda d: tally[d])
            if tally[winner] * 2 <= len(ballots):
                # no strict majority: the fleet itself disagrees —
                # record the split, never guess an outlier from a tie
                votes[gid] = {"majority": None, "tally": tally,
                              "voters": len(ballots)}
                continue
            votes[gid] = {"majority": winner, "tally": tally,
                          "voters": len(ballots)}
            for host, digest in ballots.items():
                if digest == winner:
                    agree.setdefault(host, True)
                else:
                    agree[host] = False
                    outliers.setdefault(host, gid)
        newly: list[tuple[str, dict]] = []
        rejoined: list[tuple[str, dict]] = []
        with self._lock:
            for host, gid in outliers.items():
                rec = self._quarantined.get(host)
                if rec is not None:
                    # still dirty: restart the clean streak
                    rec["clean"] = 0
                    rec["last_seq"] = reports[host]["seq"]
                    continue
                rec = {"golden_id": gid,
                       "digest": reports[host]["digests"][gid],
                       "majority": votes[gid]["majority"],
                       "voters": votes[gid]["voters"],
                       "generation": self.generation,
                       "last_seq": reports[host]["seq"],
                       "clean": 0}
                self._quarantined[host] = rec
                newly.append((host, dict(rec)))
            for host in list(self._quarantined):
                if host in outliers or host not in agree:
                    continue  # no fresh verdict on this host
                rep = reports.get(host)
                rec = self._quarantined[host]
                # same probes as last round are not new evidence —
                # the rejoin streak counts PROBES, not heartbeats
                if rep is None or rep["seq"] <= rec.get("last_seq", -1):
                    continue
                rec["last_seq"] = rep["seq"]
                rec["clean"] = rec.get("clean", 0) + 1
                if rec["clean"] >= clean_needed:
                    rejoined.append((host, self._quarantined.pop(host)))
            quarantined = {h: dict(r)
                           for h, r in self._quarantined.items()}
        for host, rec in newly:
            if self.metrics is not None:
                self.metrics.increment_counter("app_fleet_quarantines",
                                               action="quarantine")
            if self.logger:
                self.logger.warn(
                    "host quarantined: golden-probe digest diverged "
                    "from the fleet majority — routing stops until "
                    "its clean-probe streak clears it",
                    host=host, golden_id=rec["golden_id"],
                    digest=rec["digest"], majority=rec["majority"],
                    voters=rec["voters"])
            self.events.emit(
                "fleet.integrity_divergence", severity="error",
                epoch=self.epoch, cause="probe_digest_minority",
                outlier=host, golden_id=rec["golden_id"],
                digest=rec["digest"], majority=rec["majority"],
                voters=rec["voters"])
            self.events.emit(
                "fleet.quarantine", severity="warn",
                epoch=self.epoch, cause="integrity_divergence",
                quarantined=host, action="quarantine")
            self.incidents.trigger(
                "integrity_divergence", epoch=self.epoch,
                cause=f"host {host} diverged from the fleet majority "
                      f"on golden probe {rec['golden_id']}",
                attrs=dict(rec, host=host))
            for listener in list(self.quarantine_listeners):
                try:
                    listener(host, "quarantine")
                except Exception:
                    pass  # a broken listener must not block the vote
        for host, rec in rejoined:
            if self.metrics is not None:
                self.metrics.increment_counter("app_fleet_quarantines",
                                               action="rejoin")
            if self.logger:
                self.logger.info(
                    "quarantined host rejoined: consecutive clean "
                    "golden probes agreed with the fleet majority",
                    host=host, clean=rec["clean"],
                    golden_id=rec["golden_id"])
            self.events.emit(
                "fleet.quarantine", severity="info",
                epoch=self.epoch, cause="clean_probes",
                quarantined=host, action="rejoin",
                clean=rec["clean"])
            for listener in list(self.quarantine_listeners):
                try:
                    listener(host, "rejoin")
                except Exception:
                    pass
        if self.metrics is not None:
            self.metrics.set_gauge("app_fleet_quarantined_hosts",
                                   float(len(quarantined)))
        return {"quorum": quorum,
                "clean_probes": clean_needed,
                "reporting": sorted(reports),
                "votes": votes,
                "quarantined": quarantined}

    # ------------------------------------------------------ fleet views
    def fleet_status(self) -> dict:
        """The consolidated ``/debug/fleet`` JSON: per-host flight
        summaries + gossiped health, skew/straggler digest, counter
        totals merged across hosts."""
        with self._lock:
            ranks = self._ranks_locked()
            now = time.time()
            hosts = {
                h: {"rank": ranks[h], "address": m.address,
                    "status": "QUARANTINED" if h in self._quarantined
                    else m.health.get("status", "UP"),
                    "health": dict(m.health),
                    "last_seen_age_s": round(now - m.last_seen, 3),
                    "summary": dict(m.summary),
                    "federated": m.metrics_snapshot is not None}
                for h, m in self._members.items()}
            snaps = {h: m.metrics_snapshot
                     for h, m in self._members.items()
                     if m.metrics_snapshot is not None}
            generation, world = self.generation, len(self._members)
        totals: dict[str, float] = {}
        merged = merge_snapshots(snaps)
        for name, fam in merged["metrics"].items():
            if fam.get("kind") != "counter":
                continue
            totals[name] = round(sum(float(s.get("value", 0.0))
                                     for s in fam["series"]), 6)
        # the fleet answer to "who is burning my budget": per-tenant
        # token/device totals summed across every member's heartbeat
        # snapshot (counters with identical labelsets merge by sum)
        tenant_usage: dict[str, dict[str, float]] = {}
        for name in ("app_tenant_requests", "app_tenant_prompt_tokens",
                     "app_tenant_completion_tokens",
                     "app_tenant_device_seconds"):
            fam = merged["metrics"].get(name)
            if not fam:
                continue
            for s in fam.get("series", ()):
                tenant = (s.get("labels") or {}).get("tenant", "unknown")
                bucket = tenant_usage.setdefault(tenant, {})
                bucket[name] = round(bucket.get(name, 0.0)
                                     + float(s.get("value", 0.0)), 6)
        out = {"generation": generation, "world_size": world,
               "fleet": self._recompute_skew(), "hosts": hosts,
               "integrity": self._vote_integrity(),
               "counter_totals": totals,
               "tenant_usage": tenant_usage}
        for name, source in self.status_sources.items():
            try:
                out[name] = source()
            except Exception:
                out[name] = {"error": "status source failed"}
        return out

    def _ingest_own_events(self) -> None:
        """Fold the leader's own ledger into the merged timeline (its
        clock IS the reference clock, so the offset is ~0)."""
        self.merger.ingest(self.host_id or "leader",
                           self.events.digest())

    def _incident_timeline(self, since: float,
                           until: float) -> list[dict]:
        """IncidentDetector timeline source: the merged fleet view
        around the trigger, corrected timestamps filtering."""
        self._ingest_own_events()
        return self.merger.timeline(since=since, until=until)

    def fleet_events_jsonl(self, *, kind: str | None = None,
                           since: float | None = None,
                           n: int | None = None) -> str:
        """The ``GET /debug/fleet/events`` body: versioned JSONL,
        header line first, then the skew-corrected merged timeline."""
        self._ingest_own_events()
        return self.merger.to_jsonl(kind=kind, since=since, n=n)

    def fleet_metrics_text(self) -> str:
        """The federated Prometheus exposition for
        ``GET /control/fleet/metrics``: every member's snapshot with
        ``host`` / ``rank`` labels, then the leader's own ``app_fleet_*``
        and ``app_router_*`` series once (the leader's server has no
        metrics port of its own; the JAX leader appends ``app_fleet_*``
        alone and serves the router's on its app's port). Members'
        families of those prefixes are left out, so a leader that also
        joins as a worker emits no family twice."""
        self._recompute_skew()  # gauges fresh at scrape time
        own = ("app_fleet_", "app_router_")
        with self._lock:
            ranks = self._ranks_locked()
            per_host = {}
            labels = {}
            for h, m in self._members.items():
                if m.metrics_snapshot is None:
                    continue
                metrics = {name: fam for name, fam in
                           (m.metrics_snapshot.get("metrics")
                            or {}).items()
                           if not name.startswith(own)}
                per_host[h] = {"metrics": metrics}
                labels[h] = {"host": h, "rank": str(ranks[h])}
        text = render_federated(per_host, labels)
        if self.metrics is not None:
            for prefix in own:
                text += self.metrics.render_prometheus(prefix=prefix)
        return text or "\n"

    # ---------------------------------------------------------- sweeper
    def _sweep_once(self) -> None:
        now = time.time()
        budget = self.heartbeat_interval_s * self.eviction_misses
        with self._lock:  # joins mutate _members concurrently
            # stalls older than any member's silence can credit no one
            oldest = min((m.last_seen for m in self._members.values()),
                         default=now)
            self.stalls = [s for s in self.stalls if s[0] > oldest]
            dead = [h for h, m in self._members.items()
                    if now - m.last_seen - sum(
                        late for woke, late in self.stalls
                        if woke > m.last_seen) > budget]
        for host_id in dead:
            self.evict(host_id, reason="heartbeat_timeout")

    def _note_stall(self, woke_at: float, late_s: float) -> None:
        """The sweeper woke ``late_s`` after it was due: the whole
        process (or host) paused, so a member's heartbeat may be waiting
        behind the pause, not missing."""
        if late_s > self.heartbeat_interval_s / 2:
            with self._lock:
                self.stalls.append((woke_at, late_s))
                self.stall_count += 1
                self.stall_max_s = max(self.stall_max_s, late_s)

    def start(self) -> None:
        self._running = True
        nap = self.heartbeat_interval_s / 2

        def run() -> None:
            while self._running:
                self._sweep_once()
                t0 = time.monotonic()
                time.sleep(nap)
                self._note_stall(time.time(), time.monotonic() - t0 - nap)

        self._sweeper = threading.Thread(target=run, daemon=True,
                                         name="control-plane-sweeper")
        self._sweeper.start()

    def stop(self) -> None:
        self._running = False

    def _trip_leader_faults(self, host_id: str) -> None:
        """Injected leader failure modes for the HA drills: an armed
        ``leader_down`` refuses every control RPC, ``leader_partition``
        refuses only the host named by its ``request=`` tag. Both look
        like a dead/unreachable leader to the worker (an untyped 503
        counts as a missed ack), never like a typed refusal."""
        if self.faults is NO_FAULTS:
            return
        if self.faults.trip("leader_down"):
            raise ErrorServiceUnavailable(
                "leader down (injected)",
                details={"code": "leader_down"})
        if self.faults.trip("leader_partition", request_id=host_id):
            raise ErrorServiceUnavailable(
                "leader partitioned from host (injected)",
                details={"code": "leader_partition"})

    # ------------------------------------------------------------ routes
    def install(self, server: Any) -> None:
        """Register the control routes on a port server (a
        ``ChatServer``: ``post`` / ``get``), adopt its metrics manager
        (registering the ``app_fleet_*`` families where absent), add the
        leader's health to the server's health route, start the sweeper
        and stop it when the server closes."""
        if self.metrics is None:
            self.metrics = server.metrics
            if self.metrics is not None:
                self._register_metrics(self.metrics)
        self._set_membership_gauges()  # the epoch visible from boot
        if self.host_id:
            # the leader's half of cross-host correlation: every leader
            # log record and span names the host it ran on
            set_fleet_context(host_id=self.host_id)

        def join(ctx):
            body = ctx.bind() or {}
            self._trip_leader_faults(str(body.get("host_id", "")))
            assignment = self.join(
                str(body.get("host_id", "")),
                str(body.get("address", "")),
                _body_int(body, "n_devices", 1),
                body.get("health"),
                epoch=_body_int(body, "epoch", -1),
                takeover=bool(body.get("takeover", False)))
            # the assignment's generation, not a re-read of
            # self.generation: a concurrent join may have bumped it
            return {"generation": assignment.generation,
                    "assignment": assignment.to_dict(),
                    "epoch": self.epoch}

        def heartbeat(ctx):
            body = ctx.bind() or {}
            self._trip_leader_faults(str(body.get("host_id", "")))
            assignment, changed = self.heartbeat(
                str(body.get("host_id", "")),
                _body_int(body, "generation", -1),
                body.get("health"),
                body.get("summary"),
                body.get("metrics") if self.fleet.federation else None,
                address=str(body.get("address", "")),
                epoch=_body_int(body, "epoch", -1),
                events=body.get("events"))
            epoch_out = self.epoch
            if self.faults is not NO_FAULTS \
                    and self.faults.trip("stale_epoch_replay"):
                # an injected replayed ack: the worker's fence must
                # reject it and re-discover
                epoch_out = max(0, epoch_out - 1)
            if assignment is None:  # evicted on this very heartbeat
                return {"ok": False, "evicted": True,
                        "generation": self.generation,
                        "epoch": epoch_out}
            return {"ok": True, "changed": changed,
                    "generation": assignment.generation,
                    "assignment": assignment.to_dict(),
                    "epoch": epoch_out}

        def leave(ctx):
            # graceful deregistration: the departing worker tells the
            # leader now instead of making survivors wait out its silence
            body = ctx.bind() or {}
            host_id = str(body.get("host_id", ""))
            if not host_id:
                raise ErrorInvalidParam("host_id")
            self._trip_leader_faults(host_id)
            self._fence(_body_int(body, "epoch", -1))
            self.evict(host_id, reason="leave")
            return {"ok": True, "generation": self.generation,
                    "epoch": self.epoch}

        def leader_info(ctx):
            # discovery, safe on any candidate, active or standby. An
            # injected leader_down refuses probes too: a down leader must
            # look dead to the walk (a partition stays asymmetric:
            # probes carry no host_id)
            if self.faults is not NO_FAULTS \
                    and self.faults.trip("leader_down"):
                raise ErrorServiceUnavailable(
                    "leader down (injected)",
                    details={"code": "leader_down"})
            info = self.leadership()
            info["heartbeat_interval_s"] = self.heartbeat_interval_s
            return info

        def topology(ctx):
            return self.topology()

        def fleet_metrics(ctx):
            return File(content=self.fleet_metrics_text().encode(),
                        content_type="text/plain; version=0.0.4; "
                                     "charset=utf-8")

        def debug_fleet(ctx):
            return self.fleet_status()

        def debug_fleet_events(ctx):
            # the query contract of GET /debug/events, over the merged
            # skew-corrected fleet timeline
            kind = ctx.param("kind") or None
            raw_since = ctx.param("since")
            since = None
            if raw_since not in (None, ""):
                try:
                    since = float(raw_since)
                except (TypeError, ValueError):
                    raise ErrorInvalidParam("since")
            n = _body_int({"n": ctx.param("n") or 0}, "n", 0)
            n = max(0, min(1 << 20, n)) or None
            body = self.fleet_events_jsonl(kind=kind, since=since, n=n)
            return File(content=body.encode(),
                        content_type="application/jsonl; charset=utf-8")

        def debug_fleet_incidents(ctx):
            # the leader's incident spool; ?id= fetches one whole bundle
            incident_id = ctx.param("id") or None
            if incident_id is None:
                return {"incidents": self.incidents.list(),
                        "detector": self.incidents.state()}
            bundle = self.incidents.get(incident_id)
            if bundle is None:
                raise ErrorEntityNotFound("incident", incident_id)
            return bundle

        for path, fn in (("/control/join", join),
                         ("/control/heartbeat", heartbeat),
                         ("/control/leave", leave)):
            server.post(path, fn)
        for path, fn in (("/control/leader", leader_info),
                         ("/control/topology", topology),
                         ("/control/fleet/metrics", fleet_metrics),
                         ("/debug/fleet", debug_fleet),
                         ("/debug/fleet/events", debug_fleet_events),
                         ("/debug/fleet/incidents", debug_fleet_incidents)):
            server.get(path, fn)
        server.health_checks["control_plane"] = self
        self.start()
        server.on_close.append(self.stop)


def _body_int(body: Mapping[str, Any], key: str, default: int) -> int:
    """Optional integer field of a control-plane body: absent takes
    the default, garbage draws a typed 400 naming the field instead
    of surfacing as an internal error."""
    value = body.get(key, default)
    try:
        return int(value)
    except (TypeError, ValueError):
        raise ErrorInvalidParam(key)


def _typed_reject(response) -> tuple[str, dict]:
    """Pull the typed error code + details out of a control-plane
    reject (the ``{"error": {"message", "details"}}`` envelope).
    Unparseable bodies degrade to ``("", {})`` — the caller falls back
    on status-code semantics."""
    try:
        doc = response.json() or {}
        details = ((doc.get("error") or {}).get("details") or {})
        return str(details.get("code") or ""), details
    except (ValueError, AttributeError, TypeError):
        return "", {}


class WorkerAgent:
    """A serving host's side of the protocol: join once, heartbeat on a
    thread, and invoke ``on_assignment`` every time the generation
    changes — the hook where the host tears down and relaunches its
    SPMD program with the new rank/world (elastic restart).

    With a multi-candidate ``FleetConfig.leader_candidates`` the agent
    also runs the HA failover protocol: count missed heartbeat acks,
    and after ``missed_acks_before_failover`` of them walk the ranked
    candidates (``GET /control/leader``), elect deterministically
    (:meth:`_choose_candidate` — counts/epochs only, no clocks, no
    RNG), re-dial, and takeover-join so the winner rebuilds its state
    from this worker's very next heartbeat."""

    def __init__(self, leader_url: str, *, host_id: str,
                 address: str | Callable[[], str] = "",
                 n_devices: int = 1,
                 heartbeat_interval_s: float = 2.0,
                 on_assignment: Callable[[ShardAssignment], None]
                 | None = None,
                 health_source: Callable[[], dict] | None = None,
                 summary_source: Callable[[], dict] | None = None,
                 metrics_source: Callable[[], dict | None] | None = None,
                 fleet: FleetConfig | None = None,
                 join_backoff_max_s: float = 30.0,
                 tracer: Any = None,
                 logger: Any = None, service: Any = None,
                 faults: Any = None,
                 metrics: Any = None,
                 events: Any = None) -> None:
        self.host_id = host_id
        self.leader_url = leader_url
        #: dial address advertised to the leader; a callable is
        #: re-resolved on every join / heartbeat: how a worker on an
        #: ephemeral port advertises the endpoint its server bound
        #: (``app.join_fleet`` wires this by default)
        self.address = address
        self.n_devices = n_devices
        self.heartbeat_interval_s = heartbeat_interval_s
        #: join-retry backoff ceiling (exponential from the heartbeat
        #: interval, full jitter — see start()'s run loop)
        self.join_backoff_max_s = join_backoff_max_s
        #: deterministic fault plan (serving/faults.py) for the
        #: control-plane sites heartbeat_drop / join_refused; None
        #: reads GOFR_FAULTS, unset -> the NO_FAULTS singleton
        self.faults = resolve_plan(faults)
        self.on_assignment = on_assignment
        self.health_source = health_source or (lambda: {"status": "UP"})
        #: flight-recorder digest attached to every heartbeat (None =
        #: no summary); wire with engine_fleet_sources(engine)
        self.summary_source = summary_source
        #: this host's EventLedger (the engine's, via app.join_fleet):
        #: worker-side failover/fence decisions are recorded on it and
        #: its digest piggybacks on every heartbeat so the leader can
        #: merge the fleet timeline
        self.events = events if events is not None else NO_EVENTS
        #: Manager.snapshot() attached when FleetConfig.federation
        self.metrics_source = metrics_source
        self.fleet = fleet if fleet is not None else FleetConfig()
        self.tracer = tracer
        self.logger = logger
        self._service_injected = service is not None
        self._service = service if service is not None else \
            new_http_service(leader_url, Retry(max_retries=2),
                             CircuitBreaker(threshold=5, interval_s=2.0),
                             tracer=tracer)
        #: worker-side metrics manager (app.join_fleet wires the
        #: server's): app_fleet_failovers rides it
        self.metrics = metrics
        if metrics is not None:
            ControlPlaneLeader._register_metrics(metrics)
        #: ranked leader candidates for the HA discovery walk; a
        #: single-URL tuple (no failover machinery) when unset
        self.candidates: tuple = \
            tuple(self.fleet.leader_candidates) or (leader_url,)
        self.missed_acks_before_failover = max(
            1, int(self.fleet.missed_acks_before_failover))
        #: highest leader epoch this worker has observed; sent on
        #: every control message, and acks carrying a LOWER epoch are
        #: rejected (worker-side fencing of revived stale leaders)
        self.epoch = 0
        self._missed_acks = 0
        self._electing = False  # reentrancy guard on the walk
        #: failover rounds by reason (tests + debug surfaces)
        self.failovers: dict[str, int] = {}
        self.assignment: ShardAssignment | None = None
        self._running = False
        self._leaving = False  # deregistered: suppress auto-rejoin
        self._thread: threading.Thread | None = None
        #: set by stop(): the heartbeat thread's waits end at once
        self._wake = threading.Event()

    # ------------------------------------------------------------- wire
    def _post(self, path: str, body: dict) -> dict:
        # the control.* span makes the RPC the root of a cross-host
        # trace: the service client injects its traceparent, the
        # leader's server span continues it
        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(
                "control." + path.rstrip("/").rsplit("/", 1)[-1],
                attributes={"host_id": self.host_id})
        try:
            response = self._service.post(path, json=body)
        except Exception:
            if span is not None:
                span.set_status("ERROR: rpc failed")
            raise
        finally:
            if span is not None:
                span.end()
        if response.status >= 400:
            code, details = _typed_reject(response)
            if response.status == 409:
                if code == "stale_leader":
                    # the dialed leader is FENCED: it saw our higher
                    # epoch and demoted — re-discover, don't rejoin it
                    return {"stale_leader": True,
                            "leader_epoch": int(details.get("epoch", -1))}
                return {"rejoin": True}
            if code in ("not_leader", "leader_takeover"):
                return {"not_leader": True,
                        "leader_epoch": int(details.get("epoch", -1))}
            raise RuntimeError(
                f"control plane {path} -> {response.status}")
        data = response.json()
        return data.get("data", data)

    def _apply(self, payload: dict) -> None:
        raw = payload.get("assignment")
        if raw is None:
            return
        new = ShardAssignment(
            host_id=raw["host_id"], rank=int(raw["rank"]),
            world_size=int(raw["world_size"]),
            n_devices=int(raw["n_devices"]),
            generation=int(raw["generation"]),
            coordinator=raw.get("coordinator", ""))
        old = self.assignment
        self.assignment = new
        # the fleet context every span attribute set and log record
        # inherits from here on — set at join and on every re-rank
        set_fleet_context(host_id=self.host_id, rank=new.rank,
                          generation=new.generation)
        if (old is None or old.generation != new.generation) \
                and self.on_assignment is not None:
            self.on_assignment(new)

    def _healthy(self) -> bool:
        try:
            return self.health_source().get("status", "UP") == "UP"
        except Exception:
            return True  # a broken probe must not strand the agent

    def advertised_address(self) -> str:
        addr = self.address
        if callable(addr):
            try:
                addr = addr()
            except Exception:
                return ""
        return str(addr or "")

    def join(self, takeover: bool = False) -> ShardAssignment:
        if self.faults is not NO_FAULTS \
                and self.faults.trip("join_refused"):
            # injected leader refusal: exercises the join-retry backoff
            raise RuntimeError("control-plane join refused (injected)")
        body: dict[str, Any] = {
            "host_id": self.host_id,
            "address": self.advertised_address(),
            "n_devices": self.n_devices,
            "health": self.health_source(),
            "epoch": self.epoch}
        if takeover:
            body["takeover"] = True
        payload = self._post("/control/join", body)
        if payload.get("not_leader") or payload.get("stale_leader"):
            raise RuntimeError(
                "control-plane join refused: not the active leader")
        if not self._adopt_epoch(payload):
            raise RuntimeError(
                "control-plane join answered with a stale epoch")
        self._apply(payload)
        assert self.assignment is not None
        return self.assignment

    # ------------------------------------------------- leader discovery
    def _adopt_epoch(self, payload: dict) -> bool:
        """Worker-side epoch fencing: adopt the leader's epoch from an
        ack, or reject the ack when it carries a LOWER epoch than this
        worker has already seen — a revived stale leader, or an
        injected ``stale_epoch_replay``. Counts only, no clocks."""
        raw = payload.get("epoch")
        if raw is None:
            return True  # pre-HA leader: no epochs on the wire
        epoch = int(raw)
        if epoch < self.epoch:
            self.events.emit("fleet.fence_reject", severity="warn",
                             cause="stale_ack", epoch=self.epoch,
                             ack_epoch=epoch)
            return False
        if epoch > self.epoch:
            self.events.emit("fleet.epoch_bump", epoch=epoch,
                             cause="ack_adopted")
        self.epoch = epoch
        return True

    def _note_missed_ack(self) -> None:
        self._missed_acks += 1
        if self._missed_acks >= self.missed_acks_before_failover \
                and len(self.candidates) > 1:
            self._failover("missed_acks")

    def _failover(self, reason: str) -> bool:
        """One failover round: count it (``app_fleet_failovers``),
        then run the discovery walk. Reentrancy-guarded — the
        immediate post-join heartbeat inside the walk must not
        recurse into another round."""
        if self._electing:
            return False
        self._missed_acks = 0
        self.failovers[reason] = self.failovers.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_fleet_failovers",
                                           reason=reason)
        if self.logger:
            self.logger.warn("leader failover triggered", reason=reason,
                             host=self.host_id, epoch=self.epoch)
        self.events.emit("fleet.failover", severity="warn",
                         cause=reason, epoch=self.epoch)
        return self._locate_leader()

    def _probe_candidates(self) -> list[dict]:
        """``GET /control/leader`` on every candidate, in rank order.
        Unreachable candidates are simply absent from the result."""
        probes = []
        for rank, url in enumerate(self.candidates):
            info = probe_leader(
                url, timeout_s=max(1.0, self.heartbeat_interval_s))
            if info is None:
                continue
            probes.append({"rank": rank, "url": url,
                           "active": bool(info.get("active")),
                           "epoch": int(info.get("epoch", -1))})
        return probes

    @staticmethod
    def _choose_candidate(probes: list, known_epoch: int):
        """THE election decision — a pure function of the probe
        results and the worker's known epoch: it reads no clock and no
        RNG. Prefer the live
        active candidate with the highest epoch at or above what we
        know (ties break to the lowest rank; an active candidate
        BELOW the known epoch is a revived stale leader and is never
        adopted); with no acceptable active candidate, elect the
        lowest-ranked live one via a takeover join. Returns
        ``(url, takeover)`` or None when nothing is reachable."""
        active = [p for p in probes
                  if p["active"] and p["epoch"] >= known_epoch]
        if active:
            best = min(active, key=lambda p: (-p["epoch"], p["rank"]))
            return best["url"], False
        if probes:
            lowest = min(probes, key=lambda p: p["rank"])
            return lowest["url"], True
        return None

    def _redial(self, url: str) -> None:
        if self._service_injected:
            return  # tests inject a transport; keep it
        if url.rstrip("/") == self.leader_url.rstrip("/"):
            return
        self.leader_url = url
        self._service = new_http_service(
            url, Retry(max_retries=2),
            CircuitBreaker(threshold=5, interval_s=2.0),
            tracer=self.tracer)

    def _locate_leader(self) -> bool:
        """Discovery walk + (re)join: probe the ranked candidates,
        elect deterministically, re-dial and join, then heartbeat
        immediately so the winner rebuilds its membership/digest/
        routing state from this worker NOW instead of one interval
        later (the stateless-rebuild takeover). Reentrancy-guarded:
        the immediate post-join heartbeat must not recurse into
        another walk."""
        if self._electing:
            return False
        self._electing = True
        try:
            probes = self._probe_candidates()
            while probes:
                choice = self._choose_candidate(probes, self.epoch)
                assert choice is not None  # probes is non-empty
                url, takeover = choice
                self._redial(url)
                try:
                    self.join(takeover=takeover)
                except Exception as exc:
                    # refused (asymmetric partition, injected refusal,
                    # raced a shutdown): strike THIS candidate and
                    # re-elect among the rest — deterministic, the
                    # probe list only shrinks
                    if self.logger:
                        self.logger.warn(
                            f"failover join to {url} failed: {exc}")
                    probes = [p for p in probes if p["url"] != url]
                    continue
                if self.logger:
                    self.logger.info(
                        "failed over to new leader", url=url,
                        epoch=self.epoch, takeover=takeover,
                        host=self.host_id)
                self._heartbeat_once()
                return True
            return False
        finally:
            self._electing = False

    def heartbeat_sync(self) -> tuple[ShardAssignment | None, bool]:
        """One synchronous heartbeat; returns (assignment, changed).
        The polling hand-off point for hosts that gate their SPMD
        launch on the group reaching a target size."""
        before = (self.assignment.generation
                  if self.assignment is not None else -1)
        self._heartbeat_once()
        after = (self.assignment.generation
                 if self.assignment is not None else -1)
        return self.assignment, after != before

    def _heartbeat_once(self) -> None:
        if self._leaving:
            return  # departing: the leave walk owns the wire now
        if self.faults is not NO_FAULTS \
                and self.faults.trip("heartbeat_drop"):
            return  # injected lossy control network: skip this beat
        generation = (self.assignment.generation
                      if self.assignment is not None else -1)
        body: dict[str, Any] = {
            "host_id": self.host_id, "generation": generation,
            "health": self.health_source(), "epoch": self.epoch}
        addr = self.advertised_address()
        if addr:
            body["address"] = addr
        if self.summary_source is not None:
            try:
                body["summary"] = self.summary_source()
            except Exception:
                pass  # a broken digest must not kill the heartbeat
        if self.events.enabled:
            try:
                body["events"] = self.events.digest()
            except Exception:
                pass  # same contract as the summary digest
        if self.fleet.federation and self.metrics_source is not None:
            try:
                snap = self.metrics_source()
            except Exception:
                snap = None
            if snap is not None:
                body["metrics"] = snap
        try:
            payload = self._post("/control/heartbeat", body)
        except Exception as exc:
            # leader unreachable: the circuit breaker is already
            # backing off — keep the last assignment and keep serving,
            # but COUNT the miss: enough of them in a row triggers the
            # failover walk (multi-candidate fleets only)
            if self.logger:
                self.logger.warn(f"control-plane heartbeat failed: {exc}")
            self._note_missed_ack()
            return
        if self.faults is not NO_FAULTS \
                and self.faults.trip("ack_drop"):
            # injected one-way loss: the leader saw the beat, the
            # worker never hears the ack — counts as a miss here
            self._note_missed_ack()
            return
        if payload.get("stale_leader") or not self._adopt_epoch(payload):
            # the dialed leader is behind our epoch (revived stale
            # leader, or an injected stale_epoch_replay): typed
            # evidence of staleness — fail over immediately, no
            # missed-ack budget needed
            self._failover("stale_leader")
            return
        if payload.get("not_leader"):
            # a standby answered: it told us so with a typed 503 —
            # re-discover the active leader immediately
            self._failover("not_leader")
            return
        self._missed_acks = 0
        if payload.get("evicted"):
            # the leader acted on our DEGRADED gossip: drop the
            # assignment and do NOT auto-rejoin until health clears
            # (the run loop gates the rejoin on health_source) — a
            # wedged host thrashing join/evict helps nobody
            self.assignment = None
            if self.logger:
                self.logger.warn(
                    "evicted by leader on degraded health; will "
                    "rejoin when healthy", host=self.host_id)
            return
        if payload.get("rejoin") and not self._leaving:
            # never re-adopt a departing worker from a stale heartbeat
            # racing its own /control/leave
            try:
                self.join()
            except Exception as exc:
                if self.logger:
                    self.logger.warn(f"rejoin failed: {exc}")
            return
        self._apply(payload)

    def start(self) -> None:
        """Begin joining + heartbeating. A leader that is not up yet
        must not be fatal (rolling restarts bring workers up first):
        the thread keeps retrying the join with backoff until it
        lands, then heartbeats."""
        self._running = True
        self._leaving = False
        self._wake.clear()
        try:
            self.join()
        except Exception as exc:
            if self.logger:
                self.logger.warn(
                    f"control-plane join failed, will retry: {exc}")

        def run() -> None:
            # Unassigned (leader down, evicted, join refused): retries
            # back off exponentially from the heartbeat interval up to
            # join_backoff_max_s, with FULL jitter (x0.5-1.5) — a
            # restarting leader must not be met by every worker's join
            # landing on the same heartbeat tick (thundering herd). A
            # successful join — or simply being assigned — resets the
            # backoff; assigned heartbeats keep the fixed cadence.
            base = max(0.01, self.heartbeat_interval_s)
            backoff = base
            last_beat = time.monotonic()
            while self._running:
                if self.assignment is not None:
                    # one interval after the last beat BEGAN: a slow
                    # beat must not add its length to the silence
                    delay = max(0.0, last_beat + base - time.monotonic())
                else:
                    delay = backoff * (0.5 + random.random())
                self._wake.wait(delay)
                if not self._running:
                    return
                if self.assignment is None:
                    if self._leaving:
                        continue  # deregistered: awaiting stop()
                    if not self._healthy():
                        continue  # evicted-degraded: heal first
                    try:
                        if len(self.candidates) > 1:
                            # HA fleet: discovery walk instead of a
                            # blind re-dial of a possibly-dead leader
                            if not self._locate_leader():
                                raise RuntimeError(
                                    "no live leader candidate")
                        else:
                            self.join()
                        backoff = base
                    except Exception as exc:
                        backoff = min(backoff * 2.0,
                                      self.join_backoff_max_s)
                        if self.logger:
                            self.logger.warn(
                                f"join retry failed: {exc}; next "
                                f"attempt in <= {backoff * 1.5:.1f}s")
                else:
                    backoff = base
                    last_beat = time.monotonic()
                    self._heartbeat_once()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"worker-{self.host_id}")
        self._thread.start()

    def deregister(self, rounds: int | None = None) -> bool:
        """Graceful leave (the SIGTERM drain path): tell the leader
        this host is going away NOW — survivors re-rank immediately
        instead of waiting out heartbeat silence. Best-effort: a dead
        leader must never block shutdown. Clears the assignment so the
        heartbeat thread does not immediately rejoin.

        In a multi-candidate fleet the leave survives a takeover
        window: when the dialed leader is down or answers with a
        typed ``not_leader``/``stale_leader`` reject, the agent
        re-probes the candidates and retries against whoever is
        active NOW — but never takeover-joins (a departing worker
        must not elect a leader on its way out). Returns True when a
        leader acknowledged the leave."""
        self._leaving = True
        self.assignment = None
        body = {"host_id": self.host_id, "epoch": self.epoch}
        if rounds is None:
            rounds = max(1, self.missed_acks_before_failover)
        for attempt in range(rounds):
            try:
                payload = self._post("/control/leave", body)
            except Exception as exc:
                payload = {"error": str(exc)}
            if not (payload.get("not_leader") or payload.get("stale_leader")
                    or payload.get("error")):
                self._adopt_epoch(payload)
                if self.logger:
                    self.logger.info("deregistered from serving group",
                                     host=self.host_id)
                return True
            if attempt + 1 >= rounds:
                break
            # a takeover may be mid-flight: give the election one
            # heartbeat interval, then re-discover the front door
            time.sleep(self.heartbeat_interval_s)
            if len(self.candidates) > 1:
                choice = self._choose_candidate(
                    self._probe_candidates(), self.epoch)
                if choice is not None and not choice[1]:
                    self._redial(choice[0])
        if self.logger:
            self.logger.warn("control-plane leave failed",
                             host=self.host_id)
        return False

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(self.heartbeat_interval_s * 2 + 1)
            self._thread = None
