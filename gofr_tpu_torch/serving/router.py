"""Fleet front door: the prefix-cache-aware data-plane router on the
leader (the port's copy of ``gofr_tpu/serving/router.py``).

``app.serve_fleet_leader(router=RouterConfig())`` proxies ``POST /chat``
and the OpenAI routes to the member whose prefix cache already holds the
request's longest pinned prefix: a prefix hit walks only the suffix
through the paged chunk kernel, so the router's job is to keep that
reuse from washing out across hosts.

How the signal flows (no new protocol):

- each worker's engine publishes a **prefix-cache digest**: truncated
  :func:`prefix_hash` values of its resident prefix keys, at most
  ``EngineConfig.prefix_digest_hashes``, rebuilt at the throttled gauge
  pass and carried by heartbeats in ``FlightRecorder.fleet_summary()``;
- the leader (:class:`~.control_plane.ControlPlaneLeader`) keeps each
  member's latest summary; :meth:`FleetRouter.plan` scores the members by
  **longest page-aligned prefix match** against their digests, load
  breaking ties (queue depth x seconds per token, from the same
  summaries);
- **session affinity** (a bounded LRU of session -> host, keyed on the
  body's ``session`` or ``X-Session-Id``) keeps a multi-turn chat on the
  host that holds its KV, and is dropped the moment the host leaves
  (the leader's evict and quarantine listeners);
- typed retryable rejects (``draining`` / ``engine_restart`` /
  ``engine_down`` 503s, and any 503 with ``Retry-After``) fail over to
  the next-best host **before** any byte was forwarded, so greedy
  answers stay bit-identical and no stream repeats a token; a 429 and
  an untyped 503 are mirrored as they are;
- a host the leader's integrity vote **quarantined** reports QUARANTINED
  in the routing view and drops out of the plan like a DOWN host;
- answers stream through unbuffered: each upstream chunk is forwarded
  as it arrives. While the upstream is quiet the proxy wakes every
  ``POLL_S`` so the server checks the client; a client that leaves
  closes the proxied stream, which closes the upstream connection, and
  the worker cancels the request (``app_router_client_aborts``).

On the same heartbeat signals an **autoscale hook** (:class:`Autoscaler`)
turns sustained queue pressure above the per-host setpoint into
scale-up decisions and sustained idle occupancy into scale-down ones
(``autoscale_act`` evicts the idlest member through the leader).

The port serves from threads (``app.ChatServer``), so the proxy is
synchronous: one upstream socket per request on the request's own
thread, with a small HTTP/1.1 reader (:class:`_Upstream`) that can wait
in short polls.
"""

from __future__ import annotations

import hashlib
import json
import select
import socket
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable

from .events import NO_EVENTS
from .responses import ErrorServiceUnavailable, Reply, Stream

#: response headers mirrored back to the client on proxied answers
_MIRROR_HEADERS = ("retry-after",)
#: request headers forwarded upstream (auth, tracing, content negotiation)
_FORWARD_HEADERS = ("content-type", "accept", "authorization",
                    "x-api-key", "traceparent", "x-session-id")
#: seconds the proxy waits on a quiet upstream before it lets the server
#: check that its client is still connected
POLL_S = 0.05
#: the most bytes a response head may take
MAX_HEADER_BYTES = 65536


def prefix_hash(tokens) -> str:
    """Stable, truncated content hash of a token-id sequence: the wire
    format of one prefix-cache digest entry. Workers hash their resident
    prefix keys, the router the request's page-aligned prompt prefixes;
    equal sequences give equal hashes (16 hex digits of blake2b)."""
    raw = ",".join(str(int(t)) for t in tokens).encode()
    return hashlib.blake2b(raw, digest_size=8).hexdigest()


def aligned_prefix_hashes(prompt_tokens, page_size: int,
                          max_pages: int) -> list[tuple[int, str]]:
    """``[(covered_rows, hash), ...]`` for every page-aligned prefix of
    ``prompt_tokens`` an engine could have pinned, longest first. As the
    engine's ``_probe_prefix``: at least one token must remain, so the
    longest prefix is page-aligned below ``len(prompt) - 1``."""
    pg = max(1, int(page_size))
    limit = len(prompt_tokens) - 1
    out: list[tuple[int, str]] = []
    pages = min(limit // pg, max(0, int(max_pages)))
    for k in range(pages, 0, -1):
        covered = k * pg
        out.append((covered, prefix_hash(prompt_tokens[:covered])))
    return out


@dataclass
class RouterConfig:
    """Knobs for the fleet front door."""

    #: "prefix" scores hosts by longest digest match with a load
    #: tie-break; "round_robin" rotates (the baseline that shows what
    #: prefix routing is worth)
    policy: str = "prefix"
    #: bounded session -> host LRU; 0 disables affinity
    affinity_size: int = 1024
    #: failover attempts on ANOTHER host after the first pick refuses with
    #: a typed retryable reject or a connect error
    max_retries: int = 2
    #: ``details.code`` values that mean "not this host, not now": safe to
    #: replay on a sibling, the engine refused before admitting
    retryable_codes: tuple = ("draining", "engine_restart", "engine_down")
    #: upstream TCP connect budget
    connect_timeout_s: float = 5.0
    #: per-read upstream budget (the response head, each body chunk)
    read_timeout_s: float = 120.0
    #: page-aligned prefix lengths probed against each host's digest
    digest_max_pages: int = 64
    #: enable the autoscale hook (decisions ride /debug/fleet and the
    #: app_router_scale_decisions counter)
    autoscale: bool = False
    #: per-host concurrency setpoint (active + waiting) above which
    #: sustained pressure is a scale-up signal; 0 = from ``setpoint_file``
    setpoint_concurrency: int = 0
    #: a JSON file with ``max_concurrency``, read once at install
    setpoint_file: str = ""
    #: fleet mean occupancy below this is an idle (scale-down) signal
    idle_occupancy: float = 0.10
    #: how long a pressure / idle signal must hold before a decision
    sustain_s: float = 30.0
    #: minimum spacing between decisions
    cooldown_s: float = 60.0
    #: scale-down decisions evict the idlest member through the leader;
    #: False = advisory only
    autoscale_act: bool = False
    #: decision ring kept for /debug/fleet
    decisions_kept: int = 32


#: the router's series on the leader's manager
_ROUTER_GAUGES = (
    ("app_router_routed_share",
     "per-host fraction of requests this router forwarded"),
    ("app_router_cache_hit_ratio",
     "fraction of routed requests sent to a host whose prefix digest "
     "covered part of the prompt"),
)
_ROUTER_COUNTERS = (
    ("app_router_routed",
     "requests forwarded to a member (by host label)"),
    ("app_router_retries",
     "typed-reject / connect-error failovers to the next-best host "
     "(by code label)"),
    ("app_router_affinity_hits",
     "requests routed by session affinity"),
    ("app_router_scale_decisions",
     "autoscale decisions emitted (by action label)"),
    ("app_router_client_aborts",
     "proxied streams cancelled because the downstream client "
     "disconnected mid-stream (upstream slot released early)"),
)


class SessionAffinity:
    """Bounded session -> host LRU, touched from request threads and
    from the leader's listeners, so every access holds the lock."""

    def __init__(self, size: int) -> None:
        self.size = max(0, int(size))
        self._map: OrderedDict[str, str] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, session: str) -> str | None:
        if not self.size or not session:
            return None
        with self._lock:
            host = self._map.get(session)
            if host is not None:
                self._map.move_to_end(session)
            return host

    def put(self, session: str, host: str) -> None:
        if not self.size or not session:
            return
        with self._lock:
            self._map[session] = host
            self._map.move_to_end(session)
            while len(self._map) > self.size:
                self._map.popitem(last=False)

    def drop_host(self, host: str) -> int:
        with self._lock:
            dead = [s for s, h in self._map.items() if h == host]
            for s in dead:
                del self._map[s]
            return len(dead)

    def state(self) -> dict:
        with self._lock:
            return {"size": self.size, "entries": len(self._map)}


class Autoscaler:
    """Sustained-signal scale decisions over the member views the router
    reads. Host arithmetic on an injectable clock; decisions land in a
    ring, a counter, the leader's event ledger, and optionally the
    leader's evict path."""

    def __init__(self, config: RouterConfig, *,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Any = None, logger: Any = None,
                 on_decision: Callable[[dict], None] | None = None) -> None:
        self.config = config
        self.clock = clock
        self.metrics = metrics
        self.logger = logger
        self.on_decision = on_decision
        self.setpoint = int(config.setpoint_concurrency)
        #: the ledger decisions land on (the router wires the leader's)
        self.events = NO_EVENTS
        self.decisions: deque = deque(maxlen=max(1, config.decisions_kept))
        self._pressure_since: float | None = None
        self._idle_since: float | None = None
        self._last_decision = -float("inf")

    def load_setpoint_file(self, path: str) -> None:
        """Read ``max_concurrency`` from a JSON file (install time only);
        an unreadable file keeps the old setpoint."""
        if not path:
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            self.setpoint = int(doc.get("max_concurrency") or 0)
        except (OSError, ValueError) as exc:
            if self.logger:
                self.logger.warn(
                    f"autoscaler setpoint file unreadable: {exc}")

    def observe(self, hosts: list[dict]) -> dict | None:
        """One tick over the member views; the decision when one fires
        (also recorded), else None."""
        now = self.clock()
        world = len(hosts)
        if not world:
            self._pressure_since = self._idle_since = None
            return None
        loads = []
        occs = []
        for h in hosts:
            s = h.get("summary") or {}
            loads.append(float(s.get("active_slots") or 0)
                         + float(s.get("waiting") or 0))
            if isinstance(s.get("occupancy_mean"), (int, float)):
                occs.append(float(s["occupancy_mean"]))
        mean_load = sum(loads) / world
        mean_occ = (sum(occs) / len(occs)) if occs else None
        pressure = self.setpoint > 0 and mean_load > self.setpoint
        idle = (mean_occ is not None and world > 1
                and mean_occ < self.config.idle_occupancy
                and not pressure)
        self._pressure_since = (self._pressure_since or now) \
            if pressure else None
        self._idle_since = (self._idle_since or now) if idle else None
        if now - self._last_decision < self.config.cooldown_s:
            return None
        sustain = self.config.sustain_s
        if self._pressure_since is not None \
                and now - self._pressure_since >= sustain:
            return self._decide(
                "scale_up", now,
                reason=f"mean in-flight {mean_load:.1f} > setpoint "
                       f"{self.setpoint} for {sustain:.0f}s",
                mean_load=round(mean_load, 2), world=world)
        if self._idle_since is not None \
                and now - self._idle_since >= sustain:
            victim = min(
                hosts, key=lambda h: (
                    float((h.get("summary") or {}).get("active_slots")
                          or 0)
                    + float((h.get("summary") or {}).get("waiting")
                            or 0),
                    h.get("host_id", "")))
            return self._decide(
                "scale_down", now,
                reason=f"mean occupancy {mean_occ:.3f} < "
                       f"{self.config.idle_occupancy} for {sustain:.0f}s",
                victim=victim.get("host_id"), world=world)
        return None

    def _decide(self, action: str, now: float, **extra: Any) -> dict:
        self._last_decision = now
        self._pressure_since = self._idle_since = None
        decision = {"action": action, "at": round(now, 3),
                    "setpoint": self.setpoint, **extra}
        self.decisions.append(decision)
        if self.metrics is not None:
            self.metrics.increment_counter("app_router_scale_decisions",
                                           action=action)
        self.events.emit(
            "router.scale", severity="warn", cause=action,
            **{k: v for k, v in decision.items()
               if k not in ("action", "at")})
        if self.logger:
            self.logger.warn("autoscale decision", **decision)
        if self.on_decision is not None:
            try:
                self.on_decision(decision)
            except Exception:
                pass  # a broken hook must not break routing
        return decision

    def state(self) -> dict:
        return {"setpoint": self.setpoint,
                "decisions": list(self.decisions)}


class FleetRouter:
    """The leader's data plane: plan (score members against the
    request), proxy (stream through, fail over on typed rejects),
    account (``app_router_*``), and optionally autoscale."""

    def __init__(self, leader: Any, config: RouterConfig | None = None,
                 *, tokenizer: Any = None, metrics: Any = None,
                 logger: Any = None, tracer: Any = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if tokenizer is None:
            from .tokenizer import ByteTokenizer
            tokenizer = ByteTokenizer()
        self.leader = leader
        self.config = config if config is not None else RouterConfig()
        self.tokenizer = tokenizer
        self.metrics = metrics
        self.logger = logger
        self.tracer = tracer
        # router events land on the leader's ledger, so they interleave
        # with evictions and failovers in one timeline
        events = getattr(leader, "events", None)
        self.events = events if events is not None else NO_EVENTS
        self.clock = clock
        self.affinity = SessionAffinity(self.config.affinity_size)
        self.autoscaler: Autoscaler | None = None
        if self.config.autoscale:
            self.autoscaler = Autoscaler(
                self.config, clock=clock, metrics=metrics, logger=logger,
                on_decision=self._act_on_decision
                if self.config.autoscale_act else None)
            self.autoscaler.events = self.events
        #: routed accounting, all under _lock
        self._lock = threading.Lock()
        self._routed: dict[str, int] = {}
        self._routed_total = 0
        self._routed_cache_hits = 0
        self._affinity_hits = 0
        self._retries = 0
        self._client_aborts = 0
        self._rr_next = 0
        self._autoscale_tick = -float("inf")
        #: integrity-quarantine transitions observed (debug_state)
        self._quarantines: dict[str, int] = {}
        if hasattr(leader, "add_evict_listener"):
            leader.add_evict_listener(self._on_member_gone)
        if hasattr(leader, "add_quarantine_listener"):
            leader.add_quarantine_listener(self._on_quarantine)

    # ------------------------------------------------------- membership
    def _on_member_gone(self, host_id: str, reason: str) -> None:
        dropped = self.affinity.drop_host(host_id)
        if not dropped:
            return
        self.events.emit("router.affinity_drop", severity="warn",
                         cause=reason, host=host_id, sessions=dropped)
        if self.logger:
            self.logger.info(
                "router dropped session affinity for departed host",
                host=host_id, reason=reason, sessions=dropped)

    def _on_quarantine(self, host_id: str, action: str) -> None:
        """Quarantine listener: sweep session affinity off a quarantined
        host at once and count both transitions; routing itself needs
        nothing, QUARANTINED already drops the host from the plan."""
        with self._lock:
            self._quarantines[action] = \
                self._quarantines.get(action, 0) + 1
        if action == "quarantine":
            self._on_member_gone(host_id, "quarantined")

    def _members(self) -> list[dict]:
        view = self.leader.routing_view()
        return [m for m in view if m.get("status", "UP") == "UP"
                and m.get("address")]

    # ---------------------------------------------------------- scoring
    @staticmethod
    def _load(summary: dict) -> float:
        """Queue depth x fitted seconds per token: in-flight work scaled
        by how fast this host retires it. ``pass_p50_s`` first, then
        1 / tokens_per_s, then raw depth (a cold host)."""
        depth = (float(summary.get("active_slots") or 0)
                 + float(summary.get("waiting") or 0))
        spt = summary.get("pass_p50_s")
        if not isinstance(spt, (int, float)) or spt <= 0:
            tps = summary.get("tokens_per_s")
            spt = 1.0 / float(tps) if isinstance(tps, (int, float)) \
                and tps > 0 else 1.0
        return depth * float(spt)

    def _covered(self, member: dict, prompt_tokens) -> int:
        digest = (member.get("summary") or {}).get("prefix_digest")
        if not isinstance(digest, dict):
            return 0
        hashes = digest.get("hashes")
        if not hashes:
            return 0
        resident = set(hashes)
        for covered, h in aligned_prefix_hashes(
                prompt_tokens, digest.get("page") or 1,
                self.config.digest_max_pages):
            if h in resident:
                return covered
        return 0

    def plan(self, prompt_tokens, session: str | None = None
             ) -> list[dict]:
        """Ordered candidates for one request, each ``{host_id, address,
        covered, load, affinity}``: the first is the route, the rest the
        failover ladder."""
        members = self._members()
        self._maybe_autoscale(members)
        if not members:
            return []
        if self.config.policy == "round_robin":
            members.sort(key=lambda m: m["host_id"])
            with self._lock:
                start = self._rr_next % len(members)
                self._rr_next += 1
            ordered = members[start:] + members[:start]
            return [{"host_id": m["host_id"], "address": m["address"],
                     "covered": 0, "load": 0.0, "affinity": False}
                    for m in ordered]
        scored = []
        for m in members:
            summary = m.get("summary") or {}
            scored.append({
                "host_id": m["host_id"], "address": m["address"],
                "covered": self._covered(m, prompt_tokens),
                "load": round(self._load(summary), 6),
                "affinity": False,
            })
        scored.sort(key=lambda c: (-c["covered"], c["load"],
                                   c["host_id"]))
        pinned = self.affinity.get(session) if session else None
        if pinned is not None:
            for i, c in enumerate(scored):
                if c["host_id"] == pinned:
                    c["affinity"] = True
                    scored.insert(0, scored.pop(i))
                    break
        return scored

    def _maybe_autoscale(self, members: list[dict]) -> None:
        if self.autoscaler is None:
            return
        now = self.clock()
        with self._lock:
            if now - self._autoscale_tick < 1.0:
                return
            self._autoscale_tick = now
        self.autoscaler.observe(members)

    def _act_on_decision(self, decision: dict) -> None:
        """``autoscale_act``: scale-down evicts through the leader (the
        evicted agent backs off and may rejoin); scale-up stays advisory:
        the leader cannot make hosts."""
        if decision.get("action") != "scale_down":
            return
        victim = decision.get("victim")
        if victim and hasattr(self.leader, "evict"):
            self.leader.evict(victim, reason="scale_down")

    # ------------------------------------------------------- accounting
    def _note_routed(self, cand: dict, session: str | None,
                     retried: int) -> None:
        with self._lock:
            host = cand["host_id"]
            self._routed[host] = self._routed.get(host, 0) + 1
            self._routed_total += 1
            if cand["covered"] > 0:
                self._routed_cache_hits += 1
            if cand["affinity"]:
                self._affinity_hits += 1
            self._retries += retried
            total = self._routed_total
            shares = {h: n / total for h, n in self._routed.items()}
            ratio = self._routed_cache_hits / total
        if session:
            self.affinity.put(session, host)
        m = self.metrics
        if m is None:
            return
        m.increment_counter("app_router_routed", host=host)
        if cand["affinity"]:
            m.increment_counter("app_router_affinity_hits")
        for h, share in shares.items():
            m.set_gauge("app_router_routed_share", round(share, 4),
                        host=h)
        m.set_gauge("app_router_cache_hit_ratio", round(ratio, 4))

    def _note_retry(self, code: str) -> None:
        if self.metrics is not None:
            self.metrics.increment_counter("app_router_retries",
                                           code=code)

    # ------------------------------------------------------------ proxy
    @staticmethod
    def routing_text(path: str, body: dict) -> str:
        """The prompt text a worker will tokenize for this request: the
        router must hash the bytes the engine caches. As the chat
        handler for ``/chat`` and the OpenAI chat template for ``/v1/*``;
        a malformed body routes by load alone and the worker answers its
        typed 4xx."""
        if path.startswith("/v1/chat"):
            messages = body.get("messages")
            if not isinstance(messages, list):
                return ""
            parts = []
            for m in messages:
                if not isinstance(m, dict):
                    return ""
                content = m.get("content")
                if isinstance(content, list):
                    content = "".join(
                        str(p.get("text", "")) for p in content
                        if isinstance(p, dict))
                parts.append(f"{m.get('role', 'user')}: {content}")
            parts.append("assistant:")
            return "\n".join(parts)
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            return prompt
        if isinstance(body.get("messages"), list):
            return "\n".join(str(m.get("content", ""))
                             for m in body["messages"]
                             if isinstance(m, dict))
        return ""

    def make_proxy(self, path: str):
        """A proxy handler bound to one upstream path."""

        def proxy(ctx):
            return self.proxy_request(ctx, path)

        proxy.__name__ = f"route_{path.strip('/').replace('/', '_')}"
        return proxy

    def _leadership_gate(self) -> None:
        """The HA fence on the data plane: a standby leader does not
        route (a typed ``not_leader`` 503 naming the candidates), and a
        fresh takeover answers typed retryable ``leader_takeover`` 503s
        until the first heartbeat round rebuilds the routing view."""
        lead = getattr(self.leader, "leadership", None)
        if lead is None:
            return  # a leader without HA state: nothing to gate
        state = lead()
        if not state.get("active", True):
            raise ErrorServiceUnavailable(
                "this leader is a standby; re-resolve the active "
                "leader via GET /control/leader",
                details={"code": "not_leader",
                         "epoch": state.get("epoch", 0),
                         "candidates": state.get("candidates", [])},
                headers={"Retry-After": "1"})
        if state.get("converging"):
            interval = getattr(getattr(self.leader, "fleet", None),
                               "heartbeat_interval_s", 1.0)
            raise ErrorServiceUnavailable(
                "leader takeover in progress; routing state rebuilds "
                "from the next heartbeat round",
                details={"code": "leader_takeover",
                         "epoch": state.get("epoch", 0)},
                headers={"Retry-After":
                         str(max(1, round(float(interval))))})

    def _abort_watch(self, upstream):
        """Client-abort propagation: when the client leaves mid-stream the
        server closes this generator; closing ``upstream`` with it tears
        the worker connection down, which cancels the worker's request,
        instead of draining tokens nobody reads."""
        try:
            yield from upstream
        except GeneratorExit:
            with self._lock:
                self._client_aborts += 1
            if self.metrics is not None:
                self.metrics.increment_counter("app_router_client_aborts")
            if self.logger:
                self.logger.info(
                    "client disconnected mid-stream; cancelled upstream")
            raise

    def proxy_request(self, ctx, path: str):
        # the router's part of the trace: router.route joins the server
        # span (or the client's traceparent) and is injected downstream,
        # so the worker's spans hang off it
        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(
                "router.route",
                traceparent=ctx.headers.get("traceparent"),
                attributes={"path": path})
        try:
            return self._proxy_request(ctx, path, span)
        except Exception as exc:
            if span is not None:
                span.set_status(f"ERROR: {exc}")
            raise
        finally:
            if span is not None:
                span.end()

    def _failover_span(self, span, name: str, started: float,
                       host: str, code: str) -> None:
        if span is None:
            return
        self.tracer.emit_span(
            name, trace_id=span.trace_id, parent_id=span.span_id,
            start_time=started, end_time=time.time(),
            attributes={"host": host, "code": code},
            status=f"ERROR: {code}")

    def _proxy_request(self, ctx, path: str, span):
        self._leadership_gate()
        trace_id = span.trace_id if span is not None else None
        raw_body = ctx.body or b""
        try:
            body = json.loads(raw_body) if raw_body else {}
        except ValueError:
            body = {}
        if not isinstance(body, dict):
            body = {}
        session = body.get("session") \
            or ctx.headers.get("x-session-id") or None
        if session is not None:
            session = str(session)
        prompt_tokens = self.tokenizer.encode(
            self.routing_text(path, body))
        plan = self.plan(prompt_tokens, session)
        if not plan:
            raise ErrorServiceUnavailable(
                "no fleet members available to route to",
                details={"code": "no_members"},
                headers={"Retry-After": "1"})
        headers = {k: ctx.headers.get(k) for k in _FORWARD_HEADERS
                   if ctx.headers.get(k)}
        if self.tracer is not None:
            # the router span replaces the client's traceparent, so the
            # worker's server span is a child of router.route
            self.tracer.inject_headers(headers)
        attempts = min(len(plan), self.config.max_retries + 1)
        last = None
        retry_code = ""
        read_timeout = self.config.read_timeout_s
        for attempt in range(attempts):
            cand = plan[attempt]
            started = time.time()
            if attempt:
                self._note_retry(retry_code)
            try:
                up = _open_upstream(
                    "POST", cand["address"], path, headers, raw_body,
                    connect_timeout=self.config.connect_timeout_s,
                    read_timeout=read_timeout)
            except (OSError, ValueError) as exc:
                retry_code = "connect_error"
                # transport failover: the host is gone, not busy
                self.events.emit(
                    "router.failover", severity="warn",
                    cause=retry_code, trace_id=trace_id,
                    host=cand["host_id"], attempt=attempt)
                self._failover_span(span, "router.failover", started,
                                    cand["host_id"], retry_code)
                last = _error_response(
                    502, f"upstream {cand['host_id']} unreachable: "
                         f"{exc!r}")
                continue
            if up.status in (429, 503):
                # typed admission rejects are small JSON bodies: read them
                # whole to see details.code, then fail over (no byte was
                # forwarded) or mirror them as they are
                payload = _read_all(up, read_timeout)
                code = _reject_code(payload)
                last = _mirror(up.status, up.headers, payload)
                if up.status == 503 and attempt < attempts - 1 and (
                        code in self.config.retryable_codes
                        or "retry-after" in up.headers):
                    retry_code = code or "503"
                    self.events.emit(
                        "router.retry", severity="warn",
                        cause=retry_code, trace_id=trace_id,
                        host=cand["host_id"], attempt=attempt)
                    self._failover_span(span, "router.retry", started,
                                        cand["host_id"], retry_code)
                    continue
                return last
            self._note_routed(cand, session, retried=attempt)
            if span is not None:
                span.set_attribute("host", cand["host_id"])
                span.set_attribute("attempts", attempt + 1)
            ctype = up.headers.get("content-type",
                                   "application/octet-stream")
            if up.status == 200 and (
                    up.headers.get("transfer-encoding", "").lower()
                    == "chunked" or "text/event-stream" in ctype):
                return Stream(self._abort_watch(_iter_body(up, read_timeout)),
                              content_type=ctype,
                              headers=_mirror_headers(up.headers))
            return _mirror(up.status, up.headers,
                           _read_all(up, read_timeout))
        assert last is not None
        return last

    # ------------------------------------------------------------ misc
    def models_proxy(self, ctx):
        """GET /v1/models from the first healthy member (the model list
        is the same fleet-wide)."""
        self._leadership_gate()
        for m in self._members():
            try:
                up = _open_upstream(
                    "GET", m["address"], "/v1/models", {}, b"",
                    connect_timeout=self.config.connect_timeout_s,
                    read_timeout=self.config.read_timeout_s)
            except (OSError, ValueError):
                continue
            return _mirror(up.status, up.headers,
                           _read_all(up, self.config.read_timeout_s))
        raise ErrorServiceUnavailable(
            "no fleet members available",
            details={"code": "no_members"},
            headers={"Retry-After": "1"})

    def debug_state(self) -> dict:
        """The ``router`` block of ``/debug/fleet``."""
        with self._lock:
            routed = dict(self._routed)
            total = self._routed_total
            hits = self._routed_cache_hits
            affinity_hits = self._affinity_hits
            retries = self._retries
            aborts = self._client_aborts
            quarantines = dict(self._quarantines)
        out = {
            "policy": self.config.policy,
            "routed": routed,
            "routed_total": total,
            "cache_hit_ratio": round(hits / total, 4) if total else 0.0,
            "affinity": {**self.affinity.state(),
                         "hits": affinity_hits},
            "retries": retries,
            "client_aborts": aborts,
            "quarantines": quarantines,
        }
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.state()
        return out

    def install(self, app: Any,
                paths: tuple = ("/chat", "/v1/chat/completions",
                                "/v1/completions")) -> None:
        """Register the proxy routes on ``app``, the leader's ``App`` or
        ``ChatServer``, and adopt its
        metrics manager and tracer."""
        if self.metrics is None:
            self.metrics = app.metrics
            if self.autoscaler is not None:
                self.autoscaler.metrics = self.metrics
        if self.tracer is None:
            self.tracer = getattr(app, "tracer", None)
        if self.metrics is not None:
            for name, desc in _ROUTER_GAUGES:
                if self.metrics.get(name) is None:
                    self.metrics.new_gauge(name, desc)
            for name, desc in _ROUTER_COUNTERS:
                if self.metrics.get(name) is None:
                    self.metrics.new_counter(name, desc)
        if self.autoscaler is not None and self.config.setpoint_file:
            self.autoscaler.load_setpoint_file(self.config.setpoint_file)
        for path in paths:
            app.post(path, self.make_proxy(path))
        if any(p.startswith("/v1/") for p in paths):
            app.get("/v1/models", self.models_proxy)
        if hasattr(self.leader, "status_sources"):
            self.leader.status_sources["router"] = self.debug_state


# --------------------------------------------------- upstream transport
def _base_parts(address: str) -> tuple[str, int]:
    """``host:port`` or ``http://host:port`` -> (host, port)."""
    addr = address
    if "://" in addr:
        addr = addr.split("://", 1)[1]
    addr = addr.split("/", 1)[0]
    host, _, port = addr.rpartition(":")
    if not host:
        return addr, 80
    return host, int(port)


class _Upstream:
    """One proxied request's connection: the response head parsed
    (``status``, lower-case ``headers``), the body still on the socket.
    Its readers are generators that yield ``""`` every ``POLL_S`` while
    the upstream is quiet, so the proxy's server can check its client."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.buf = bytearray()
        self.status = 0
        self.headers: dict[str, str] = {}

    def _more(self, timeout: float):
        """Wait (in polls) for more bytes; False at end of stream."""
        deadline = time.monotonic() + timeout
        while True:
            ready, _, _ = select.select([self.sock], [], [], POLL_S)
            if ready:
                data = self.sock.recv(65536)
                if not data:
                    return False
                self.buf += data
                return True
            if time.monotonic() >= deadline:
                raise TimeoutError("upstream read timed out")
            yield ""

    def read_until(self, sep: bytes, timeout: float, limit: int = 1 << 20):
        while True:
            at = self.buf.find(sep)
            if at >= 0:
                out = bytes(self.buf[:at + len(sep)])
                del self.buf[:at + len(sep)]
                return out
            if len(self.buf) > limit:
                raise ValueError("upstream line too long")
            if not (yield from self._more(timeout)):
                raise ConnectionError("upstream closed mid-answer")

    def read_exact(self, n: int, timeout: float):
        while len(self.buf) < n:
            if not (yield from self._more(timeout)):
                raise ConnectionError("upstream closed mid-answer")
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    def read_some(self, n: int, timeout: float):
        """Up to ``n`` bytes; b"" at end of stream."""
        if not self.buf and not (yield from self._more(timeout)):
            return b""
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _drive(gen):
    """Run one of :class:`_Upstream`'s readers to its value, ignoring its
    idle ticks (for the response head and for buffered bodies)."""
    try:
        while True:
            next(gen)
    except StopIteration as stop:
        return stop.value


def _open_upstream(method: str, address: str, path: str, headers: dict,
                   body: bytes, *, connect_timeout: float,
                   read_timeout: float) -> _Upstream:
    """Dial a member, send the request, parse the response head; the
    body is left for :func:`_iter_body` / :func:`_read_all`."""
    host, port = _base_parts(address)
    sock = socket.create_connection((host, port), timeout=connect_timeout)
    up = _Upstream(sock)
    try:
        head = [f"{method} {path} HTTP/1.1",
                f"Host: {host}:{port}",
                "Connection: close",
                f"Content-Length: {len(body)}"]
        head.extend(f"{k}: {v}" for k, v in headers.items())
        sock.sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                     + body)
        raw = _drive(up.read_until(b"\r\n\r\n", read_timeout,
                                   MAX_HEADER_BYTES))
    except BaseException:
        up.close()
        raise
    lines = raw.decode("latin-1").split("\r\n")
    up.status = int(lines[0].split(" ", 2)[1])
    for line in lines[1:]:
        if ":" in line:
            k, _, v = line.partition(":")
            up.headers[k.strip().lower()] = v.strip()
    return up


def _iter_body(up: _Upstream, timeout: float):
    """The body's chunks as the upstream sends them, with ``""`` while it
    is quiet. Closing this generator (the client left) closes the
    upstream socket, which cancels the worker's stream."""
    try:
        if up.headers.get("transfer-encoding", "").lower() == "chunked":
            while True:
                size_line = yield from up.read_until(b"\r\n", timeout)
                size = int(size_line.strip().split(b";")[0] or b"0", 16)
                if size == 0:
                    break
                yield (yield from up.read_exact(size, timeout))
                yield from up.read_exact(2, timeout)
        elif "content-length" in up.headers:
            remaining = int(up.headers["content-length"])
            while remaining > 0:
                chunk = yield from up.read_some(min(65536, remaining),
                                                timeout)
                if not chunk:
                    break
                remaining -= len(chunk)
                yield chunk
        else:
            while True:
                chunk = yield from up.read_some(65536, timeout)
                if not chunk:
                    break
                yield chunk
    finally:
        up.close()


def _read_all(up: _Upstream, timeout: float) -> bytes:
    return b"".join(c for c in _iter_body(up, timeout) if c)


def _mirror_headers(uhdrs: dict) -> dict:
    return {k.title(): v for k, v in uhdrs.items()
            if k in _MIRROR_HEADERS}


def _mirror(status: int, uhdrs: dict, payload: bytes) -> Reply:
    return Reply(status=status, body=payload,
                 content_type=uhdrs.get("content-type", "application/json"),
                 headers=_mirror_headers(uhdrs))


def _reject_code(payload: bytes) -> str:
    """``details.code`` out of a worker's typed error envelope."""
    try:
        doc = json.loads(payload)
        return str(((doc.get("error") or {}).get("details") or {})
                   .get("code") or "")
    except (ValueError, AttributeError):
        return ""


def _error_response(status: int, message: str) -> Reply:
    return Reply(status=status,
                 body=json.dumps({"error": {"message": message}}).encode())


__all__ = ["Autoscaler", "FleetRouter", "RouterConfig", "SessionAffinity",
           "aligned_prefix_hashes", "prefix_hash"]
