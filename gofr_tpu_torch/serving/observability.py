"""Serving-path observability (the port's copy of
``gofr_tpu/serving/observability.py``): the flight recorder, goodput
accounting, memory watermarks, the recompile sentinel, workload capture
(the replayable ``gofr-workload`` file), the engine's request spans,
tenant usage metering, SLO burn-rate tracking, the stall watchdog, the
card's peak rate for the MFU gauge, and on-demand profiler captures on
``torch.profiler``.

Everything here is host-side bookkeeping over timestamps and counters
the engine already collects: no device sync, no host-to-device copy, no
blocking work on the decode dispatch or collect. The pass ring is an
append-only ``deque`` (appends are atomic under the GIL), request
summaries are assembled once a request retires, and the MFU gauge is
host arithmetic over a flops-per-token figure fixed in ``warmup``.

Left out: the fleet summary, and the TPU peak table and XLA cost
analysis (their counterpart is :func:`device_peak_flops` and the
engine's model-config flops).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import torch

from .events import NO_EVENTS


class FlightRecorder:
    """Fixed-size ring of per-pass records plus a short log of retired
    requests' event trails: the engine's black box. Served as JSON at
    ``/debug/engine``, summarized in ``Engine.health_check()``, dumped
    through the logger when the loop crashes or stalls.

    The writer (the engine thread) only appends plain dicts to bounded
    deques; the reader (``snapshot``) copies under the GIL.
    ``size <= 0`` disables recording entirely.
    """

    def __init__(self, size: int = 256, request_logs: int = 32) -> None:
        self.enabled = size > 0
        self.size = max(0, int(size))
        self._passes: deque = deque(maxlen=max(1, self.size))
        self._requests: deque = deque(maxlen=max(1, int(request_logs)))
        self._seq = 0
        self._by_kind: dict[str, int] = {}
        #: optional () -> goodput summary (``GoodputMeter.summary``):
        #: fleet_summary carries the waste breakdown, so the leader can
        #: say why a host is slow
        self.goodput_source: Any = None
        #: optional () -> prefix-cache digest (``Engine.prefix_digest``):
        #: the leader's router scores hosts by longest resident prefix
        self.prefix_digest_source: Any = None
        #: optional () -> per-signature cost table (``CostModel.table``):
        #: the leader compares hosts on the same dispatch signature
        self.cost_source: Any = None
        #: optional () -> integrity digest block
        #: (``IntegrityPlane.summary``): the leader majority-votes
        #: golden-probe digests across hosts
        self.integrity_source: Any = None

    # ------------------------------------------------------------ writers
    def record_pass(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        self._seq += 1
        rec = {"seq": self._seq, "kind": kind, "t": time.time()}
        rec.update(fields)
        self._passes.append(rec)
        self._by_kind[kind] = self._by_kind.get(kind, 0) + 1

    def record_request(self, summary: dict) -> None:
        if self.enabled:
            self._requests.append(summary)

    # ------------------------------------------------------------ readers
    def snapshot(self, n: int | None = None) -> dict:
        passes = list(self._passes)
        if n is not None and n > 0:
            passes = passes[-n:]
        return {"enabled": self.enabled, "ring_size": self.size,
                "passes_recorded": self._seq, "passes": passes,
                "requests": list(self._requests)}

    def summary(self) -> dict:
        last = self._passes[-1] if self._passes else None
        out = {"passes_recorded": self._seq, "by_kind": dict(self._by_kind)}
        if last is not None:
            out["last_pass_kind"] = last["kind"]
            out["last_pass_age_s"] = round(time.time() - last["t"], 3)
        return out

    def fleet_summary(self) -> dict:
        """The compact per-host digest a control-plane heartbeat carries
        (``serving/control_plane.py``): p50 / p95 pass duration, mean
        occupancy, last queue depth, tokens/s over the pass ring, and
        the sources' blocks (goodput, prefix digest, costs, integrity).
        The leader derives skew, stragglers, routing and the integrity
        vote from these."""
        passes = list(self._passes)
        out: dict = {"passes_recorded": self._seq,
                     "by_kind": dict(self._by_kind)}
        durs = sorted(p["dur"] for p in passes
                      if isinstance(p.get("dur"), (int, float)))
        if durs:
            out["pass_p50_s"] = round(durs[int(0.5 * (len(durs) - 1))], 6)
            out["pass_p95_s"] = round(durs[int(0.95 * (len(durs) - 1))], 6)
        occ = [p["occupancy"] for p in passes
               if isinstance(p.get("occupancy"), (int, float))]
        if occ:
            out["occupancy_mean"] = round(sum(occ) / len(occ), 3)
        depths = [p["queue_depth"] for p in passes
                  if isinstance(p.get("queue_depth"), (int, float))]
        if depths:
            out["queue_depth"] = depths[-1]
        timed = [p for p in passes if "tokens" in p]
        if len(timed) >= 2:
            span = timed[-1]["t"] - timed[0]["t"]
            if span > 0:
                out["tokens_per_s"] = round(
                    sum(p["tokens"] for p in timed[1:]) / span, 2)
        if self.goodput_source is not None:
            try:
                g = self.goodput_source() or {}
            except Exception:
                g = {}
            for key in ("goodput_ratio", "busy_s", "useful_s", "waste_s"):
                if g.get(key) is not None:
                    out[key] = g[key]
        for key, source in (("prefix_digest", self.prefix_digest_source),
                            ("costs", self.cost_source),
                            ("integrity", self.integrity_source)):
            if source is None:
                continue
            try:
                block = source()
            except Exception:  # a broken source must not kill the beat
                block = None
            if block:
                out[key] = block
        return out

    def dump(self, logger: Any, reason: str = "") -> None:
        """Post-mortem: the ring is exactly what you want to see after
        a crash — the last N passes before the loop died."""
        if logger is None or not self.enabled:
            return
        try:
            text = json.dumps(self.snapshot(), default=str)
            logger.error(f"engine flight recorder ({reason or 'dump'}): "
                         f"{text[:16384]}")
        except Exception:
            pass


def request_summary(req: Any) -> dict:
    """Flight-recorder entry for a retired request — plain host fields."""
    return {
        "prompt_tokens": len(req.prompt_tokens),
        "generated": len(req.generated),
        "slot": req.slot,
        "tenant": getattr(req, "tenant", None),
        "device_s": round(getattr(req, "device_s", 0.0), 6),
        "submitted_at": req.submitted_at,
        "admitted_at": req.admitted_at,
        "first_token_at": req.first_token_at,
        "finished_at": req.finished_at,
        "ttft_ms": round(req.ttft_ms, 3) if req.ttft_ms is not None else None,
        "error": req.error,
        "cancelled": req.cancelled,
        "digest": getattr(req, "digest", None),
        "events": [{"name": name, "t0": t0, "t1": t1, **(attrs or {})}
                   for name, t0, t1, attrs in req.events],
    }


# ------------------------------------------------- goodput accounting
class GoodputMeter:
    """Device-time waste attribution with a hard conservation
    invariant: every accounted device-second is classified as
    ``useful`` or one of the waste causes, and

        ``useful_s + sum(waste_s.values()) == busy_s``

    holds at all times (useful is computed as the residual of each
    pass's classification, so the identity is structural, not
    statistical — tests pin it across every pass kind).

    Causes (the taxonomy ``/debug/efficiency`` and
    ``app_engine_waste_seconds{cause}`` expose):

    - ``padding`` — inactive/pad rows in a dispatched fixed-shape
      batch: empty decode slots, dummy prefill-group rows, verify rows
      discarded before collect. The kernels tolerate them by design;
      the meter prices them.
    - ``preempt_recompute`` — prefill time spent re-computing KV a
      preempted request already produced once (vLLM-style
      preemption-by-recompute), plus batch-prefill rows orphaned by a
      preemption mid-flight.
    - ``spec_rejected`` — the drafted-minus-accepted fraction of each
      speculative verify row: positions computed and thrown away.
    - ``bubble`` — wall-clock gaps between a collect completing with
      NOTHING left in flight and the next dispatch, while work was
      waiting (queued, requeued or active). Host scheduling overhead
      the device spends idle — the dispatch-bound regime BENCH_r05
      measured, now a named number.
    - ``integrity_probe`` — device time spent serving golden canary
      probes (serving/integrity.py): correct-by-design synthetic
      traffic, re-priced out of ``useful`` at the probe's retire
      (:meth:`reprice_probe`) so correctness verification is never
      mistaken for serving goodput.

    Everything is engine-thread float arithmetic at dispatch/collect —
    the same single-writer discipline as the FlightRecorder; no locks,
    no device syncs, zero hot-path perturbation (the transfer-guard
    and greedy bit-identity tests run with the meter ON). ``busy_s``
    sums per-pass durations, so with pipelining it may exceed wall
    time — it is an attribution base, not a wall clock.
    """

    CAUSES = ("padding", "preempt_recompute", "spec_rejected", "bubble",
              "integrity_probe")

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self.reset()

    def reset(self) -> None:
        self.busy_s = 0.0
        self.useful_s = 0.0
        self.waste_s = {c: 0.0 for c in self.CAUSES}
        self.passes = 0
        #: per-pass-kind sub-ledger for the /debug/efficiency rollup
        self.by_kind: dict[str, dict] = {}
        self._free_at: float | None = None
        self._backlog = False

    # ------------------------------------------------------------ feeds
    def _account(self, kind: str, busy: float, useful: float,
                 **wastes: float) -> None:
        self.busy_s += busy
        self.useful_s += useful
        sub = self.by_kind.setdefault(
            kind, {"busy_s": 0.0, "useful_s": 0.0,
                   **{c: 0.0 for c in self.CAUSES}})
        sub["busy_s"] += busy
        sub["useful_s"] += useful
        for cause, amount in wastes.items():
            if amount:
                self.waste_s[cause] += amount
                sub[cause] += amount
        self.passes += 1

    def add_decode(self, busy: float, served_rows: int,
                   batch: int) -> None:
        """A decode pass: the graph always runs the full ``batch``
        shape; rows that emitted no kept tokens (empty slots,
        pending-prefill sentinels, retired requests riding out a
        pipelined pass) are padding."""
        if not self.enabled or busy <= 0 or batch <= 0:
            return
        served = max(0, min(int(served_rows), batch))
        useful = busy * served / batch
        self._account("decode", busy, useful, padding=busy - useful)

    def add_prefill(self, kind: str, busy: float, group: int,
                    fresh_rows: int, recompute_rows: int) -> None:
        """A (batch or chunk) prefill dispatch of ``group`` padded
        rows: ``fresh_rows`` computed new KV, ``recompute_rows``
        re-prefilled a preempted request's history (or were orphaned
        by one), the rest were dummy pad rows."""
        if not self.enabled or busy <= 0 or group <= 0:
            return
        share = busy / group
        fresh = max(0, min(int(fresh_rows), group))
        recomp = max(0, min(int(recompute_rows), group - fresh))
        self._account(kind, busy, fresh * share,
                      preempt_recompute=recomp * share,
                      padding=(group - fresh - recomp) * share)

    def add_spec(self, busy: float, batch: int,
                 rows: list[tuple[int, int]]) -> None:
        """A speculative verify pass over a full-``batch`` graph.
        ``rows`` carries one ``(drafted, accepted)`` pair per row that
        survived to collect; each row's useful fraction is the emitted
        tokens (accepted + bonus) over its fed positions
        (1 + drafted), the rejected remainder is ``spec_rejected``,
        and rows not fed (or discarded by a mid-pass preemption) are
        padding."""
        if not self.enabled or busy <= 0 or batch <= 0:
            return
        share = busy / batch
        useful = rejected = 0.0
        for drafted, accepted in rows:
            drafted = max(0, int(drafted))
            accepted = max(0, min(int(accepted), drafted))
            useful += share * (1 + accepted) / (1 + drafted)
            rejected += share * (drafted - accepted) / (1 + drafted)
        self._account("spec_verify", busy, useful,
                      spec_rejected=rejected,
                      padding=max(0, batch - len(rows)) * share)

    def reprice_probe(self, device_s: float) -> None:
        """Re-price a retired golden probe's attributed device time
        from ``useful`` to the ``integrity_probe`` waste cause —
        ``busy_s`` unchanged, so the conservation identity stays
        structural. The transfer lands in ``by_kind`` as a dedicated
        ``integrity_probe`` journal row (zero busy, negative useful)
        so per-kind sums still reconcile against the totals."""
        if not self.enabled or device_s <= 0:
            return
        moved = min(float(device_s), self.useful_s)
        if moved <= 0:
            return
        self.useful_s -= moved
        self.waste_s["integrity_probe"] += moved
        sub = self.by_kind.setdefault(
            "integrity_probe", {"busy_s": 0.0, "useful_s": 0.0,
                                **{c: 0.0 for c in self.CAUSES}})
        sub["useful_s"] -= moved
        sub["integrity_probe"] += moved

    def note_pass_end(self, t: float, backlog: bool) -> None:
        """The device went idle at host time ``t`` (a collect finished
        with nothing left in flight). ``backlog`` records whether work
        was waiting — only then does the gap to the next dispatch
        count as a bubble."""
        if self.enabled:
            self._free_at = t
            self._backlog = bool(backlog)

    def note_dispatch(self, t: float) -> None:
        """A device dispatch at host time ``t`` closes any open idle
        gap; with backlog pending, the gap was a bubble: device-time
        lost to host-side scheduling while requests waited."""
        if not self.enabled or self._free_at is None:
            return
        gap = t - self._free_at
        self._free_at = None
        if self._backlog and gap > 0:
            self.busy_s += gap
            self.waste_s["bubble"] += gap

    # ---------------------------------------------------------- readers
    def summary(self) -> dict:
        """The compact digest: heartbeat summaries, workload headers,
        the bench payload."""
        busy = self.busy_s
        out = {"busy_s": round(busy, 6),
               "useful_s": round(self.useful_s, 6),
               "waste_s": {c: round(v, 6)
                           for c, v in self.waste_s.items()}}
        if busy > 0:
            out["goodput_ratio"] = round(self.useful_s / busy, 6)
        return out

    def dominant_waste(self) -> str | None:
        worst = max(self.waste_s, key=self.waste_s.get, default=None)
        return worst if worst and self.waste_s[worst] > 0 else None

    def state(self) -> dict:
        """The full ``/debug/efficiency`` payload: totals, per-kind
        breakdown, dominant cause, and the conservation residual (a
        float-epsilon health check on the invariant itself)."""
        out = self.summary()
        out["enabled"] = self.enabled
        out["passes"] = self.passes
        out["dominant_waste"] = self.dominant_waste()
        out["by_kind"] = {k: {kk: round(vv, 6) for kk, vv in sub.items()}
                          for k, sub in self.by_kind.items()}
        out["conservation_error_s"] = round(
            self.busy_s - self.useful_s - sum(self.waste_s.values()), 9)
        return out


class WatermarkTracker:
    """Memory high-water marks with timestamps: KV-pool pages (or rows
    for the slot layout), prefix-cache pages, and host RSS. Updated on
    the engine's throttled gauge cadence — pure host compares, monotone
    non-decreasing within a run by construction. Served in
    ``/debug/efficiency`` and as ``app_engine_*_watermark`` gauges."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self._marks: dict[str, dict] = {}
        #: EventLedger high-water crossings are recorded on (engine
        #: wiring); crossings within 5% of the last recorded one are
        #: not re-recorded, so a slowly creeping mark can't flood the
        #: ring while the ratchet still lands in the timeline
        self.events = NO_EVENTS
        self._event_marks: dict[str, float] = {}

    def update(self, name: str, value: float,
               t: float | None = None) -> bool:
        """Record ``value`` if it is a new high-water mark; returns
        True when the mark advanced."""
        if not self.enabled:
            return False
        mark = self._marks.get(name)
        if mark is not None and value <= mark["value"]:
            return False
        self._marks[name] = {"value": value,
                             "t": time.time() if t is None else t}
        last = self._event_marks.get(name)
        if last is None or value >= last * 1.05:
            self._event_marks[name] = value
            self.events.emit("obs.watermark", cause=name, value=value)
        return True

    def update_rss(self) -> None:
        """Host RSS high-water mark from the kernel's own accounting
        (``ru_maxrss`` is already a max — one cheap syscall)."""
        if not self.enabled:
            return
        try:
            import resource
            kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            self.update("host_rss_bytes", float(kb) * 1024.0)
        except Exception:
            pass

    def get(self, name: str) -> float | None:
        mark = self._marks.get(name)
        return mark["value"] if mark is not None else None

    def state(self) -> dict:
        return {name: dict(mark) for name, mark in self._marks.items()}


class RecompileSentinel:
    """Detects dispatch shapes that ``warmup`` never ran.

    Dispatch sites are keyed by shape signatures: prefill (bucket,
    group), chunk (width, group, window), decode (window), verify (tree
    width). ``warmup()`` observes every signature it runs, then
    ``seal()``s the sentinel; after that the first dispatch of a novel
    signature is a shape warmup did not cover (in the JAX engine a
    serving-path recompile; in the port a shape whose first run pays
    its allocations, or a decode graph's capture, on the serving path).
    The engine bumps ``app_engine_recompiles`` and WARNs once per
    signature.

    Host-side set lookups at dispatch time: O(1), no device work.
    Engines that never warm up never seal, so the sentinel stays
    silent."""

    MAX_SIGNATURES = 32

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self.sealed = False
        self.recompiles = 0
        self.signatures: list[str] = []
        self._seen: set = set()

    def observe(self, sig: tuple) -> None:
        """Seed an expected signature (warmup-time compiles)."""
        if self.enabled:
            self._seen.add(sig)

    def seal(self) -> None:
        """Warmup is done: novel signatures are recompiles from now."""
        self.sealed = True

    def dispatch(self, sig: tuple) -> bool:
        """Note a dispatch; True when it is a novel POST-warmup shape
        (fires exactly once per signature — the repeat dispatch hits a
        warm graph and stays silent)."""
        if not self.enabled or sig in self._seen:
            return False
        self._seen.add(sig)
        if not self.sealed:
            return False
        self.recompiles += 1
        if len(self.signatures) < self.MAX_SIGNATURES:
            self.signatures.append("/".join(str(p) for p in sig))
        return True

    def state(self) -> dict:
        return {"enabled": self.enabled, "sealed": self.sealed,
                "recompiles": self.recompiles,
                "signatures": list(self.signatures),
                "known_shapes": len(self._seen)}


# ------------------------------------------------- workload capture
#
# Versioned workload-file format (JSONL): the first line is a header
# object, every following line one retired request. The replay module
# (serving/replay.py) refuses unknown formats and versions, so the
# header is the compatibility contract; its keys and the records' are
# the JAX package's, so a workload captured on one package replays on
# the other.
WORKLOAD_FORMAT = "gofr-workload"
WORKLOAD_VERSION = 1


def salted_token_hash(tokens: Any, salt: str) -> str:
    """Stable redaction digest of a token-id sequence. The salt is drawn
    per recorder (never serialized), so captured hashes cannot be
    dictionary-attacked against a known tokenizer, while two requests
    with the same prompt in one capture still collide."""
    body = ",".join(str(int(t)) for t in tokens)
    return hashlib.sha256(f"{salt}:{body}".encode()).hexdigest()[:24]


class WorkloadRecorder:
    """Bounded ring of per-request workload records: the traffic, as the
    :class:`FlightRecorder` keeps the passes. Served as a versioned JSONL
    file at ``GET /debug/workload``, armed and disarmed by ``POST
    /debug/workload/start|stop`` or ``EngineConfig.workload_capture``.

    A record is assembled once per request at its end
    (``Engine._finalize_obs``) from fields the request carries: arrival
    time, prompt ids, sampling params, the engine's resolved seed,
    tenant, and the outcome (completion ids, TTFT / TPOT / e2e, status,
    digest). ``redact=True`` stores salted hashes and lengths instead of
    the ids: shippable, not replayable (``replay_workload`` refuses it).
    """

    def __init__(self, size: int = 4096, *, redact: bool = False,
                 engine_seed: int | None = None) -> None:
        self.enabled = size > 0
        self.size = max(0, int(size))
        self.redact = bool(redact)
        self.engine_seed = engine_seed
        self.capturing = False
        self.started_at: float | None = None
        self._salt = os.urandom(8).hex()
        self._records: deque = deque(maxlen=max(1, self.size))
        self._seq = 0
        self._dropped = 0
        #: optional () -> GoodputMeter.summary: the header then carries
        #: the capture's waste digest
        self.goodput_source: Any = None
        #: optional () -> CostModel.table: the header then carries the
        #: capture's per-signature cost table
        self.cost_source: Any = None

    # ------------------------------------------------------------ control
    def start(self, redact: bool | None = None) -> dict:
        """Arm capture with a fresh ring (a capture is one workload)."""
        if not self.enabled:
            return self.status()
        if redact is not None:
            self.redact = bool(redact)
        self._records.clear()
        self._seq = 0
        self._dropped = 0
        self.started_at = time.time()
        self.capturing = True
        return self.status()

    def stop(self) -> dict:
        self.capturing = False
        return self.status()

    def status(self) -> dict:
        return {"enabled": self.enabled, "capturing": self.capturing,
                "redact": self.redact, "size": self.size,
                "records": len(self._records), "recorded": self._seq,
                "dropped": self._dropped, "started_at": self.started_at}

    # ------------------------------------------------------------ writer
    def record(self, req: Any) -> None:
        """One ended request -> one record (an append to a bounded deque
        on the engine thread)."""
        if not (self.enabled and self.capturing):
            return
        self._seq += 1
        if len(self._records) == self._records.maxlen:
            self._dropped += 1
        p = req.params
        status = ("cancelled" if req.cancelled
                  else "error" if req.error is not None else "ok")
        end = req.finished_at
        n = len(req.generated)
        tpot_ms = None
        if req.first_token_at is not None and end is not None and n > 1:
            tpot_ms = (end - req.first_token_at) * 1000.0 / (n - 1)
        rec: dict = {
            "t": req.submitted_at,
            "tenant": getattr(req, "tenant", None),
            # every request shares the engine's resolved seed; recorded
            # per request so the format survives a per-request generator
            "seed": self.engine_seed,
            "params": {"temperature": p.temperature, "top_p": p.top_p,
                       "top_k": p.top_k,
                       "max_new_tokens": p.max_new_tokens},
            "status": status,
        }
        if self.redact:
            rec["prompt_hash"] = salted_token_hash(req.prompt_tokens,
                                                   self._salt)
            rec["prompt_len"] = len(req.prompt_tokens)
            rec["completion_hash"] = salted_token_hash(req.generated,
                                                       self._salt)
            rec["completion_len"] = n
        else:
            rec["prompt_tokens"] = list(req.prompt_tokens)
            rec["completion_tokens"] = list(req.generated)
        if getattr(req, "digest", None):
            rec["digest"] = req.digest
        if req.error is not None:
            rec["error"] = str(req.error)[:200]
        if req.ttft_ms is not None:
            rec["ttft_ms"] = round(req.ttft_ms, 3)
        if tpot_ms is not None:
            rec["tpot_ms"] = round(tpot_ms, 3)
        if end is not None:
            rec["e2e_ms"] = round((end - req.submitted_at) * 1000.0, 3)
        self._records.append(rec)

    # ------------------------------------------------------------ readers
    def header(self) -> dict:
        out = {"format": WORKLOAD_FORMAT, "version": WORKLOAD_VERSION,
               "redacted": self.redact, "engine_seed": self.engine_seed,
               "started_at": self.started_at, "recorded": self._seq,
               "dropped": self._dropped}
        if self.goodput_source is not None:
            try:
                g = self.goodput_source()
                if g and g.get("busy_s"):
                    out["goodput"] = g
            except Exception:
                pass
        if self.cost_source is not None:
            try:
                costs = self.cost_source()
                if costs:
                    out["costs"] = costs
            except Exception:
                pass
        return out

    def snapshot(self, n: int | None = None) -> dict:
        records = list(self._records)
        if n is not None and n > 0:
            records = records[-n:]
        return {"header": self.header(), "records": records}

    def to_jsonl(self, n: int | None = None) -> str:
        """The ``GET /debug/workload`` body: the header line, then one
        line per record in the ring's (retire) order."""
        snap = self.snapshot(n)
        lines = [json.dumps(snap["header"])]
        lines.extend(json.dumps(rec) for rec in snap["records"])
        return "\n".join(lines) + "\n"


def emit_engine_spans(tracer: Any, req: Any) -> None:
    """Assemble a finished request's ``engine.*`` spans and export them
    through ``tracer``, once, from host timestamps the request already
    holds: ``engine.request`` (the parent: the caller's span or inbound
    ``traceparent``, ``req.trace`` = (trace_id, parent_span_id)), then
    ``engine.queue``, one span per lifecycle event (``engine.prefill``
    per group prefill or chunk), ``engine.decode`` and
    ``engine.retire``."""
    trace = getattr(req, "trace", None)
    if tracer is None or trace is None:
        return
    trace_id, parent_id = trace
    end = req.finished_at or time.time()
    status = "OK" if req.error is None else f"ERROR: {req.error}"
    attrs = {"prompt_tokens": len(req.prompt_tokens),
             "generated_tokens": len(req.generated),
             "slot": req.slot, "cancelled": req.cancelled}
    if getattr(req, "tenant", None):
        attrs["tenant"] = req.tenant
    root = tracer.emit_span(
        "engine.request", trace_id=trace_id, parent_id=parent_id,
        start_time=req.submitted_at, end_time=end, status=status,
        attributes=attrs)
    admit = req.admitted_at or req.first_token_at or end
    tracer.emit_span("engine.queue", trace_id=trace_id,
                     parent_id=root.span_id, start_time=req.submitted_at,
                     end_time=admit)
    for name, t0, t1, ev_attrs in req.events:
        tracer.emit_span(f"engine.{name}", trace_id=trace_id,
                         parent_id=root.span_id, start_time=t0,
                         end_time=t1, attributes=ev_attrs)
    if req.first_token_at is not None:
        n = len(req.generated)
        tpot = ((end - req.first_token_at) / (n - 1)) if n > 1 else None
        tracer.emit_span(
            "engine.decode", trace_id=trace_id, parent_id=root.span_id,
            start_time=req.first_token_at, end_time=end,
            attributes={"tokens": n,
                        "tpot_s": round(tpot, 6) if tpot else None})
    tracer.emit_span("engine.retire", trace_id=trace_id,
                     parent_id=root.span_id, start_time=end, end_time=end,
                     attributes={"error": req.error or ""})


# ----------------------------------------------------- usage metering
def parse_window(spec: str | None) -> float | None:
    """``"5m"``/``"1h"``/``"30s"``/``"300"`` -> seconds; None/'' -> None
    (cumulative totals). Raises ValueError on garbage."""
    if not spec:
        return None
    spec = spec.strip().lower()
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}.get(spec[-1])
    if mult is not None:
        return float(spec[:-1]) * mult
    return float(spec)


def _fmt_window(seconds: float) -> str:
    if seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{int(seconds)}s"


class UsageLedger:
    """Per-tenant usage accounting, fed once per retired request from
    the engine's ``_finalize_obs`` — the metering plane behind
    ``app_tenant_*`` metrics, ``GET /debug/usage`` and the federated
    fleet rollup.

    Everything is host arithmetic over numbers the engine already
    collected (token counts, lifecycle timestamps, the per-pass
    device-time shares accumulated during collects), recorded at
    retire on the engine thread — the hot loop never touches this.
    Cumulative totals live per tenant; a bounded event ring
    (``window_records``) answers windowed queries, so
    ``?window=5m`` rollups degrade gracefully (oldest events drop)
    instead of growing without bound.
    """

    def __init__(self, metrics: Any = None,
                 window_records: int = 4096) -> None:
        self.metrics = metrics
        self._lock = threading.Lock()
        self._totals: dict[str, dict] = {}
        self._events: deque = deque(maxlen=max(1, int(window_records)))

    @staticmethod
    def _blank() -> dict:
        return {"requests": {}, "prompt_tokens": 0,
                "completion_tokens": 0, "device_s": 0.0,
                "queue_s": 0.0, "e2e_s": 0.0,
                # who pays for inefficiency: the slice of this
                # tenant's device_s that was preemption recompute or
                # rejected speculation (padding/bubbles are systemic,
                # not attributable to one principal)
                "waste_recompute_s": 0.0, "waste_spec_s": 0.0}

    def record(self, *, tenant: str, status: str, prompt_tokens: int,
               completion_tokens: int, queue_s: float = 0.0,
               e2e_s: float = 0.0, device_s: float = 0.0,
               waste_recompute_s: float = 0.0,
               waste_spec_s: float = 0.0,
               t: float | None = None) -> None:
        t = time.time() if t is None else t
        with self._lock:
            tot = self._totals.setdefault(tenant, self._blank())
            tot["requests"][status] = tot["requests"].get(status, 0) + 1
            tot["prompt_tokens"] += int(prompt_tokens)
            tot["completion_tokens"] += int(completion_tokens)
            tot["device_s"] += float(device_s)
            tot["queue_s"] += float(queue_s)
            tot["e2e_s"] += float(e2e_s)
            tot["waste_recompute_s"] += float(waste_recompute_s)
            tot["waste_spec_s"] += float(waste_spec_s)
            self._events.append(
                {"t": t, "tenant": tenant, "status": status,
                 "prompt_tokens": int(prompt_tokens),
                 "completion_tokens": int(completion_tokens),
                 "device_s": float(device_s), "queue_s": float(queue_s),
                 "e2e_s": float(e2e_s),
                 "waste_recompute_s": float(waste_recompute_s),
                 "waste_spec_s": float(waste_spec_s)})
        m = self.metrics
        if m is None:
            return
        m.increment_counter("app_tenant_requests", tenant=tenant,
                            status=status)
        if prompt_tokens:
            m.add_counter("app_tenant_prompt_tokens",
                          float(prompt_tokens), tenant=tenant)
        if completion_tokens:
            m.add_counter("app_tenant_completion_tokens",
                          float(completion_tokens), tenant=tenant)
        if device_s > 0:
            m.add_counter("app_tenant_device_seconds", float(device_s),
                          tenant=tenant)
        if waste_recompute_s > 0:
            m.add_counter("app_tenant_waste_seconds",
                          float(waste_recompute_s), tenant=tenant,
                          cause="preempt_recompute")
        if waste_spec_s > 0:
            m.add_counter("app_tenant_waste_seconds",
                          float(waste_spec_s), tenant=tenant,
                          cause="spec_rejected")
        m.record_histogram("app_tenant_queue_seconds", float(queue_s),
                           tenant=tenant)
        m.record_histogram("app_tenant_e2e_seconds", float(e2e_s),
                           tenant=tenant)

    def rollup(self, tenant: str | None = None,
               window_s: float | None = None) -> dict:
        """The ``GET /debug/usage`` JSON: cumulative totals per tenant,
        or windowed sums over the event ring when ``window_s`` is
        given (flagged ``partial`` when the ring has rotated past the
        window start — the caller knows the sum is a floor)."""
        with self._lock:
            if window_s is None:
                per_tenant = {name: {**tot,
                                     "requests": dict(tot["requests"])}
                              for name, tot in self._totals.items()
                              if tenant is None or name == tenant}
                out = {"window": None, "tenants": per_tenant}
            else:
                cutoff = time.time() - window_s
                per_tenant = {}
                for ev in self._events:
                    if ev["t"] < cutoff:
                        continue
                    if tenant is not None and ev["tenant"] != tenant:
                        continue
                    tot = per_tenant.setdefault(ev["tenant"],
                                                self._blank())
                    tot["requests"][ev["status"]] = \
                        tot["requests"].get(ev["status"], 0) + 1
                    for key in ("prompt_tokens", "completion_tokens",
                                "device_s", "queue_s", "e2e_s",
                                "waste_recompute_s", "waste_spec_s"):
                        tot[key] += ev.get(key, 0)
                partial = bool(self._events) and \
                    self._events[0]["t"] > cutoff and \
                    len(self._events) == self._events.maxlen
                out = {"window": _fmt_window(window_s),
                       "tenants": per_tenant, "partial": partial}
        for tot in out["tenants"].values():
            for key in ("device_s", "queue_s", "e2e_s",
                        "waste_recompute_s", "waste_spec_s"):
                tot[key] = round(tot.get(key, 0.0), 6)
        return out


# -------------------------------------------------------------- SLO
@dataclass
class SLOConfig:
    """Service-level objectives for the chat path (docs/configs.md).

    A retired request is GOOD when it finished without error and met
    every configured latency threshold (``None`` disables that
    dimension); cancelled requests are excluded (the client left —
    nothing was violated). The tracker turns good/bad streams into
    multi-window burn rates against the availability target, the
    standard SRE alerting shape: burn rate 1.0 = spending the error
    budget exactly at the sustainable pace.
    """

    #: time-to-first-token threshold (seconds); None = not judged
    ttft_s: float | None = 2.0
    #: mean inter-token latency threshold (seconds); None = not judged
    tpot_s: float | None = 0.5
    #: end-to-end latency threshold (seconds); None = not judged
    e2e_s: float | None = 30.0
    #: availability objective: the target fraction of good requests
    availability: float = 0.999
    #: burn-rate windows (seconds); the SHORTEST is the fast-burn
    #: window the WARN escalation watches
    windows: tuple = (300.0, 3600.0)
    #: WARN once per episode when the fast-window burn rate crosses
    #: this (14.4 = the classic "2% of a 30-day budget in one hour"
    #: page threshold). 0 disables the escalation.
    fast_burn: float = 14.4
    #: horizon the error-budget-remaining gauge is computed over
    budget_window_s: float = 86400.0
    #: per-window event ring bound; beyond it the oldest events drop
    #: (rates stay correct over what is retained)
    max_events: int = 65536


class SLOTracker:
    """Multi-window burn-rate tracking over the retired-request
    stream: ``app_slo_burn_rate{window=...}`` and
    ``app_slo_error_budget_remaining`` gauges, the ``GET /debug/slo``
    state, and a WARN once per fast-burn episode.

    Fed from ``Engine._finalize_obs`` (host arithmetic at retire,
    zero hot-path work). Each window keeps a rolling (deque, total,
    bad) triple — O(1) amortized per request."""

    def __init__(self, config: SLOConfig | None = None,
                 metrics: Any = None, logger: Any = None) -> None:
        self.config = config if config is not None else SLOConfig()
        self.metrics = metrics
        self.logger = logger
        #: EventLedger fast-burn episodes are recorded on (app wiring)
        self.events = NO_EVENTS
        #: optional zero-arg hook fired once per fast-burn episode: the
        #: app's incident trigger rides here
        self.on_fast_burn = None
        self._lock = threading.Lock()
        horizons = tuple(sorted(set(
            tuple(self.config.windows) + (self.config.budget_window_s,))))
        self._wins = {w: {"events": deque(maxlen=self.config.max_events),
                          "total": 0, "bad": 0} for w in horizons}
        self._total = 0
        self._bad = 0
        self._escalated = False
        #: monotonic high-water mark over fed timestamps: record()
        #: clamps each t up to it so the per-window deques stay sorted
        #: — _evict_locked pops from the head while events age out,
        #: which silently under- or over-counts if a late-arriving
        #: older timestamp lands behind a newer one (replay feeds and
        #: multi-source clocks do this)
        self._last_t = float("-inf")

    # ------------------------------------------------------------ feed
    def judge(self, *, error: str | None, ttft_s: float | None,
              tpot_s: float | None, e2e_s: float | None) -> bool:
        """Good iff no error and every configured threshold held."""
        if error is not None:
            return False
        cfg = self.config
        for value, limit in ((ttft_s, cfg.ttft_s),
                             (tpot_s, cfg.tpot_s),
                             (e2e_s, cfg.e2e_s)):
            if limit is not None and value is not None and value > limit:
                return False
        return True

    def record(self, good: bool, t: float | None = None) -> None:
        t = time.time() if t is None else t
        with self._lock:
            # modest reordering tolerated: clamp to the newest seen
            # timestamp so windows stay sorted and eviction stays exact
            t = max(t, self._last_t)
            self._last_t = t
            self._total += 1
            self._bad += 0 if good else 1
            for w, win in self._wins.items():
                if win["events"].maxlen == len(win["events"]):
                    _, old_bad = win["events"][0]  # about to rotate out
                    win["total"] -= 1
                    win["bad"] -= old_bad
                win["events"].append((t, 0 if good else 1))
                win["total"] += 1
                win["bad"] += 0 if good else 1
                self._evict_locked(w, t)
            state = self._state_locked(t)
        self._publish(state)

    def _evict_locked(self, w: float, now: float) -> None:
        win = self._wins[w]
        events = win["events"]
        cutoff = now - w
        while events and events[0][0] < cutoff:
            _, bad = events.popleft()
            win["total"] -= 1
            win["bad"] -= bad

    # ----------------------------------------------------------- state
    def _burn_locked(self, w: float) -> dict:
        win = self._wins[w]
        total, bad = win["total"], win["bad"]
        err_rate = (bad / total) if total else 0.0
        budget = max(1e-9, 1.0 - self.config.availability)
        return {"total": total, "bad": bad,
                "error_rate": round(err_rate, 6),
                "burn_rate": round(err_rate / budget, 4)}

    def _state_locked(self, now: float) -> dict:
        for w in self._wins:
            self._evict_locked(w, now)
        windows = {_fmt_window(w): self._burn_locked(w)
                   for w in self.config.windows}
        bw = self.config.budget_window_s
        budget_win = self._burn_locked(bw)
        allowed = budget_win["total"] * (1.0 - self.config.availability)
        remaining = 1.0 - (budget_win["bad"] / allowed) if allowed > 0 \
            else (0.0 if budget_win["bad"] else 1.0)
        fast_w = min(self.config.windows)
        fast = windows[_fmt_window(fast_w)]["burn_rate"]
        return {
            "objectives": {"ttft_s": self.config.ttft_s,
                           "tpot_s": self.config.tpot_s,
                           "e2e_s": self.config.e2e_s,
                           "availability": self.config.availability},
            "windows": windows,
            "budget": {"window": _fmt_window(bw),
                       "total": budget_win["total"],
                       "bad": budget_win["bad"],
                       "remaining": round(max(-1.0, min(1.0, remaining)),
                                          6)},
            "fast_burn": {"window": _fmt_window(fast_w),
                          "burn_rate": fast,
                          "threshold": self.config.fast_burn,
                          "tripped": bool(self.config.fast_burn
                                          and fast >= self.config.fast_burn)},
            "lifetime": {"total": self._total, "bad": self._bad},
        }

    def state(self) -> dict:
        """The ``GET /debug/slo`` payload."""
        with self._lock:
            return self._state_locked(time.time())

    def _publish(self, state: dict) -> None:
        m = self.metrics
        if m is not None:
            for label, win in state["windows"].items():
                m.set_gauge("app_slo_burn_rate", win["burn_rate"],
                            window=label)
            m.set_gauge("app_slo_error_budget_remaining",
                        state["budget"]["remaining"])
        tripped = state["fast_burn"]["tripped"]
        if tripped and not self._escalated:
            self._escalated = True
            if self.logger is not None:
                self.logger.warn(
                    "SLO fast burn: error budget burning at "
                    f"{state['fast_burn']['burn_rate']}x over the "
                    f"{state['fast_burn']['window']} window",
                    threshold=state["fast_burn"]["threshold"],
                    budget_remaining=state["budget"]["remaining"])
            self.events.emit(
                "obs.fast_burn", severity="error",
                burn_rate=state["fast_burn"]["burn_rate"],
                window=state["fast_burn"]["window"],
                budget_remaining=state["budget"]["remaining"])
            hook = self.on_fast_burn
            if hook is not None:
                try:
                    hook()
                except Exception:  # noqa: BLE001 — never fail a retire
                    pass
        elif not tripped:
            self._escalated = False  # episode over; re-arm


# ----------------------------------------------------------- watchdog
class StallWatchdog:
    """Promotes the engine's passive stall flag into action.

    ``Engine.health_check()`` flips to DEGRADED when work is in flight
    but no loop iteration has begun for ``stall_threshold_s``; this
    thread polls it and, once per stall episode:

    - dumps the flight recorder through the engine's logger (the last
      passes before the hang are the post-mortem),
    - bumps ``stats["stalls"]`` and the ``app_engine_stalls`` counter,
    - emits an ``engine.stall`` span through the engine's tracer, when
      it has one,
    - records a ``fleet.stall`` event.

    Everything runs on this thread against host-side state; the loop is
    never touched. It re-arms when the engine recovers, so a flapping
    device reports each episode.
    """

    def __init__(self, engine: Any, interval_s: float = 5.0) -> None:
        self.engine = engine
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._escalated = False

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="engine-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(self.interval_s + 1.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:  # a broken check must not kill the thread
                pass

    def check_once(self) -> bool:
        """One poll; returns True when a stall was escalated."""
        engine = self.engine
        health = engine.health_check()
        stalled = (health.get("status") == "DEGRADED"
                   and "stalled_for_s" in health)
        if not stalled:
            self._escalated = False
            return False
        if self._escalated:
            return False  # already reported this episode
        self._escalated = True
        stalled_for = health.get("stalled_for_s")
        engine.stats["stalls"] = engine.stats.get("stalls", 0) + 1
        if engine.logger is not None:
            engine.logger.error(
                "engine stalled: work in flight but no pass for "
                f"{stalled_for}s", active=health.get("active_slots"),
                waiting=health.get("waiting"))
        engine.recorder.dump(engine.logger,
                             reason=f"stall: no pass for {stalled_for}s")
        if engine.metrics is not None:
            engine.metrics.increment_counter("app_engine_stalls")
        tracer = getattr(engine, "tracer", None)
        if tracer is not None:
            tracer.start_span("engine.stall", attributes={
                "stalled_for_s": stalled_for,
                "active_slots": health.get("active_slots"),
                "waiting": health.get("waiting")}).end()
        engine.events.emit(
            "fleet.stall", severity="error",
            cause="no pass completed",
            stalled_for_s=stalled_for,
            active_slots=health.get("active_slots"),
            waiting=health.get("waiting"))
        return True


# ------------------------------------------------------------------- MFU
#
# Dense bf16 tensor-core peaks (FLOP/s, without sparsity) by CUDA device
# name: the H100 SXM's 989 TFLOP/s from NVIDIA's data sheet, at its full
# 700 W (``torch.cuda.get_device_name`` reads "NVIDIA H100 80GB HBM3").
# A name not listed gives None and the MFU gauge stays 0: never a guess.
GPU_PEAK_FLOPS = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12}


def device_peak_flops(device: torch.device | str | None = None
                      ) -> float | None:
    """The dense bf16 peak of ``device``'s card, or None on the CPU or
    for a card the table does not list."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    return next((peak for key, peak in GPU_PEAK_FLOPS.items()
                 if key in name), None)


# -------------------------------------------------------------- profiler
#: where captures land unless told otherwise: ``gofr_tpu_profiles`` under
#: the process's temporary directory (``TMPDIR``)
DEFAULT_PROFILE_DIR = os.path.join(tempfile.gettempdir(),
                                   "gofr_tpu_profiles")

#: the capture running in this process, if any: torch.profiler keeps one
#: device trace per process, so every :class:`ProfilerCapture` shares it
_ACTIVE_CAPTURE: dict = {"dir": None}
_ACTIVE_LOCK = threading.Lock()


def _torch_profiler_running() -> bool:
    """True while some ``torch.profiler`` session runs in this process
    (torch's process-wide flag, set by every profile's start); False when
    this torch has no such flag."""
    from torch.autograd import profiler as autograd_profiler
    return bool(getattr(autograd_profiler, "_is_profiler_enabled", False))


class ProfilerCapture:
    """On-demand ``torch.profiler`` capture with single-flight semantics
    (the counterpart of the JAX package's wrapper of
    ``jax.profiler.start_trace`` / ``stop_trace``): the state machine
    behind ``POST /debug/profile/start`` and ``/debug/profile/stop`` and
    the engine's autoprofiler. A start while a capture runs (this one,
    another instance's, or any ``torch.profiler`` session of the process)
    is refused with ``{"ok": False}``; a stop without a start reports
    cleanly. The trace covers the card's kernels (graph replays
    included) and this process's host ops, and is written as a Chrome
    trace, ``trace.json``, in the capture's directory at stop.

    Every start and stop runs on one owner thread of the instance:
    torch's profiler state is per thread, so a capture started on one
    HTTP request thread must be stopped on the same thread, whichever
    request or timer asks.

    A capture started with ``max_capture_s`` (per start, or the
    constructor's default) is stopped by a daemon timer at that age.
    ``stop(force=True)`` recovers a leaked capture: it stops the
    underlying profiler even when this state machine thinks nothing
    runs, and swallows the stop's error, so the next start works."""

    def __init__(self, base_dir: str | None = None, logger: Any = None,
                 max_capture_s: float = 0.0) -> None:
        self.base_dir = base_dir or DEFAULT_PROFILE_DIR
        self.logger = logger
        #: default auto-stop age of every capture; 0 = unbounded
        self.max_capture_s = max(0.0, float(max_capture_s))
        self._lock = threading.Lock()
        self._active_dir: str | None = None
        self._started_at: float | None = None
        self._timer: threading.Timer | None = None
        self._profile: Any = None
        self._owner: ThreadPoolExecutor | None = None
        self.auto_stops = 0

    def _on_owner(self, fn):
        """Run ``fn`` on the owner thread and return its result."""
        if self._owner is None:
            self._owner = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gofr-profiler")
        return self._owner.submit(fn).result()

    @staticmethod
    def _new_profile():
        """A profile of the card's kernels and the host ops of every
        thread (the engine's, the HTTP handlers'), where this torch can
        record other threads than the one that starts it."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            from torch._C._profiler import _ExperimentalConfig
            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            config = None
        return profile(activities=activities, experimental_config=config)

    def start(self, trace_dir: str | None = None, *,
              max_capture_s: float | None = None) -> dict:
        with self._lock:
            if self._active_dir is not None:
                return {"ok": False, "error": "capture already running",
                        "dir": self._active_dir}
            path = trace_dir or os.path.join(
                self.base_dir, time.strftime("%Y%m%d-%H%M%S")
                + f"-{os.urandom(2).hex()}")
            with _ACTIVE_LOCK:
                if _ACTIVE_CAPTURE["dir"] is not None:
                    return {"ok": False, "error": "capture already running",
                            "dir": _ACTIVE_CAPTURE["dir"]}
                if _torch_profiler_running():
                    return {"ok": False, "error": "a torch.profiler session "
                            "is already running in this process"}
                try:
                    os.makedirs(path, exist_ok=True)
                    prof = self._new_profile()
                    self._on_owner(prof.start)
                except Exception as exc:
                    return {"ok": False,
                            "error": f"{type(exc).__name__}: {exc}"}
                _ACTIVE_CAPTURE["dir"] = path
            self._profile = prof
            self._active_dir = path
            self._started_at = time.time()
            cap = self.max_capture_s if max_capture_s is None \
                else max(0.0, float(max_capture_s))
            if cap > 0:
                self._timer = threading.Timer(cap, self._expire, (path,))
                self._timer.daemon = True
                self._timer.start()
            if self.logger is not None:
                self.logger.info(f"profiler capture started: {path}")
            return {"ok": True, "dir": path}

    def _expire(self, path: str) -> None:
        """The timer's body: stop the capture only if it is still the one
        the timer was armed for."""
        with self._lock:
            if self._active_dir != path:
                return
            self.auto_stops += 1
        result = self.stop()
        if self.logger is not None and result.get("ok"):
            self.logger.warn(
                f"profiler capture auto-stopped at max_capture_s: {path}")

    def _stop_profile(self, prof, path: str | None) -> None:
        """On the owner thread: stop ``prof`` and write its trace."""
        prof.stop()
        if path is not None:
            prof.export_chrome_trace(os.path.join(path, "trace.json"))

    def stop(self, force: bool = False) -> dict:
        with self._lock:
            timer, self._timer = self._timer, None
            if timer is not None:
                timer.cancel()
            if self._active_dir is None:
                if not force:
                    return {"ok": False, "error": "no capture running"}
                # a leaked capture (a failed stop cleared the state while
                # the profile kept running): stop it, so the state
                # machine and torch agree again
                prof, self._profile = self._profile, None
                if prof is not None:
                    try:
                        self._on_owner(prof.stop)
                    except Exception:
                        pass
                with _ACTIVE_LOCK:
                    _ACTIVE_CAPTURE["dir"] = None
                if self.logger is not None:
                    self.logger.warn(
                        "profiler force-stop: recovered a leaked capture")
                return {"ok": True, "recovered": True, "dir": None}
            path, started = self._active_dir, self._started_at
            prof = self._profile
            try:
                self._on_owner(lambda: self._stop_profile(prof, path))
            except Exception as exc:
                self._active_dir = self._started_at = None
                if not force:
                    # the profile stays held as leaked: stop(force=True)
                    # recovers it
                    return {"ok": False, "dir": path,
                            "error": f"{type(exc).__name__}: {exc}"}
                if self.logger is not None:
                    self.logger.warn(f"profiler force-stop swallowed: {exc!r}")
                self._release_locked(path)
                return {"ok": True, "recovered": True, "dir": path,
                        "error": f"{type(exc).__name__}: {exc}"}
            # running until the trace is written
            self._active_dir = self._started_at = None
            self._release_locked(path)
            if self.logger is not None:
                self.logger.info(f"profiler capture stopped: {path}")
            return {"ok": True, "dir": path,
                    "duration_s": round(time.time() - started, 3)
                    if started else None}

    def _release_locked(self, path: str) -> None:
        """Drop the held profile and the process-wide claim on ``path``;
        the caller holds ``self._lock`` (``stop``)."""
        self._profile = None
        with _ACTIVE_LOCK:
            if _ACTIVE_CAPTURE["dir"] == path:
                _ACTIVE_CAPTURE["dir"] = None

    def status(self) -> dict:
        return {"running": self._active_dir is not None,
                "dir": self._active_dir, "auto_stops": self.auto_stops}
