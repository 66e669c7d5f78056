"""The pass-cost observatory: a per-dispatch-signature online cost
model, its drift sentinel and the anomaly-triggered profiler (the port's
copy of ``gofr_tpu/serving/costmodel.py``).

Every dispatch is fingerprinted by its shape signature (the recompile
sentinel's: prefill ``bucket/group``, chunk ``width/G/window``, decode
``window``, verify ``width``, each tagged with a non-default
``kv_dtype``). :class:`CostModel` keeps, per signature, an EWMA and
variance of the pass's duration and its cost per row and per token, fed
at the engine's collect boundaries (``Engine._note_pass_cost``) with the
duration those collects already measured: no device sync, greedy
outputs unchanged.

**Drift sentinel**: after a signature's first ``baseline_passes``
serving observations its baseline (EWMA mean + std) seals; a later EWMA
above ``baseline * drift_ratio`` AND ``baseline + drift_sigma * std``
opens a drift episode. :meth:`CostModel.observe` returns a drift record
exactly once per episode (the engine turns it into one
``obs.cost_drift`` event, one WARN and one ``app_engine_cost_drift{kind}``
bump). Decisions are count-driven compares over observed durations, so
fault-injected runs are deterministic.

**Anomaly-triggered profiling**: :class:`AutoProfiler` starts a bounded
``torch.profiler`` capture (``observability.ProfilerCapture``) when a
drift episode opens, the SLO burns fast or goodput falls under its
floor, and stops it after a pass budget or an age; arms are debounced,
and ``GOFR_AUTOPROF=0`` is the kill switch.

Surfaces: ``GET /debug/costs`` (the table and the autoprofiler's
state), a ``costs`` block in ``/debug/efficiency``, and
:meth:`CostModel.by_kind` for a bench.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

from ..analysis.annotations import hot_path_boundary

#: bounded per-signature table — the shape space is tiny by design
#: (compiled buckets/windows), so hitting this means a recompile storm
#: the RecompileSentinel is already screaming about; overflow durations
#: still land in ``total_s`` so conservation against the goodput
#: meter's busy seconds holds.
MAX_SIGNATURES = 64


class _SigCost:
    """One signature's running cost state — plain host floats."""

    __slots__ = ("kind", "n", "ewma_s", "var_s2", "sum_s", "synthetic_s",
                 "rows", "tokens", "baseline_s", "baseline_std_s",
                 "drifting", "episodes")

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self.n = 0
        self.ewma_s = 0.0
        self.var_s2 = 0.0
        self.sum_s = 0.0
        self.synthetic_s = 0.0
        self.rows = 0
        self.tokens = 0
        self.baseline_s: float | None = None
        self.baseline_std_s = 0.0
        self.drifting = False
        self.episodes = 0


class CostModel:
    """Online per-dispatch-signature cost model + drift sentinel.

    ``observe`` is fed once per collected pass with the same duration
    the goodput ledger bills, so ``total_s - synthetic_s`` conserves
    against ``GoodputMeter.busy_s - waste_s['bubble']`` (bubbles are
    scheduling gaps the meter bills between passes — no pass, so no
    cost observation; ``synthetic_s`` is the cost_skew fault site's
    injected inflation — observed by the model, never slept, so
    bit-identity holds).
    """

    def __init__(self, enabled: bool = True, *, alpha: float = 0.2,
                 baseline_passes: int = 32, drift_ratio: float = 2.0,
                 drift_sigma: float = 6.0,
                 max_signatures: int = MAX_SIGNATURES) -> None:
        self.enabled = bool(enabled)
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self.baseline_passes = max(1, int(baseline_passes))
        self.drift_ratio = max(1.0, float(drift_ratio))
        self.drift_sigma = max(0.0, float(drift_sigma))
        self.max_signatures = max(1, int(max_signatures))
        self._sigs: dict[str, _SigCost] = {}
        self.total_s = 0.0
        self.synthetic_s = 0.0
        self.drift_episodes = 0
        self.overflow = 0

    # ------------------------------------------------------------ writer
    @hot_path_boundary(
        "cost-model fold at the collect boundary: a handful of host "
        "float updates (EWMA/variance/running totals) over the pass "
        "duration the collect already measured; drift decisions are "
        "pure count-driven compares — no clocks, no RNG, no device "
        "reads")
    def observe(self, kind: str, sig: str, dur_s: float, *,
                rows: int = 0, tokens: int = 0,
                skew_s: float = 0.0) -> dict | None:
        """Fold one collected pass into the signature's cost state.

        Returns a drift record exactly once per episode entry (the
        caller emits the event/metric/WARN and arms the profiler),
        None otherwise. ``skew_s`` is synthetic duration inflation from
        the ``cost_skew`` fault site — tracked separately so the
        busy-seconds conservation check can subtract it.
        """
        if not self.enabled:
            return None
        x = float(dur_s) + float(skew_s)
        self.total_s += x
        self.synthetic_s += float(skew_s)
        rec = self._sigs.get(sig)
        if rec is None:
            if len(self._sigs) >= self.max_signatures:
                self.overflow += 1
                return None
            rec = self._sigs[sig] = _SigCost(kind)
        rec.n += 1
        rec.sum_s += x
        rec.synthetic_s += float(skew_s)
        rec.rows += int(rows)
        rec.tokens += int(tokens)
        if rec.n == 1:
            rec.ewma_s = x
        else:
            diff = x - rec.ewma_s
            incr = self.alpha * diff
            rec.ewma_s += incr
            rec.var_s2 = (1.0 - self.alpha) * (rec.var_s2 + diff * incr)
        if rec.baseline_s is None:
            if rec.n >= self.baseline_passes:
                # seal: serving-path observations only (warmup never
                # feeds the model, its timings are compile-laden)
                rec.baseline_s = rec.ewma_s
                rec.baseline_std_s = rec.var_s2 ** 0.5
            return None
        base, std = rec.baseline_s, rec.baseline_std_s
        if rec.drifting:
            # hysteresis: the episode ends at the midpoint threshold,
            # so a cost hovering at the trip point can't flap episodes
            if rec.ewma_s <= base * (1.0 + (self.drift_ratio - 1.0) / 2.0):
                rec.drifting = False
            return None
        if base > 0 and rec.ewma_s > base * self.drift_ratio \
                and rec.ewma_s > base + self.drift_sigma * std:
            rec.drifting = True
            rec.episodes += 1
            self.drift_episodes += 1
            return {"kind": kind, "signature": sig,
                    "ewma_s": round(rec.ewma_s, 6),
                    "baseline_s": round(base, 6),
                    "baseline_std_s": round(std, 6),
                    "ratio": round(rec.ewma_s / base, 3)}
        return None

    def reset(self) -> None:
        """Forget every signature and total (replay runs start clean)."""
        self._sigs.clear()
        self.total_s = 0.0
        self.synthetic_s = 0.0
        self.drift_episodes = 0
        self.overflow = 0

    # ------------------------------------------------------------ readers
    def state(self) -> dict:
        """The ``GET /debug/costs`` block: full per-signature state."""
        sigs = {}
        for sig, rec in self._sigs.items():
            entry: dict[str, Any] = {
                "kind": rec.kind, "n": rec.n,
                "mean_s": round(rec.sum_s / rec.n, 6) if rec.n else 0.0,
                "ewma_s": round(rec.ewma_s, 6),
                "std_s": round(rec.var_s2 ** 0.5, 6),
                "total_s": round(rec.sum_s, 6),
                "drifting": rec.drifting,
                "drift_episodes": rec.episodes,
            }
            if rec.rows:
                entry["us_per_row"] = round(
                    rec.sum_s / rec.rows * 1e6, 3)
            if rec.tokens:
                entry["us_per_token"] = round(
                    rec.sum_s / rec.tokens * 1e6, 3)
            if rec.baseline_s is not None:
                entry["baseline_s"] = round(rec.baseline_s, 6)
                entry["baseline_std_s"] = round(rec.baseline_std_s, 6)
            if rec.synthetic_s:
                entry["synthetic_s"] = round(rec.synthetic_s, 6)
            sigs[sig] = entry
        return {"enabled": self.enabled, "signatures": sigs,
                "total_s": round(self.total_s, 6),
                "synthetic_s": round(self.synthetic_s, 6),
                "drift_episodes": self.drift_episodes,
                "overflow": self.overflow,
                "baseline_passes": self.baseline_passes,
                "drift_ratio": self.drift_ratio,
                "drift_sigma": self.drift_sigma}

    def table(self) -> dict | None:
        """Compact per-signature digest for workload headers: kind, pass
        count, mean seconds, µs per token, drifting. None while empty."""
        if not self.enabled or not self._sigs:
            return None
        out = {}
        for sig, rec in self._sigs.items():
            entry: dict[str, Any] = {"kind": rec.kind, "n": rec.n,
                                     "mean_s": round(rec.sum_s / rec.n, 6)}
            if rec.tokens:
                entry["us_per_token"] = round(
                    rec.sum_s / rec.tokens * 1e6, 3)
            if rec.drifting:
                entry["drifting"] = True
            out[sig] = entry
        return out

    def by_kind(self) -> dict:
        """``{kind: us_per_token}`` aggregate — the bench headline hook
        (report-only ``cost_<kind>_us_per_token`` keys)."""
        busy: dict[str, float] = {}
        toks: dict[str, int] = {}
        for rec in self._sigs.values():
            busy[rec.kind] = busy.get(rec.kind, 0.0) + rec.sum_s
            toks[rec.kind] = toks.get(rec.kind, 0) + rec.tokens
        return {k: round(busy[k] / toks[k] * 1e6, 3)
                for k in busy if toks.get(k)}


# -------------------------------------------------- anomaly profiling
def _autoprof_killed() -> bool:
    """``GOFR_AUTOPROF=0`` kill switch, read at arm time so it can be
    flipped on a live process."""
    return os.environ.get("GOFR_AUTOPROF", "").strip().lower() \
        in ("0", "false", "no", "off")


class AutoProfiler:
    """Single-flight anomaly-triggered profiler controller.

    ``arm(reason, cause)`` starts a bounded ``ProfilerCapture`` when an
    anomaly fires (cost drift, SLO fast burn, goodput-floor breach); the
    capture stops after ``passes`` collected passes (``note_pass``, at
    the engine's collect boundary) or ``max_capture_s`` (checked at
    collect, with the capture's own timer as the idle engine's
    backstop). Arms are debounced (``debounce_s``), refused while a
    capture is in flight, and killed by ``GOFR_AUTOPROF=0``. The finished
    artifact (path + trigger) stays in ``last_artifact`` for
    ``/debug/costs`` and incident bundles."""

    def __init__(self, capture: Any = None, *, enabled: bool = True,
                 passes: int = 64, max_capture_s: float = 30.0,
                 debounce_s: float = 300.0, logger: Any = None,
                 clock=time.time) -> None:
        self.capture = capture
        self.enabled = bool(enabled) and capture is not None
        self.passes = max(1, int(passes))
        self.max_capture_s = max(0.1, float(max_capture_s))
        self.debounce_s = max(0.0, float(debounce_s))
        self.logger = logger
        self.clock = clock
        self._lock = threading.Lock()
        self._armed: dict | None = None
        self._last_arm: float | None = None
        self.captures = 0
        self.debounced = 0
        self.suppressed = 0
        self.last_artifact: dict | None = None

    def arm(self, reason: str, cause: str = "") -> dict | None:
        """Start a capture for an anomaly; returns ``{"dir", "reason"}``
        or None when suppressed (disabled, killed, in flight, debounced,
        or the capture's start refused)."""
        if not self.enabled:
            return None
        if _autoprof_killed():
            with self._lock:
                self.suppressed += 1
            return None
        now = self.clock()
        with self._lock:
            if self._armed is not None:
                self.suppressed += 1
                return None
            if self._last_arm is not None \
                    and now - self._last_arm < self.debounce_s:
                self.debounced += 1
                return None
            res = self.capture.start(max_capture_s=self.max_capture_s)
            if not res.get("ok"):
                self.suppressed += 1
                return None
            self._armed = {"reason": reason, "cause": cause,
                           "dir": res.get("dir"),
                           "remaining": self.passes, "started": now}
            self._last_arm = now
        if self.logger is not None:
            self.logger.warn(
                "anomaly-triggered profiler capture armed",
                reason=reason, cause=cause, dir=res.get("dir"),
                passes=self.passes)
        return {"dir": res.get("dir"), "reason": reason}

    def note_pass(self) -> None:
        """Collect-boundary tick: one attribute check when idle; an armed
        capture counts down and stops on its pass budget or age."""
        armed = self._armed
        if armed is None:
            return
        armed["remaining"] -= 1
        if armed["remaining"] <= 0 \
                or self.clock() - armed["started"] >= self.max_capture_s:
            self.finish()

    def finish(self) -> None:
        """Stop the armed capture now, if any, and keep its artifact (the
        engine calls it when it stops: a process holds one
        ``torch.profiler`` session)."""
        with self._lock:
            armed, self._armed = self._armed, None
            if armed is None:
                return
            res = self.capture.stop()
            # the capture's own timer may have stopped it first: the
            # artifact was still written
            ok = bool(res.get("ok")) \
                or "no capture running" in str(res.get("error", ""))
            self.captures += 1
            self.last_artifact = {
                "dir": armed["dir"], "reason": armed["reason"],
                "cause": armed["cause"],
                "passes": self.passes - max(0, armed["remaining"]),
                "ok": ok,
            }
            if res.get("duration_s") is not None:
                self.last_artifact["duration_s"] = res["duration_s"]
        if self.logger is not None:
            self.logger.info(
                f"anomaly-triggered profiler capture finished: "
                f"{armed['dir']}", reason=armed["reason"], ok=ok)

    def state(self) -> dict:
        armed = self._armed
        return {"enabled": self.enabled,
                "kill_switch": _autoprof_killed(),
                "armed": None if armed is None else {
                    "reason": armed["reason"], "cause": armed["cause"],
                    "dir": armed["dir"],
                    "remaining": armed["remaining"]},
                "captures": self.captures,
                "debounced": self.debounced,
                "suppressed": self.suppressed,
                "last_artifact": self.last_artifact,
                "passes": self.passes,
                "max_capture_s": self.max_capture_s,
                "debounce_s": self.debounce_s}
