"""The pass-cost observatory: a per-dispatch-signature online cost
model and its drift sentinel (the port's copy of
``gofr_tpu/serving/costmodel.py``, without the anomaly-triggered
profiler).

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

Surfaces: ``GET /debug/costs``, a ``costs`` block in
``/debug/efficiency``, and :meth:`CostModel.by_kind` for a bench.
"""

from __future__ import annotations

from typing import Any

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
