"""Deterministic workload replay (the port's copy of
``gofr_tpu/serving/replay.py``): the time machine over the capture
plane.

``WorkloadRecorder`` (serving/observability.py) turns live traffic
into a versioned JSONL workload file; this module drives that file
back through a live :class:`~gofr_tpu_torch.serving.engine.Engine` and
reports what changed. The file format is the JAX package's, so a
workload captured on either package replays on the other:

- **Timing**: requests re-inject with the ORIGINAL inter-arrival
  spacing (scaled by ``speed``), or as a closed loop with a fixed
  number in flight (``closed_loop=N`` — stress mode, timing ignored).
- **Determinism**: greedy requests (temperature 0) replayed through an
  engine built with the same model/config and the captured
  ``engine_seed`` reproduce the recorded completions — sampling is an
  argmax on the card, so nothing host-side can perturb the tokens, as
  long as the replay's passes group the requests as the capture's did
  (another group size may run a GEMM at another row count, and the
  library may pick another algorithm there). Stochastic requests
  reproduce the seed but their generator offset depends on global pass
  scheduling, so they may diverge; the divergence report says exactly
  where (first divergent token per request).
- **Reporting**: per-request divergences (plus the
  ``app_replay_divergence`` counter on the engine's metrics manager),
  recorded-vs-replayed latency percentiles, and the engine's SLO
  tracker state after the run.

Redacted captures (``capture_redact=True``) carry hashes instead of
token ids and are refused here — they are for shipping load *shapes*
off-box, not for reproduction.
"""

from __future__ import annotations

import json
import time
from typing import Any

from .engine import SamplingParams
from .observability import WORKLOAD_FORMAT, WORKLOAD_VERSION

#: divergence entries kept verbatim in the report (the counter still
#: counts them all)
MAX_DIVERGENCES_REPORTED = 32


# ------------------------------------------------------------- loading
def parse_workload(text: str) -> dict:
    """JSONL text -> ``{"header": ..., "records": [...]}``; validates
    the format/version contract before anything is replayed."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty workload file")
    try:
        header = json.loads(lines[0])
    except ValueError as exc:
        raise ValueError(f"workload header is not JSON: {exc}") from exc
    if not isinstance(header, dict) \
            or header.get("format") != WORKLOAD_FORMAT:
        raise ValueError(
            f"not a {WORKLOAD_FORMAT} file (header: {str(header)[:80]})")
    if header.get("version") != WORKLOAD_VERSION:
        raise ValueError(
            f"unsupported workload version {header.get('version')!r} "
            f"(this build reads version {WORKLOAD_VERSION})")
    records = []
    for i, line in enumerate(lines[1:], start=2):
        try:
            rec = json.loads(line)
        except ValueError as exc:
            raise ValueError(f"workload line {i} is not JSON: "
                             f"{exc}") from exc
        if not isinstance(rec, dict) or "t" not in rec:
            raise ValueError(f"workload line {i} is not a request record")
        records.append(rec)
    return {"header": header, "records": records}


def load_workload(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return parse_workload(f.read())


def _params_from(rec: dict) -> SamplingParams:
    p = rec.get("params") or {}
    return SamplingParams(
        temperature=float(p.get("temperature", 0.0)),
        top_p=float(p.get("top_p", 1.0)),
        top_k=int(p.get("top_k", 0)),
        max_new_tokens=int(p.get("max_new_tokens", 128)))


def _pct(values: list, p: float) -> float | None:
    if not values:
        return None
    values = sorted(values)
    return round(values[min(len(values) - 1, int(p * len(values)))], 3)


def _latency_summary(ttfts: list, tpots: list, e2es: list) -> dict:
    return {"p50_ttft_ms": _pct(ttfts, 0.50),
            "p95_ttft_ms": _pct(ttfts, 0.95),
            "p50_tpot_ms": _pct(tpots, 0.50),
            "p95_tpot_ms": _pct(tpots, 0.95),
            "p50_e2e_ms": _pct(e2es, 0.50),
            "p95_e2e_ms": _pct(e2es, 0.95)}


def _first_divergence(recorded: list, replayed: list) -> int:
    """Index of the first token where the streams differ; when one is
    a strict prefix of the other, the index just past the prefix."""
    for i, (a, b) in enumerate(zip(recorded, replayed)):
        if a != b:
            return i
    return min(len(recorded), len(replayed))


# ------------------------------------------------ efficiency divergence
def _waste_shares(goodput: dict | None) -> dict:
    """Waste per cause as a FRACTION of busy time — the scale-free
    form two runs of different lengths can be compared in."""
    if not isinstance(goodput, dict):
        return {}
    busy = float(goodput.get("busy_s") or 0.0)
    if busy <= 0:
        return {}
    return {cause: float(v or 0.0) / busy
            for cause, v in (goodput.get("waste_s") or {}).items()}


def efficiency_divergence(recorded: dict | None,
                          replayed: dict | None) -> list[dict]:
    """Waste causes whose replayed share of busy device time
    materially exceeds the capture's (more than doubled, past a 2%
    absolute floor). A replay that matches every token but doubles
    ``preempt_recompute`` is a scheduler regression the token diff
    cannot see — this names it."""
    rec, rep = _waste_shares(recorded), _waste_shares(replayed)
    if not rec or not rep:
        return []
    out = []
    for cause in sorted(set(rec) | set(rep)):
        a, b = rec.get(cause, 0.0), rep.get(cause, 0.0)
        if b > 2.0 * a + 0.02:
            out.append({"cause": cause,
                        "recorded_share": round(a, 4),
                        "replayed_share": round(b, 4)})
    return out


def cost_divergence(recorded: dict | None, replayed: dict | None, *,
                    ratio: float = 2.0,
                    floor_s: float = 0.0005) -> list[dict]:
    """Dispatch signatures whose replayed mean pass cost materially
    exceeds the capture's (more than ``ratio`` times, past an absolute
    ``floor_s`` so µs-scale jitter on tiny passes never flags). The
    per-signature twin of :func:`efficiency_divergence`: a replay that
    matches every token but doubles the cost of ``decode/2048`` is a
    kernel regression with a name, not a diffuse slowdown. Advisory
    only — purely report, never a gate."""
    if not isinstance(recorded, dict) or not isinstance(replayed, dict):
        return []
    out = []
    for sig in sorted(set(recorded) & set(replayed)):
        rec, rep = recorded.get(sig), replayed.get(sig)
        if not isinstance(rec, dict) or not isinstance(rep, dict):
            continue
        a = float(rec.get("mean_s") or 0.0)
        b = float(rep.get("mean_s") or 0.0)
        if a > 0 and b > ratio * a + floor_s:
            out.append({"signature": sig,
                        "kind": rep.get("kind") or rec.get("kind"),
                        "recorded_mean_s": round(a, 6),
                        "replayed_mean_s": round(b, 6),
                        "ratio": round(b / a, 3)})
    return out


# -------------------------------------------------------------- replay
def load_events(path: str) -> dict:
    """Load a ``GET /debug/events`` capture (gofr-events JSONL) for
    the replay event-timeline diff: ``{"header", "events"}``."""
    from .events import parse_events
    with open(path) as f:
        header, events = parse_events(f.read())
    return {"header": header, "events": events}


def replay_workload(engine: Any, workload: dict, *, speed: float = 1.0,
                    closed_loop: int = 0,
                    timeout_s: float = 300.0,
                    events: dict | None = None) -> dict:
    """Re-inject a parsed workload through ``engine`` and return the
    divergence + latency report. The engine is started if it is not
    running (and left running — the caller owns its lifecycle).

    ``speed`` scales the recorded inter-arrival gaps (2.0 = twice as
    fast); ``closed_loop=N`` ignores timing entirely and keeps N
    requests in flight — the stress mode for saturation testing.

    ``events`` is an optional :func:`load_events` capture recorded
    alongside the workload (``GET /debug/events``); when given, the
    report gains an ``event_divergence`` block comparing the capture's
    event timeline against the events this replay emitted — a replay
    that matches every token but restarts twice or sheds load is a
    behavioral divergence the token diff cannot see.
    """
    header = workload.get("header") or {}
    records = workload.get("records") or []
    if header.get("redacted"):
        raise ValueError(
            "redacted workload: token ids were captured as salted "
            "hashes, so it cannot be re-injected (capture with "
            "capture_redact=False for replayable workloads)")
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    records = sorted(records, key=lambda r: r.get("t", 0.0))
    playable = [r for r in records if r.get("prompt_tokens")]
    goodput = getattr(engine, "goodput", None)
    if goodput is not None and getattr(goodput, "enabled", False):
        # a clean meter for this replay: the report compares the
        # replay's OWN waste breakdown against the capture's
        goodput.reset()
    costs = getattr(engine, "costs", None)
    if costs is not None and getattr(costs, "enabled", False):
        # same deal for the cost observatory: the per-signature table
        # in the report is this replay's, not the engine's lifetime
        costs.reset()
    # seq watermark: only events emitted DURING this replay count
    # toward the event-timeline diff
    ledger = getattr(engine, "events", None)
    events_seq0 = ledger.state()["seq"] \
        if ledger is not None and getattr(ledger, "enabled", False) else 0
    if not getattr(engine, "_running", False):
        engine.start()

    pairs: list = []
    wall0 = time.perf_counter()
    if closed_loop > 0:
        cap = max(1, int(closed_loop))
        for rec in playable:
            while sum(1 for _, q in pairs
                      if q.finished_at is None and q.error is None) >= cap:
                if time.perf_counter() - wall0 > timeout_s:
                    raise TimeoutError("closed-loop replay stalled")
                time.sleep(0.001)
            pairs.append((rec, engine.submit(
                rec["prompt_tokens"], _params_from(rec),
                tenant=rec.get("tenant"))))
    else:
        base = playable[0]["t"] if playable else 0.0
        for rec in playable:
            target = wall0 + (rec["t"] - base) / speed
            wait = target - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            pairs.append((rec, engine.submit(
                rec["prompt_tokens"], _params_from(rec),
                tenant=rec.get("tenant"))))

    deadline = time.perf_counter() + timeout_s
    while any(q.finished_at is None and q.error is None
              for _, q in pairs):
        if time.perf_counter() > deadline:
            raise TimeoutError(
                f"replay did not finish within {timeout_s}s")
        time.sleep(0.002)
    wall_s = time.perf_counter() - wall0

    # ------------------------------------------------------ divergence
    divergences: list = []
    digest_divergences: list = []
    compared = replay_errors = 0
    for idx, (rec, req) in enumerate(pairs):
        if rec.get("status") != "ok":
            continue  # the recorded run itself failed/cancelled here
        if req.error is not None:
            replay_errors += 1
            divergences.append({"index": idx, "kind": "replay_error",
                                "error": str(req.error)[:200]})
            continue
        compared += 1
        recorded = rec.get("completion_tokens") or []
        replayed = list(req.generated)
        if recorded != replayed:
            divergences.append({
                "index": idx, "kind": "token",
                "first_divergent_token": _first_divergence(recorded,
                                                           replayed),
                "recorded_len": len(recorded),
                "replayed_len": len(replayed)})
        # fingerprint twin of the token diff: the integrity plane
        # stamps a digest on both the capture and the replayed
        # request (serving/integrity.py). A digest mismatch with
        # MATCHING tokens means the fingerprint inputs drifted
        # (params quantization, digest version) — worth naming, since
        # golden probes sealed from the capture would now misfire.
        # Advisory only, never a gate.
        rec_digest = rec.get("digest")
        rep_digest = getattr(req, "digest", None)
        if rec_digest and rep_digest and rec_digest != rep_digest:
            digest_divergences.append({
                "index": idx, "recorded": rec_digest,
                "replayed": rep_digest,
                "tokens_match": recorded == replayed})
    metrics = getattr(engine, "metrics", None)
    if metrics is not None and divergences:
        if metrics.get("app_replay_divergence") is None:
            metrics.new_counter(
                "app_replay_divergence",
                "replayed requests whose token stream diverged from "
                "the recorded completion")
        metrics.add_counter("app_replay_divergence",
                            float(len(divergences)))

    # --------------------------------------------------------- latency
    rec_lat = _latency_summary(
        [r["ttft_ms"] for r in playable if r.get("ttft_ms") is not None],
        [r["tpot_ms"] for r in playable if r.get("tpot_ms") is not None],
        [r["e2e_ms"] for r in playable if r.get("e2e_ms") is not None])
    ttfts, tpots, e2es = [], [], []
    for _, req in pairs:
        if req.ttft_ms is not None:
            ttfts.append(req.ttft_ms)
        end = req.finished_at
        if end is not None:
            e2es.append((end - req.submitted_at) * 1000.0)
            n = len(req.generated)
            if req.first_token_at is not None and n > 1:
                tpots.append((end - req.first_token_at) * 1000.0
                             / (n - 1))
    slo = getattr(engine, "slo", None)
    recorded_goodput = header.get("goodput")
    replayed_goodput = goodput.summary() if goodput is not None \
        and getattr(goodput, "enabled", False) else None
    recorded_costs = header.get("costs")
    replayed_costs = costs.table() if costs is not None \
        and getattr(costs, "enabled", False) else None
    event_divergence = None
    if events is not None:
        from .events import event_timeline_diff
        replayed_events = [
            e for e in (ledger.snapshot() if ledger is not None
                        and getattr(ledger, "enabled", False) else [])
            if e.get("seq", 0) > events_seq0]
        event_divergence = event_timeline_diff(
            events.get("events") or [], replayed_events)
    return {
        "requests": len(records),
        "submitted": len(pairs),
        "skipped": len(records) - len(playable),
        "compared": compared,
        "divergent": len(divergences),
        "bit_identical": compared > 0 and not divergences,
        "divergences": divergences[:MAX_DIVERGENCES_REPORTED],
        "replay_errors": replay_errors,
        "mode": f"closed-loop-{closed_loop}" if closed_loop > 0
                else f"open-loop-x{speed:g}",
        "wall_s": round(wall_s, 3),
        "recorded_latency": rec_lat,
        "replayed_latency": _latency_summary(ttfts, tpots, e2es),
        # efficiency twin of the token diff: same tokens with a
        # doubled waste share is still a regression, and it has a name
        "recorded_goodput": recorded_goodput,
        "replayed_goodput": replayed_goodput,
        "efficiency_divergence": efficiency_divergence(
            recorded_goodput, replayed_goodput),
        # per-signature twin: same tokens, same waste shares, but one
        # kernel's pass cost doubled — the advisory names the signature
        "recorded_costs": recorded_costs,
        "replayed_costs": replayed_costs,
        "cost_divergence": cost_divergence(recorded_costs,
                                           replayed_costs),
        # fingerprint twin: recorded vs replayed output digests
        # (integrity plane); advisory, bounded like the token diff
        "digest_divergence":
            digest_divergences[:MAX_DIVERGENCES_REPORTED],
        # behavioral twin: the flight recorder's event timeline
        # (restarts, sheds, preemptions) compared kind-for-kind
        "event_divergence": event_divergence,
        "slo": slo.state() if slo is not None else None,
    }


def replay_file(engine: Any, path: str, **kw) -> dict:
    """Convenience: :func:`load_workload` + :func:`replay_workload`."""
    return replay_workload(engine, load_workload(path), **kw)


__all__ = ["parse_workload", "load_workload", "load_events",
           "replay_workload", "replay_file", "efficiency_divergence",
           "cost_divergence", "MAX_DIVERGENCES_REPORTED"]
