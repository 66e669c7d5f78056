"""The output-integrity observatory, engine side (the port's copy of
``gofr_tpu/serving/integrity.py``: the same digest recipe,
``DIGEST_VERSION`` and golden-set file, so digests compare across the
packages).

- **Output fingerprinting**: :func:`request_digest` folds every retired
  request into a blake2b-128 digest over the prompt token ids, a
  coarsely quantized sampling-parameter summary and the emitted token
  ids (plus a quantized top-k logprob summary, empty today: logits never
  cross to the host). The engine stamps it into ``GenRequest.digest``
  and the flight recorder's request log at retire
  (``Engine._note_integrity``).
- **Golden canary probes**: :class:`GoldenSet` is a small set of
  (prompt, expected greedy digest) pairs in a versioned JSONL file.
  :class:`IntegrityPlane` replays them through the engine on the
  scheduler's background lane at a pass-count cadence (never the wall
  clock); probe device time is re-priced to the ``integrity_probe``
  waste cause of the goodput ledger. A digest mismatch opens an episode
  once (one WARN, one ``obs.integrity`` warn event, one
  ``app_engine_integrity_failures{kind="probe_mismatch"}`` bump); the
  episode re-arms after ``rearm_probes`` consecutive clean probes.
- :meth:`IntegrityPlane.summary` is the compact digest block a fleet
  vote would read; the port has no fleet yet.

All of it is host arithmetic at the retire and collect boundaries: no
device sync.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Any

from ..analysis.annotations import hot_path_boundary

#: digest recipe version — bumped when the fold's byte layout changes,
#: so a fleet mid-rollout never votes v1 digests against v2 digests
DIGEST_VERSION = 1

#: golden-set file header contract, mirroring WORKLOAD_FORMAT/VERSION
GOLDEN_FORMAT = "gofr-golden"
GOLDEN_VERSION = 1

#: quantization step for the (future) top-k logprob summary: logprobs
#: are rounded to this grid before folding so benign ULP-level numeric
#: jitter between identical hosts cannot fragment the vote, while a
#: genuinely drifted dequant path still lands in a different bucket
LOGPROB_QUANT = 0.25


def quantize_logprobs(logprobs) -> tuple:
    """Coarsely quantize a top-k logprob summary for digest folding.
    The forward-compatible hook for models that surface per-token
    logprobs: today's serving graphs return only sampled token ids
    (the zero-h2d invariant keeps full logits on device), so callers
    pass ``()`` and the digest covers token ids alone."""
    return tuple(int(round(float(lp) / LOGPROB_QUANT))
                 for lp in (logprobs or ()))


def _quantized_params(params: Any) -> tuple:
    """The sampling-parameter summary folded into the digest — coarse
    1e-4 grids so a cosmetic float round-trip (JSON replay) maps to
    the same digest while any semantically different temperature/top_p
    does not."""
    return (int(round(float(getattr(params, "temperature", 0.0)) * 1e4)),
            int(round(float(getattr(params, "top_p", 1.0)) * 1e4)),
            int(getattr(params, "top_k", 0) or 0),
            int(getattr(params, "max_new_tokens", 0) or 0))


def request_digest(prompt_tokens, params: Any, token_ids, *,
                   logprobs=()) -> str:
    """The output fingerprint: blake2b-128 over (digest version,
    prompt token ids, quantized sampling params, emitted token ids,
    quantized top-k logprob summary). Pure host byte-packing — cheap
    enough to fold every retired request."""
    h = hashlib.blake2b(digest_size=16)
    h.update(struct.pack("<II", DIGEST_VERSION, len(prompt_tokens)))
    h.update(b"".join(struct.pack("<i", int(t)) for t in prompt_tokens))
    h.update(struct.pack("<iiii", *_quantized_params(params)))
    h.update(struct.pack("<I", len(token_ids)))
    h.update(b"".join(struct.pack("<i", int(t)) for t in token_ids))
    q = quantize_logprobs(logprobs)
    h.update(struct.pack("<I", len(q)))
    h.update(b"".join(struct.pack("<i", v) for v in q))
    return h.hexdigest()


# ------------------------------------------------------- golden corpus
class GoldenEntry:
    """One sealed canary: a greedy prompt, the full sampling params it
    was recorded with (the digest folds them, so the probe must replay
    them verbatim), and the digest its replay must reproduce
    bit-for-bit."""

    __slots__ = ("id", "prompt_tokens", "params", "digest")

    def __init__(self, id: str, prompt_tokens: list[int],
                 params: dict, digest: str) -> None:
        self.id = str(id)
        self.prompt_tokens = [int(t) for t in prompt_tokens]
        self.params = {"temperature": float(params.get("temperature", 0.0)),
                       "top_p": float(params.get("top_p", 1.0)),
                       "top_k": int(params.get("top_k", 0)),
                       "max_new_tokens":
                           max(1, int(params.get("max_new_tokens", 16)))}
        self.digest = str(digest)

    def to_dict(self) -> dict:
        return {"id": self.id, "prompt_tokens": self.prompt_tokens,
                "params": self.params, "digest": self.digest}


class GoldenSet:
    """A versioned golden canary corpus: JSONL with a header line
    (the ``gofr-workload`` compatibility pattern) followed by one
    :class:`GoldenEntry` per line. Sealed from replay-corpus records
    (:meth:`seal`) or loaded from disk (:meth:`load`); an unknown
    format/version fails loudly — probing against the wrong corpus
    would alarm on every probe or, worse, on none."""

    def __init__(self, entries=()) -> None:
        self.entries: list[GoldenEntry] = list(entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:
        return bool(self.entries)

    @classmethod
    def seal(cls, records, *, limit: int = 8) -> "GoldenSet":
        """Seal canaries from workload-capture records (the dict shape
        ``WorkloadRecorder.record`` writes): only greedy
        (temperature == 0) records carrying a recorded digest qualify
        — a sampled stream or an unfingerprinted record cannot anchor
        a bit-identity probe. Deterministic: first ``limit`` qualifying
        records in corpus order, ids derived from the digest."""
        entries = []
        for rec in records:
            if len(entries) >= max(1, int(limit)):
                break
            params = rec.get("params") or {}
            if float(params.get("temperature", 0.0)) != 0.0:
                continue
            digest = rec.get("digest")
            prompt = rec.get("prompt_tokens")
            if not digest or not isinstance(prompt, list) or not prompt:
                continue
            entries.append(GoldenEntry(
                id=f"g{len(entries):03d}-{str(digest)[:8]}",
                prompt_tokens=prompt, params=params,
                digest=str(digest)))
        return cls(entries)

    # --------------------------------------------------------- file io
    def header(self) -> dict:
        return {"format": GOLDEN_FORMAT, "version": GOLDEN_VERSION,
                "digest_version": DIGEST_VERSION,
                "count": len(self.entries)}

    def to_jsonl(self) -> str:
        lines = [json.dumps(self.header(), sort_keys=True)]
        lines += [json.dumps(e.to_dict(), sort_keys=True)
                  for e in self.entries]
        return "\n".join(lines) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def load(cls, path: str, *, limit: int | None = None) -> "GoldenSet":
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            raise ValueError(f"golden set {path!r} is empty")
        header = json.loads(lines[0])
        if header.get("format") != GOLDEN_FORMAT:
            raise ValueError(
                f"golden set {path!r}: format "
                f"{header.get('format')!r} != {GOLDEN_FORMAT!r}")
        if int(header.get("version", -1)) > GOLDEN_VERSION:
            raise ValueError(
                f"golden set {path!r}: version {header.get('version')} "
                f"is newer than supported {GOLDEN_VERSION}")
        if int(header.get("digest_version", DIGEST_VERSION)) \
                != DIGEST_VERSION:
            raise ValueError(
                f"golden set {path!r}: digest_version "
                f"{header.get('digest_version')} != {DIGEST_VERSION} — "
                "reseal the corpus on this build")
        entries = []
        for ln in lines[1:]:
            rec = json.loads(ln)
            entries.append(GoldenEntry(
                id=rec["id"], prompt_tokens=rec["prompt_tokens"],
                params=rec.get("params") or {}, digest=rec["digest"]))
            if limit is not None and len(entries) >= limit:
                break
        return cls(entries)


# ----------------------------------------------------- engine-side plane
class IntegrityPlane:
    """The engine-side correctness plane: digest folding, probe
    cadence, mismatch episodes, and the heartbeat digest block.

    Single-writer discipline (the engine thread feeds every writer at
    collect/retire boundaries; readers copy plain dicts under the
    GIL), mirroring the FlightRecorder and CostModel. Probe cadence is
    invocation-count-driven (:meth:`note_pass` counts collected
    passes), never wall clock, so probe schedules replay
    deterministically."""

    def __init__(self, enabled: bool = True, *,
                 golden: GoldenSet | None = None,
                 probe_passes: int = 0,
                 rearm_probes: int = 2) -> None:
        self.enabled = bool(enabled)
        self.golden = golden if golden else None
        self.probe_passes = max(0, int(probe_passes))
        self.rearm_probes = max(1, int(rearm_probes))
        #: collected passes since the last probe launch
        self._since_probe = 0
        #: round-robin cursor over the golden entries
        self._next_idx = 0
        #: probes currently submitted but not yet retired — cadence
        #: skips while one is in flight so a stalled engine can't
        #: stack canaries into its own backlog
        self.inflight = 0
        #: monotone probe sequence — rides the heartbeat summary so
        #: the leader can tell a NEW probe observation from a repeat
        self.seq = 0
        self.folded = 0
        self.probes = {"run": 0, "ok": 0, "mismatch": 0, "error": 0}
        #: per-golden-id latest local result: {digest, expected, ok}
        self.last: dict[str, dict] = {}
        #: mismatch-episode latch (hysteresis twin of the cost-drift
        #: sentinel): one episode record per trip, re-armed after
        #: ``rearm_probes`` consecutive clean probes
        self.episode = False
        self.episodes = 0
        self._clean_streak = 0
        #: total device seconds re-priced to the integrity_probe cause
        self.probe_device_s = 0.0

    # ------------------------------------------------------------ folds
    @hot_path_boundary(
        "digest fold at the retire boundary: one blake2b over token ids"
        " the collects already emitted plus a handful of host dict "
        "updates for probe results — runs once per request, never per "
        "pass; the purity walk stops here by design")
    def fold(self, req: Any) -> str:
        """Fingerprint one retired request (stamps ``req.digest``) and,
        when the request is a golden probe, compare against the sealed
        expectation. Returns a mismatch record exactly once per
        episode; ``None`` otherwise."""
        digest = request_digest(req.prompt_tokens, req.params,
                                req.generated)
        req.digest = digest
        self.folded += 1
        if not req.probe:
            return None
        self.inflight = max(0, self.inflight - 1)
        self.seq += 1
        if req.error is not None or req.cancelled:
            # a refused/failed probe proves nothing about correctness
            # (drain window, queue_full) — count it, don't judge it
            self.probes["error"] += 1
            return None
        self.probes["run"] += 1
        ok = digest == req.probe_expected
        self.last[req.probe] = {"digest": digest,
                                "expected": req.probe_expected,
                                "ok": ok, "seq": self.seq}
        if ok:
            self.probes["ok"] += 1
            if self.episode:
                self._clean_streak += 1
                if self._clean_streak >= self.rearm_probes:
                    # hysteresis re-arm: enough consecutive clean
                    # probes close the episode; the next mismatch
                    # opens (and alarms) a fresh one
                    self.episode = False
                    self._clean_streak = 0
            return None
        self.probes["mismatch"] += 1
        self._clean_streak = 0
        if self.episode:
            return None  # already alarmed this episode
        self.episode = True
        self.episodes += 1
        return {"golden_id": req.probe, "digest": digest,
                "expected": req.probe_expected,
                "episode": self.episodes}

    def note_pass(self):
        """Pass-count probe cadence, called once per collected pass
        (from ``Engine._note_pass_cost``, already a boundary): returns
        the :class:`GoldenEntry` to probe when the cadence fires and
        no probe is in flight, else ``None``. One int compare when
        probing is off."""
        if not self.probe_passes or self.golden is None:
            return None
        self._since_probe += 1
        if self._since_probe < self.probe_passes or self.inflight:
            return None
        self._since_probe = 0
        entry = self.golden.entries[self._next_idx % len(self.golden)]
        self._next_idx += 1
        self.inflight += 1
        return entry

    def probe_aborted(self) -> None:
        """A probe launch failed before submission reached the queue —
        release the in-flight latch so the cadence keeps breathing."""
        self.inflight = max(0, self.inflight - 1)

    # ----------------------------------------------------------- readers
    def summary(self) -> dict | None:
        """The heartbeat digest block (``FlightRecorder.
        integrity_source``): per-golden-probe digests + the probe
        sequence, the leader's voting input. Compact by construction —
        the golden set is small and bounded."""
        if not self.enabled:
            return None
        out: dict = {"digest_version": DIGEST_VERSION, "seq": self.seq,
                     "folded": self.folded,
                     "probes": dict(self.probes)}
        if self.last:
            out["probe_digests"] = {gid: rec["digest"]
                                    for gid, rec in self.last.items()}
            out["probe_ok"] = all(rec["ok"] for rec in self.last.values())
        return out

    def state(self) -> dict:
        """The full ``GET /debug/integrity`` payload (also an
        incident-bundle source)."""
        return {
            "enabled": self.enabled,
            "digest_version": DIGEST_VERSION,
            "folded": self.folded,
            "golden": ({"count": len(self.golden),
                        "ids": [e.id for e in self.golden.entries]}
                       if self.golden else None),
            "probe_passes": self.probe_passes,
            "rearm_probes": self.rearm_probes,
            "probes": dict(self.probes),
            "inflight": self.inflight,
            "seq": self.seq,
            "last": {gid: dict(rec) for gid, rec in self.last.items()},
            "episode": self.episode,
            "episodes": self.episodes,
            "probe_device_s": round(self.probe_device_s, 6),
        }


__all__ = ["DIGEST_VERSION", "GOLDEN_FORMAT", "GOLDEN_VERSION",
           "GoldenEntry", "GoldenSet", "IntegrityPlane",
           "quantize_logprobs", "request_digest"]
