"""The port's incident bundles (``serving/events.py``: ``IncidentDetector``,
``event_timeline_diff``) against the JAX package's, on the CPU.

The detectors see the same event sequences under the same clock:
reasons, debounce, the bundle's shape, the pre-trigger timeline, sealing
with the post-trigger half on the first read after the window, spool
eviction and the on-disk mirror, ``list`` / ``get`` / ``state``. The
timeline diff answers alike on equal, reordered, missing, extra and
truncated timelines. Then the engine's triggers: a cost drift and a
golden-probe mismatch each open one bundle with the engine's state
blocks, and the app's ``GET /debug/incidents`` lists them and answers
``?id=`` (404 for an unknown id).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from gofr_tpu.serving import events as jax_events
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.serving import events as port_events
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.integrity import GoldenSet, request_digest

torch.set_num_threads(2)


class Clock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _pair(tmp_path=None, **cfg):
    """A JAX and a port (ledger, detector) on one shared clock."""
    clock = Clock()
    out = []
    for mod, sub in ((jax_events, "jax"), (port_events, "port")):
        kw = dict(cfg)
        if tmp_path is not None:
            kw["spool_dir"] = str(tmp_path / sub)
        config = mod.EventLedgerConfig(**kw)
        ledger = mod.EventLedger(config, host="h1", clock=clock)
        det = mod.IncidentDetector(config, ledger=ledger, host="h1",
                                   clock=clock)
        det.sources["config"] = lambda: {"max_batch": 8}
        det.sources["broken"] = lambda: 1 / 0
        out.append((ledger, det))
    return clock, out


def _strip(bundle: dict) -> dict:
    """A bundle without what differs by package: the git identity and
    the fleet-only ledger fields."""
    return {k: v for k, v in bundle.items() if k not in ("git", "ledger")}


def _emit_both(pairs, kind, **kw):
    for ledger, _ in pairs:
        ledger.emit(kind, **kw)


def test_unknown_reasons_are_refused_alike():
    _, pairs = _pair()
    for _, det in pairs:
        with pytest.raises(ValueError, match="unknown incident reason"):
            det.trigger("not_a_reason")
    assert port_events.IncidentDetector.REASONS == \
        jax_events.IncidentDetector.REASONS


@pytest.mark.parametrize("reason", ["restart_budget", "cost_drift",
                                    "integrity", "fast_burn"])
def test_a_bundle_opens_seals_and_reads_like_jax(reason):
    clock, pairs = _pair(incident_window_s=10.0, incident_debounce_s=5.0)
    _emit_both(pairs, "engine.restart", severity="error", cause="boom")
    clock.t += 1
    _emit_both(pairs, "fault.trip", cause="pass_raise")
    clock.t += 1
    metas = [det.trigger(reason, cause="why", attrs={"k": 1})
             for _, det in pairs]
    assert metas[0] == metas[1]
    assert metas[1]["id"] == f"h1-0001-{reason}" and not metas[1]["sealed"]
    # debounced within the window, counted
    clock.t += 2
    assert [det.trigger(reason) for _, det in pairs] == [None, None]
    assert pairs[0][1].debounced == pairs[1][1].debounced == {reason: 1}
    # after-trigger events join the bundle at the next read, sealed once
    # the window has passed
    _emit_both(pairs, "engine.recovery", cause="back")
    clock.t += 3
    partial = [_strip(det.get(metas[1]["id"])) for _, det in pairs]
    assert partial[0] == partial[1] and not partial[1]["sealed"]
    clock.t += 20
    _emit_both(pairs, "engine.crash", severity="error", cause="late")
    got = [_strip(det.get(metas[1]["id"])) for _, det in pairs]
    assert got[0] == got[1]
    assert got[1]["sealed"]
    assert [e["kind"] for e in got[1]["timeline"]] == [
        "engine.restart", "fault.trip", "incident.open", "engine.recovery"]
    assert got[1]["state"]["config"] == {"max_batch": 8}
    assert got[1]["state"]["broken"]["error"].startswith("ZeroDivisionError")
    assert [det.list() for _, det in pairs][0] == pairs[1][1].list()
    states = [det.state() for _, det in pairs]
    assert states[0] == states[1]


def test_the_spool_keeps_the_newest_and_mirrors_them(tmp_path):
    clock, pairs = _pair(tmp_path, spool_max=2, incident_debounce_s=0.0,
                         incident_window_s=0.0)
    for i, reason in enumerate(("cost_drift", "integrity", "fast_burn")):
        clock.t += 1
        for _, det in pairs:
            det.trigger(reason, cause=f"n{i}")
    ids = [[m["id"] for m in det.list()] for _, det in pairs]
    assert ids[0] == ids[1] == ["h1-0002-integrity", "h1-0003-fast_burn"]
    for sub, (_, det) in zip(("jax", "port"), pairs):
        files = sorted(p.name for p in (tmp_path / sub).iterdir())
        assert files == ["incident-h1-0002-integrity.json",
                         "incident-h1-0003-fast_burn.json"]
        on_disk = json.loads((tmp_path / sub / files[0]).read_text())
        assert on_disk["sealed"] and on_disk["cause"] == "n1"
    assert pairs[1][1].get("h1-0001-cost_drift") is None


TIMELINES = {
    "equal": (["a", "b", "c"], ["a", "b", "c"]),
    "reordered": (["a", "b", "c"], ["a", "c", "b"]),
    "missing": (["a", "b", "c"], ["a", "c"]),
    "extra": (["a", "c"], ["a", "b", "c"]),
    "truncated": (["a", "b", "b"], ["a", "b"]),
    "empty": ([], ["a"]),
}


@pytest.mark.parametrize("case", sorted(TIMELINES))
def test_event_timeline_diff_matches_jax(case):
    rec, rep = ([{"kind": k, "ts": float(i)} for i, k in enumerate(kinds)]
                for kinds in TIMELINES[case])
    got = port_events.event_timeline_diff(rec, rep)
    assert got == jax_events.event_timeline_diff(rec, rep)
    assert got["diverged"] == (case != "equal")


def test_git_digest_names_this_checkout():
    digest = port_events._git_digest()
    assert set(digest) == {"commit", "ref"}
    assert digest == jax_events._git_digest() or digest["commit"] is None


# ------------------------------------------------------- engine triggers
COMMON = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefill_batch=4, prefill_buckets=(16,))
PROMPTS = [[(7 * i + 3) % 256 for i in range(n)] for n in (5, 12, 30)]


def _engine(**kw):
    cfg = LlamaConfig.tiny().scaled(vocab_size=260)
    return llama_engine(
        llama_init(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
        EngineConfig(**{**COMMON, **kw}), device="cpu")


def _run(engine, prompts=PROMPTS, until=None, n_new=9):
    params = SamplingParams(temperature=0.0, max_new_tokens=n_new)
    reqs = [engine.submit(p, params) for p in prompts]
    engine.start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline and (
                any(r.finished_at is None for r in reqs)
                or (until is not None and not until(engine))):
            if until is not None and all(r.finished_at for r in reqs) \
                    and not engine.integrity.inflight:
                reqs.append(engine.submit(prompts[0], params))
            time.sleep(0.005)
    finally:
        engine.stop()
    return reqs


def test_a_cost_drift_opens_one_bundle_with_the_engine_state():
    engine = _engine(cost_baseline_passes=2, autoprof=False,
                     faults="cost_skew:request=decode/0,at=4,seconds=10.0")
    _run(engine, n_new=32)
    [meta] = engine.incidents.list()
    bundle = engine.incidents.get(meta["id"])
    assert bundle["reason"] == "cost_drift"
    assert bundle["cause"] == "pass cost drift: decode/0"
    assert bundle["attrs"]["autoprof_dir"] is None       # autoprof off
    assert sorted(bundle["state"]) == sorted(
        ["slo", "scheduler", "goodput", "watermarks", "recorder",
         "config", "costs", "integrity"])
    assert bundle["state"]["config"]["cost_baseline_passes"] == 2
    assert bundle["state"]["costs"]["costs"]["drift_episodes"] == 1
    assert "obs.cost_drift" in [e["kind"] for e in bundle["timeline"]]
    json.dumps(bundle)                                  # serialisable


def test_a_probe_mismatch_opens_an_integrity_bundle(tmp_path):
    clean = _engine()
    reqs = _run(clean, prompts=PROMPTS[:2])
    records = [{"prompt_tokens": r.prompt_tokens,
                "params": {"temperature": 0.0, "top_p": 1.0, "top_k": 0,
                           "max_new_tokens": 9},
                "digest": request_digest(r.prompt_tokens, r.params,
                                         r.generated)} for r in reqs]
    path = tmp_path / "golden.jsonl"
    GoldenSet.seal(records).save(str(path))
    engine = _engine(faults="logit_corrupt:request=_integrity",
                     integrity_golden_path=str(path),
                     integrity_probe_passes=2)
    _run(engine, until=lambda e: e.integrity.probes["run"] >= 2)
    bundles = engine.incidents.list()
    assert [b["reason"] for b in bundles] == ["integrity"]
    bundle = engine.incidents.get(bundles[0]["id"])
    assert bundle["attrs"]["golden_id"] in bundle["cause"]
    assert bundle["state"]["integrity"]["episodes"] == 1


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_debug_incidents_lists_and_fetches_bundles():
    engine = _engine(autoprof=False)
    server = build_server(engine, port=0, name="tiny", env={})
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/debug/incidents"
    try:
        status, body = _get(base)
        assert status == 200 and body["data"]["tiny"]["incidents"] == []
        meta = engine.incidents.trigger("restart_budget", cause="planted")
        status, body = _get(base)
        assert [m["id"] for m in body["data"]["tiny"]["incidents"]] == \
            [meta["id"]]
        assert body["data"]["tiny"]["detector"]["spooled"] == 1
        status, body = _get(f"{base}?id={meta['id']}")
        assert status == 200 and body["data"]["reason"] == "restart_budget"
        assert body["data"]["format"] == "gofr-incident"
        status, body = _get(f"{base}?id=local-9999-nope")
        assert status == 404
        assert "local-9999-nope" in body["error"]["message"]
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
