"""The port's profiler (``observability.ProfilerCapture`` on
``torch.profiler``, ``costmodel.AutoProfiler``) against the JAX package's,
on the CPU.

``ProfilerCapture`` runs the JAX state machine with CPU activities:
start, a refused second start (on the same and on another instance),
stop writing a Chrome trace, a stop with nothing running, the
``max_capture_s`` auto-stop, a leaked capture that only ``force``
recovers, and a refusal while another ``torch.profiler`` session runs.
``AutoProfiler`` arms, counts passes down, debounces, obeys the
``GOFR_AUTOPROF`` kill switch and reports as JAX's on the same fake
capture and clock. The engine arms it on a cost drift (the incident
bundle names the capture's directory), and the app serves
``/debug/profile/*`` only with ``PROFILER_ENABLED``.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from gofr_tpu.serving import costmodel as jax_costmodel
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.serving import costmodel as port_costmodel
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.observability import ProfilerCapture

torch.set_num_threads(2)


def _work():
    a = torch.randn(32, 32)
    for _ in range(3):
        a = torch.relu(a @ a)
    return a


def test_a_capture_starts_refuses_a_second_and_writes_its_trace(tmp_path):
    capture = ProfilerCapture(base_dir=str(tmp_path))
    other = ProfilerCapture(base_dir=str(tmp_path / "other"))
    first = capture.start()
    assert first["ok"] and first["dir"].startswith(str(tmp_path))
    assert capture.start() == {"ok": False, "error": "capture already running",
                               "dir": first["dir"]}
    refused = other.start()
    assert not refused["ok"] and refused["error"] == "capture already running"
    assert capture.status() == {"running": True, "dir": first["dir"],
                                "auto_stops": 0}
    threading.Thread(target=_work).start()
    _work()
    stopped = capture.stop()
    assert stopped["ok"] and stopped["dir"] == first["dir"]
    assert stopped["duration_s"] >= 0
    trace = json.loads(open(os.path.join(first["dir"], "trace.json")).read())
    assert any("mm" in str(e.get("name")) for e in trace["traceEvents"])
    assert capture.stop() == {"ok": False, "error": "no capture running"}
    # the process's capture is free again
    again = other.start(str(tmp_path / "again"))
    assert again == {"ok": True, "dir": str(tmp_path / "again")}
    assert other.stop()["ok"]


def test_max_capture_s_stops_a_forgotten_capture(tmp_path):
    capture = ProfilerCapture(base_dir=str(tmp_path))
    started = capture.start(max_capture_s=0.2)
    assert started["ok"]
    deadline = time.time() + 10
    while capture.status()["running"] and time.time() < deadline:
        time.sleep(0.02)
    assert capture.status() == {"running": False, "dir": None,
                                "auto_stops": 1}
    assert os.path.exists(os.path.join(started["dir"], "trace.json"))
    # a timer armed for an earlier capture never stops a later one
    second = capture.start()
    capture._expire(started["dir"])
    assert capture.status()["running"] and capture.stop()["ok"]
    assert second["ok"]


def test_force_recovers_a_leaked_capture(tmp_path):
    capture = ProfilerCapture(base_dir=str(tmp_path))
    assert capture.start()["ok"]
    capture._active_dir = None           # a failed stop lost the state
    assert capture.start()["error"] == "capture already running"
    assert capture.stop() == {"ok": False, "error": "no capture running"}
    assert capture.stop(force=True) == {"ok": True, "recovered": True,
                                        "dir": None}
    assert capture.start()["ok"] and capture.stop()["ok"]


def test_a_running_torch_profiler_session_refuses_a_start(tmp_path):
    capture = ProfilerCapture(base_dir=str(tmp_path))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        refused = capture.start()
    assert refused["ok"] is False and "torch.profiler" in refused["error"]
    assert capture.status()["running"] is False
    assert capture.start()["ok"] and capture.stop()["ok"]


class FakeCapture:
    def __init__(self, refuse=False):
        self.calls = []
        self.refuse = refuse

    def start(self, trace_dir=None, *, max_capture_s=None):
        self.calls.append(("start", max_capture_s))
        if self.refuse:
            return {"ok": False, "error": "busy"}
        return {"ok": True, "dir": f"/d{len(self.calls)}"}

    def stop(self, force=False):
        self.calls.append(("stop", force))
        return {"ok": True, "duration_s": 1.5}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script(mod, monkeypatch, refuse=False):
    clock, capture = Clock(), FakeCapture(refuse)
    auto = mod.AutoProfiler(capture, passes=3, max_capture_s=5.0,
                            debounce_s=10.0, clock=clock)
    seen = [auto.arm("cost_drift", "sig a"), auto.arm("fast_burn")]
    for _ in range(3):
        auto.note_pass()
    seen.append(auto.state())
    clock.t += 5
    seen.append(auto.arm("goodput_floor", "low"))          # debounced
    clock.t += 10
    seen.append(auto.arm("goodput_floor", "low"))
    clock.t += 6                                           # past its age
    auto.note_pass()
    seen.append(auto.state())
    monkeypatch.setenv("GOFR_AUTOPROF", "0")
    clock.t += 100
    seen.append(auto.arm("cost_drift"))
    seen.append(auto.state())
    monkeypatch.delenv("GOFR_AUTOPROF")
    return seen, capture.calls


@pytest.mark.parametrize("refuse", [False, True])
def test_the_autoprofiler_arms_debounces_and_is_killed_like_jax(
        monkeypatch, refuse):
    want = _script(jax_costmodel, monkeypatch, refuse)
    got = _script(port_costmodel, monkeypatch, refuse)
    assert got == want
    if not refuse:
        assert got[0][0] == {"dir": "/d1", "reason": "cost_drift"}
        assert got[0][2]["last_artifact"]["passes"] == 3


def test_a_disabled_autoprofiler_never_starts():
    for mod in (jax_costmodel, port_costmodel):
        assert mod.AutoProfiler(None).arm("cost_drift") is None
        assert mod.AutoProfiler(FakeCapture(), enabled=False).state()[
            "enabled"] is False


COMMON = dict(max_batch=4, max_seq=128, page_size=16, seed=0,
              decode_steps_per_pass=4, prefill_batch=4, prefill_buckets=(16,))


def _engine(**kw):
    cfg = LlamaConfig.tiny().scaled(vocab_size=260)
    return llama_engine(
        llama_init(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
        EngineConfig(**{**COMMON, **kw}), device="cpu")


def test_a_cost_drift_arms_a_capture_named_in_its_bundle(tmp_path):
    engine = _engine(cost_baseline_passes=2, autoprof_passes=2,
                     autoprof_dir=str(tmp_path),
                     faults="cost_skew:request=decode/0,at=4,seconds=10.0")
    params = SamplingParams(temperature=0.0, max_new_tokens=40)
    reqs = [engine.submit([(7 * i + 3) % 256 for i in range(n)], params)
            for n in (5, 12)]
    engine.start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline and any(r.finished_at is None
                                             for r in reqs):
            time.sleep(0.005)
    finally:
        engine.stop()
    state = engine.cost_state()["autoprof"]
    [meta] = engine.incidents.list()
    bundle = engine.incidents.get(meta["id"])
    assert bundle["reason"] == "cost_drift"
    assert bundle["attrs"]["autoprof_dir"].startswith(str(tmp_path))
    assert state["captures"] == 1 and state["armed"] is None
    artifact = state["last_artifact"]
    assert artifact["ok"] and artifact["reason"] == "cost_drift"
    assert artifact["dir"] == bundle["attrs"]["autoprof_dir"]
    assert os.path.exists(os.path.join(artifact["dir"], "trace.json"))
    assert all(r.error is None for r in reqs)


def _call(base, method, path, body=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("enabled", [False, True])
def test_the_profile_routes_need_profiler_enabled(tmp_path, enabled):
    engine = _engine(autoprof=False)
    env = {"PROFILER_ENABLED": "1", "PROFILER_DIR": str(tmp_path)} \
        if enabled else {"PROFILER_DIR": str(tmp_path)}
    server = build_server(engine, port=0, name="tiny", env=env)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, body = _call(base, "GET", "/debug/profile")
        if not enabled:
            assert status == 404 and server.profiler is None
            return
        assert status == 200 and body["data"]["running"] is False
        status, body = _call(base, "POST", "/debug/profile/start",
                             {"max_capture_s": 30})
        started = body["data"]
        assert status == 201 and started["ok"]
        assert started["dir"].startswith(str(tmp_path))
        assert _call(base, "POST", "/debug/profile/start")[1]["data"] == {
            "ok": False, "error": "capture already running",
            "dir": started["dir"]}
        status, body = _call(base, "POST", "/debug/profile/stop")
        assert body["data"]["ok"] and os.path.exists(
            os.path.join(started["dir"], "trace.json"))
        status, body = _call(base, "POST", "/debug/profile/stop",
                             {"force": True})
        assert body["data"] == {"ok": True, "recovered": True, "dir": None}
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
