"""The port's device registry: the CPU only when asked for, DOWN with
``last_error`` when CUDA is asked for and absent (never the CPU in its
place), the bounded probe, the cache, the stale-cache DEGRADED, the
``app_gpu_*`` gauges, the engines' health, the JAX registry's shape, and
``build_server``'s health route with the registry's section."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from gofr_tpu.device import DeviceRegistry as JaxDeviceRegistry
from gofr_tpu_torch.device import DeviceRegistry, worst_status
from gofr_tpu_torch.metrics import Manager
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving.app import build_engine, build_server
from gofr_tpu_torch.serving.engine import EngineConfig

torch.set_num_threads(2)


class FakeEngine:
    def __init__(self, status="UP"):
        self.status = status

    def health_check(self):
        return {"status": self.status, "steps": 7}


def test_the_cpu_is_listed_only_when_asked_for():
    reg = DeviceRegistry(device="cpu")
    devices = reg.devices()
    assert [d["platform"] for d in devices] == ["cpu"]
    assert reg.device_health()["status"] == "UP"
    assert reg.last_error is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present: the absent-CUDA path cannot show here")
@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_cuda_asked_for_and_absent_is_down_with_last_error(device):
    reg = DeviceRegistry(device=device)
    assert reg.devices() == []
    health = reg.health_check()
    assert health["status"] == "DOWN"
    assert "is_available" in health["details"]["error"]
    assert reg.last_error == health["details"]["error"]
    assert reg.device_count() == 0


def test_device_entries_have_the_jax_registrys_keys():
    jax_cpu = JaxDeviceRegistry().devices()[0]
    port_cpu = DeviceRegistry(device="cpu").devices()[0]
    assert set(port_cpu) == set(jax_cpu) - {"coords", "hbm_bytes_in_use",
                                            "hbm_bytes_limit"}
    for reg in (JaxDeviceRegistry(), DeviceRegistry(device="cpu")):
        reg.register_engine("llama", FakeEngine())
        health = reg.health_check()
        assert set(health) == {"status", "details"}
        assert {"devices", "device_count", "engines"} <= \
            set(health["details"])
        assert health["details"]["engines"]["llama"]["steps"] == 7


def test_cache_ttl_avoids_a_reprobe():
    reg = DeviceRegistry(device="cpu", cache_ttl_s=60)
    reg.devices()
    probes = {"n": 0}
    original = reg._probe

    def counting():
        probes["n"] += 1
        return original()
    reg._probe = counting
    reg.devices()
    assert probes["n"] == 0
    reg.devices(refresh=True)
    assert probes["n"] == 1


def test_a_hung_probe_is_bounded_and_down():
    reg = DeviceRegistry(device="cpu", probe_timeout_s=0.2, cache_ttl_s=0)
    gate = threading.Event()

    def hang():
        gate.wait(30)
        return []
    reg._probe = hang
    try:
        assert reg.devices() == []
        health = reg.health_check()
        assert health["status"] == "DOWN"
        assert "exceeded" in health["details"]["error"]
    finally:
        gate.set()


def test_a_stale_cache_degrades_instead_of_down():
    reg = DeviceRegistry(device="cpu", cache_ttl_s=0)
    devices = reg.devices()

    def boom():
        raise ConnectionError("device gone")
    reg._probe = boom
    assert reg.devices() == devices
    assert reg.health_check()["status"] == "DEGRADED"


@pytest.mark.parametrize("engine_status,want", [
    ("UP", "UP"), ("DEGRADED", "DEGRADED"), ("DOWN", "DOWN")])
def test_the_worst_engine_status_wins(engine_status, want):
    reg = DeviceRegistry(device="cpu")
    reg.register_engine("a", FakeEngine())
    reg.register_engine("b", FakeEngine(engine_status))
    assert reg.health_check()["status"] == want
    assert worst_status("UP", engine_status) == want


def test_publish_metrics_sets_the_gpu_gauges():
    m = Manager()
    reg = DeviceRegistry(device="cpu", metrics=m)
    reg.publish_metrics()
    assert m.get("app_gpu_device_count").get() == 1.0
    text = m.render_prometheus()
    assert "app_gpu_device_count 1" in text
    assert "# TYPE app_gpu_hbm_bytes_used gauge" in text
    # a second registry on the same manager registers nothing twice
    DeviceRegistry(device="cpu", metrics=m).publish_metrics()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_build_server_registers_the_engine_and_the_health_section():
    engine = build_engine(LlamaConfig.tiny(), device="cpu",
                          engine_config=EngineConfig(max_batch=2, max_seq=64,
                                                     page_size=16))
    server = build_server(engine, port=0, name="tiny")
    thread = threading.Thread(target=server.serve_forever, args=(0.01,),
                              daemon=True)
    thread.start()
    engine.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert server.devices.engines == {"tiny": engine}
        status, body = _get(base + "/.well-known/health")
        assert status == 200
        data = body["data"]
        assert data["status"] == "UP" and "steps" in data
        assert data["devices"]["status"] == "UP"
        assert data["devices"]["details"]["device_count"] == 1
        assert "app_gpu_device_count 1" in \
            server.metrics.render_prometheus()
        snap = server.metrics_snapshot()
        assert snap["metrics"]["app_gpu_device_count"]["series"][0][
            "value"] == 1.0
        # a DOWN device section makes the route 503, the engine still UP
        server.devices._probe = lambda: (_ for _ in ()).throw(
            RuntimeError("device gone"))
        server.devices._cache = None
        server.devices.cache_ttl_s = 0
        status, body = _get(base + "/.well-known/health")
        assert status == 503 and body["data"]["status"] == "DOWN"
        assert body["data"]["devices"]["details"]["error"]
    finally:
        engine.stop()
        server.shutdown()
        server.server_close()
    # stopped: DOWN through the engine, the devices aside
    server.devices = None
    assert server.health()["status"] == "DOWN"
