"""Device resolution for the port's entry points.

The port runs on ``cuda:0`` unless the caller asks for ``"cpu"``
explicitly (the CPU tests do). Asking for CUDA where there is none
raises: a serving entry point that silently ran a 1B model on the CPU
would look alive and be useless.

:class:`DeviceRegistry` lists the devices, their memory and their health
for the app's health route and the ``app_gpu_*`` gauges.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda[:n]"`` -> that CUDA device, or RuntimeError
    when CUDA is absent; ``"cpu"`` -> the CPU, only when asked for.

    On CUDA this also turns TF32 off for matmuls and cuDNN. The plain
    PyTorch versions of the kernels are the references the kernels are
    held against; TF32 keeps ~10 mantissa bits, so a float32 reference
    that silently ran in TF32 would be a worse reference than the bf16
    kernel it checks.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev!s} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU explicitly")
    if dev.index is None:
        dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


#: how long device enumeration may take before health reports DOWN
PROBE_TIMEOUT_S = 10.0
#: cached device info stays fresh this long
CACHE_TTL_S = 10.0


class DeviceRegistry:
    """The serving process's devices, their memory, and their health
    (the counterpart of ``gofr_tpu/device.py:DeviceRegistry``).

    The probe enumerates the CUDA devices (``id``, ``platform`` "gpu",
    ``kind`` = ``torch.cuda.get_device_name``, ``hbm_bytes_in_use`` =
    ``torch.cuda.memory_allocated``, ``hbm_bytes_limit`` = the device's
    ``total_memory``), or the CPU alone when ``device`` asks for
    ``"cpu"``. It runs on a worker thread with a deadline, so a wedged
    CUDA runtime makes health DOWN instead of hanging the health route,
    and its result is cached for ``cache_ttl_s``. Asked for CUDA where
    there is none, the probe fails: the registry lists nothing and reports
    DOWN with ``last_error``, never the CPU.

    ``publish_metrics`` sets ``app_gpu_device_count`` and
    ``app_gpu_hbm_bytes_used{device}`` (the JAX names' ``tpu`` as
    ``gpu``), registering them where absent."""

    def __init__(self, logger: Any = None, metrics: Any = None,
                 probe_timeout_s: float = PROBE_TIMEOUT_S,
                 cache_ttl_s: float = CACHE_TTL_S,
                 device: str | torch.device | None = None) -> None:
        self.logger = logger
        self.metrics = metrics
        self.probe_timeout_s = probe_timeout_s
        self.cache_ttl_s = cache_ttl_s
        self.device = torch.device("cuda" if device is None else device)
        self.engines: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._cache: list[dict] | None = None
        self._cache_at = 0.0
        self._last_error: str | None = None
        if metrics is not None:
            for name, desc in _DEVICE_GAUGES:
                if metrics.get(name) is None:
                    metrics.new_gauge(name, desc)

    # ------------------------------------------------------- enumeration
    def _probe(self) -> list[dict]:
        """Runs on a worker thread: enumerate the devices and their
        memory."""
        if self.device.type == "cpu":
            return [{"id": 0, "platform": "cpu", "kind": "cpu",
                     "process_index": 0}]
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA requested but torch.cuda.is_available()"
                               " is False")
        out = []
        for i in range(torch.cuda.device_count()):
            out.append({
                "id": i, "platform": "gpu",
                "kind": torch.cuda.get_device_name(i),
                "process_index": 0,
                "hbm_bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "hbm_bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory)})
        return out

    def devices(self, refresh: bool = False) -> list[dict]:
        """Cached device info; an empty list when the probe failed and
        nothing was cached (``last_error`` says why)."""
        with self._lock:
            fresh = (self._cache is not None
                     and time.time() - self._cache_at < self.cache_ttl_s)
            if fresh and not refresh:
                return list(self._cache)
        # a bounded probe off-thread; the pool is not reused, so a stuck
        # probe thread does not block later probes
        pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="gpu-probe")
        try:
            future = pool.submit(self._probe)
            devices = future.result(self.probe_timeout_s)
            error = None
        except concurrent.futures.TimeoutError:
            devices, error = None, \
                f"device probe exceeded {self.probe_timeout_s}s"
        except Exception as exc:
            devices, error = None, repr(exc)
        finally:
            pool.shutdown(wait=False)
        with self._lock:
            self._last_error = error
            if devices is not None:
                self._cache = devices
                self._cache_at = time.time()
            # on error the stale cache (if any) is still served: health
            # reads DEGRADED through last_error
            return list(self._cache or [])

    @property
    def last_error(self) -> str | None:
        return self._last_error

    def device_count(self) -> int:
        return len(self.devices())

    # ---------------------------------------------------------- engines
    def register_engine(self, name: str, engine: Any) -> None:
        self.engines[name] = engine

    # ----------------------------------------------------------- health
    def device_health(self) -> dict:
        """The devices' own status: UP, DEGRADED (a stale cache behind a
        failed probe) or DOWN (nothing to list), with the list."""
        devices = self.devices()
        status = "UP" if devices and self._last_error is None else "DOWN"
        details: dict[str, Any] = {"devices": devices,
                                   "device_count": len(devices)}
        if self._last_error:
            details["error"] = self._last_error
            if devices:
                status = "DEGRADED"
        return {"status": status, "details": details}

    def health_check(self) -> dict:
        """:meth:`device_health` with each registered engine's health
        under ``details.engines``; the worst status of all."""
        out = self.device_health()
        if self.engines:
            engine_health = {
                name: (e.health_check() if hasattr(e, "health_check")
                       else {"status": "UP"})
                for name, e in self.engines.items()}
            out["details"]["engines"] = engine_health
            out["status"] = worst_status(
                out["status"], *(h.get("status", "UP")
                                 for h in engine_health.values()))
        return out

    # ---------------------------------------------------------- metrics
    def publish_metrics(self) -> None:
        """Set the device gauges from the (cached) probe."""
        if self.metrics is None:
            return
        devices = self.devices()
        self.metrics.set_gauge("app_gpu_device_count", len(devices))
        for d in devices:
            used = d.get("hbm_bytes_in_use")
            if used is not None:
                self.metrics.set_gauge("app_gpu_hbm_bytes_used", used,
                                       device=str(d["id"]))

    def close(self) -> None:
        pass


#: the registry's gauges (JAX: ``app_tpu_device_count`` /
#: ``app_tpu_hbm_bytes_used``, registered by its container)
_DEVICE_GAUGES = (
    ("app_gpu_hbm_bytes_used", "HBM bytes in use per device"),
    ("app_gpu_device_count", "visible GPU devices"),
)

#: health statuses, best to worst
_RANKS = {"UP": 0, "DEGRADED": 1, "DOWN": 2}


def worst_status(*statuses: str) -> str:
    """The worst of ``statuses`` (an unknown one counts as DEGRADED)."""
    return max(statuses, key=lambda s: _RANKS.get(s, 1))
