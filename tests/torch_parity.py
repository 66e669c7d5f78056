"""Helpers the port's parity tests share: a tolerance check across
tensor kinds, the request-level parity of two engines' runs, and a count
of tensors made from host data."""

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gofr_tpu.serving.integrity import request_digest


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, atol: float) -> None:
    """``got`` (a tensor or array) within ``atol`` of ``want`` (a
    tensor, a JAX array or a numpy array), compared in float32."""
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def assert_parity(got: list, want: list, n_new: int | None = None) -> None:
    """Two engines served the same prompts: the same errors, the same
    prompts as admitted, the same tokens (``n_new`` each, when given),
    equal ``request_digest`` (the JAX package's function) and equal
    digests stamped by each engine's integrity plane."""
    assert [r.error for r in got] == [r.error for r in want]
    assert [r.generated for r in got] == [r.generated for r in want]
    if n_new is not None:
        assert all(len(r.generated) == n_new for r in got)
    for g, w in zip(got, want):
        assert g.prompt_tokens == w.prompt_tokens
        assert request_digest(g.prompt_tokens, g.params, g.generated) == \
            request_digest(w.prompt_tokens, w.params, w.generated)
        assert g.digest is not None and g.digest == w.digest


def serve_waves(engine, waves: list, params, timeout_s: float = 120.0):
    """Queue the first wave of prompts before ``start()`` (both
    packages' engines then admit it as one batch), then each later wave
    once the one before it has ended, on the running engine (a stop
    would empty the prefix cache); stop at the end. Returns the
    requests of every wave, in order. A stopped engine takes submits
    again after ``engine.waiting.reopen()``, which this does first."""
    import time
    engine.waiting.reopen()
    reqs: list = []
    try:
        for n, wave in enumerate(waves):
            batch = [engine.submit(p, params) for p in wave]
            if n == 0:
                engine.start()
            deadline = time.time() + timeout_s
            while time.time() < deadline and any(
                    r.finished_at is None and r.error is None
                    for r in batch):
                time.sleep(0.005)
            reqs += batch
    finally:
        engine.stop()
    return reqs


class HostTensors(TorchDispatchMode):
    """Counts tensors made from host data (``aten.lift_fresh``): on the
    card each is a copy that waits for every queued kernel."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.count += 1
        return func(*args, **(kwargs or {}))
