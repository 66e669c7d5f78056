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


def time_limit(seconds: float):
    """Fail a test that runs past ``seconds``: its body runs on a daemon
    thread the test waits for with that deadline (a server the body
    booted is stopped by the body's own ``finally``)."""
    import functools
    import threading

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            outcome: list = []

            def body():
                try:
                    fn(*args, **kwargs)
                    outcome.append(None)
                except BaseException as exc:  # noqa: BLE001 — re-raised
                    outcome.append(exc)

            worker = threading.Thread(target=body, daemon=True)
            worker.start()
            worker.join(seconds)
            if worker.is_alive():
                raise AssertionError(f"{fn.__name__} ran past {seconds} s")
            if outcome[0] is not None:
                raise outcome[0]
        return run
    return wrap


class AppThread:
    """An ``App`` of either package started on an event loop of its own,
    in a thread: ``with AppThread(app) as t: ... t.port`` (the app's
    ``HTTP_PORT`` / ``METRICS_PORT`` should be 0). Boot waits with a
    deadline; exit stops the app (``stop()``, or ``call(coro)`` to run
    another coroutine such as ``_graceful_stop()`` on the loop first)."""

    def __init__(self, app, boot_s: float = 30.0) -> None:
        import asyncio
        import threading
        self.app = app
        self.loop = asyncio.new_event_loop()
        self._booted = threading.Event()
        self._error: list = []
        self._boot_s = boot_s
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        import asyncio
        asyncio.set_event_loop(self.loop)

        async def main():
            try:
                await self.app.start()
            except BaseException as exc:  # noqa: BLE001 — raised by enter
                self._error.append(exc)
                return
            finally:
                self._booted.set()
            await self.app._stop_event.wait()

        try:
            self.loop.run_until_complete(main())
        finally:
            self.loop.close()

    def __enter__(self) -> "AppThread":
        self._thread.start()
        if not self._booted.wait(self._boot_s):
            raise TimeoutError("the app did not boot")
        if self._error:
            raise self._error[0]
        return self

    @property
    def port(self) -> int:
        return self.app.http_server.bound_port

    @property
    def metrics_port(self) -> int:
        return self.app.metrics_server.bound_port

    def call(self, coro, timeout_s: float = 60.0):
        import asyncio
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout_s)

    def __exit__(self, *exc) -> None:
        stopped = self.app._stop_event is None \
            or self.app._stop_event.is_set()
        if self._thread.is_alive() and not stopped:
            self.call(self.app.stop(), 30.0)
        self._thread.join(30.0)
