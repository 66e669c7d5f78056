"""The test helper that boots a port ``App`` in a thread
(``tests/torch_apputil.AppRunner``): a failed start must reach
``__enter__`` whatever the threads' timing.

The runner thread wakes ``__enter__`` (``_started``) when ``app.start()``
returns or fails. Its error has to be recorded before that wake-up: the
event below holds the runner thread for a while right after it sets
``_started``, so an error recorded only after the wake-up is still
missing when ``__enter__`` reads it, and ``__enter__`` would return as
if the app had started.
"""

import threading
import time

import pytest

from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import DictConfig

from .torch_apputil import AppRunner


class _LateEvent(threading.Event):
    """An event whose ``set`` keeps the setting thread 0.5 s after it has
    woken the waiters."""

    def set(self) -> None:
        super().set()
        time.sleep(0.5)


def test_a_failed_start_raises_in_enter_even_when_the_runner_is_slow():
    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))

    def refuse(_container):
        raise RuntimeError("refused at start")

    app.on_start(refuse)
    runner = AppRunner(app=app)
    runner._started = _LateEvent()
    with pytest.raises(RuntimeError, match="on_start hook failed") as info:
        with runner:
            pytest.fail("the app started")
    assert "refused at start" in str(info.value.__cause__)
    assert app.http_server is None
