"""ctypes binding of the C++ waitable batch queue (``src/batchq.cpp``;
a copy of ``gofr_tpu/native/batch_queue.py``).

``BatchQueue`` stores opaque uint64 handles; :class:`RequestQueue`
wraps it into a put / pop_batch queue of Python objects, with a
pure-Python twin (:class:`PyRequestQueue`) for when no compiler is
present; :func:`new_request_queue` picks one. Blocking pops release the
GIL, so producers (HTTP handler threads) run while a consumer waits.
"""

from __future__ import annotations

import ctypes
import itertools
import queue as queue_mod
import threading
import time
from typing import Any

from .build import load_library


class BatchQueue:
    """Thin uint64 queue over the C ABI."""

    def __init__(self, capacity: int = 0) -> None:
        self._lib = load_library("batchq")
        self._lib.bq_create.restype = ctypes.c_void_p
        self._lib.bq_create.argtypes = [ctypes.c_long]
        self._lib.bq_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        self._lib.bq_pop_batch.restype = ctypes.c_long
        self._lib.bq_pop_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_long, ctypes.c_long, ctypes.c_long]
        self._lib.bq_size.restype = ctypes.c_long
        self._lib.bq_size.argtypes = [ctypes.c_void_p]
        self._lib.bq_close.argtypes = [ctypes.c_void_p]
        self._lib.bq_destroy.argtypes = [ctypes.c_void_p]
        self._handle = ctypes.c_void_p(self._lib.bq_create(capacity))

    def push(self, item: int) -> bool:
        """False when full or closed."""
        return self._lib.bq_push(self._handle, item) == 0

    def pop_batch(self, max_n: int, first_wait_s: float = 0.1,
                  drain_wait_s: float = 0.0) -> list[int] | None:
        """Block up to ``first_wait_s`` for one item, drain up to
        ``max_n`` (waiting ``drain_wait_s`` for stragglers).
        ``None`` = closed and drained; ``[]`` = timed out."""
        out = (ctypes.c_uint64 * max_n)()
        n = self._lib.bq_pop_batch(self._handle, out, max_n,
                                   int(first_wait_s * 1e6),
                                   int(drain_wait_s * 1e6))
        if n == -2:
            return None
        return list(out[:max(n, 0)])

    def size(self) -> int:
        return int(self._lib.bq_size(self._handle))

    def close(self) -> None:
        self._lib.bq_close(self._handle)

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.bq_destroy(handle)


class RequestQueue:
    """Object queue over :class:`BatchQueue`: ids go through the native
    queue, the objects stay in a Python-side table."""

    def __init__(self, capacity: int = 0) -> None:
        self._q = BatchQueue(capacity)
        self._items: dict[int, Any] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def put(self, item: Any) -> bool:
        item_id = next(self._ids)
        with self._lock:
            self._items[item_id] = item
        if not self._q.push(item_id):
            with self._lock:
                self._items.pop(item_id, None)
            return False
        return True

    def pop_batch(self, max_n: int, first_wait_s: float = 0.1,
                  drain_wait_s: float = 0.0) -> list[Any] | None:
        ids = self._q.pop_batch(max_n, first_wait_s, drain_wait_s)
        if ids is None:
            return None
        with self._lock:
            return [self._items.pop(i) for i in ids if i in self._items]

    def get_nowait(self) -> Any:
        """queue.Queue-compatible accessor (raises queue.Empty)."""
        batch = self.pop_batch(1, first_wait_s=0.0)
        if not batch:
            raise queue_mod.Empty
        return batch[0]

    def qsize(self) -> int:
        return self._q.size()

    def close(self) -> None:
        self._q.close()


class PyRequestQueue:
    """Pure-Python fallback with identical semantics."""

    def __init__(self, capacity: int = 0) -> None:
        self._q: queue_mod.Queue = queue_mod.Queue(capacity or 0)
        self._closed = False

    def put(self, item: Any) -> bool:
        if self._closed:
            return False
        try:
            self._q.put_nowait(item)
            return True
        except queue_mod.Full:
            return False

    def pop_batch(self, max_n: int, first_wait_s: float = 0.1,
                  drain_wait_s: float = 0.0) -> list[Any] | None:
        out: list[Any] = []
        # grab already-queued work even at zero wait (the engine's busy
        # path polls with first_wait_s=0.0 between decode steps)
        try:
            out.append(self._q.get_nowait())
        except queue_mod.Empty:
            pass
        deadline = time.monotonic() + first_wait_s
        while not out:
            if self._closed and self._q.empty():
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return out
            try:
                out.append(self._q.get(timeout=min(remaining, 0.05)))
            except queue_mod.Empty:
                continue
        while len(out) < max_n:
            try:
                out.append(self._q.get(timeout=drain_wait_s or 0.0001))
            except queue_mod.Empty:
                break
        return out

    def get_nowait(self) -> Any:
        """queue.Queue-compatible accessor (raises queue.Empty)."""
        return self._q.get_nowait()

    def qsize(self) -> int:
        return self._q.qsize()

    def close(self) -> None:
        self._closed = True


def new_request_queue(capacity: int = 0):
    """Native when the C++ build works, Python otherwise. Any build or
    dlopen failure (no compiler, unwritable cache dir, corrupt cached
    .so, compile timeout) falls back — the queue must never be the
    reason an engine cannot construct."""
    try:
        return RequestQueue(capacity)
    except Exception:
        return PyRequestQueue(capacity)
