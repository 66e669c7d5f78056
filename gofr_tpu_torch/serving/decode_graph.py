"""The compiled decode dispatch: device-resident decode state and T = K x
M decode steps per dispatch, replayed as one CUDA graph (counterpart of
the JAX engine's ``_fused_decode`` / ``_decode_sample`` /
``_advance_lengths`` and of its device-resident scheduler arrays,
``_sync_decode_state`` / ``_tables_arg``:
``gofr_tpu/serving/engine.py:708-791``, ``:3199-3268``).

Three layouts of the pass (``layout``), as the JAX engine builds its
decode graphs (``:780-880``):

- ``"paged"``: the native paged step writes each new row through the
  block tables and attends with the paged decode kernel;
- ``"slot"``: a dense step on the slot caches [L, B, S, Hkv, hd],
  written in place;
- ``"view"``: one gather of the pool into the dense slot view per pass
  (``gather_view``), the T dense steps on the view, and the T new rows
  of each slot written back into the pool (``scatter_decode_kv``, one
  launch of the slab kernel on the card).

``windows``: decode windows (dense layouts only). The pass for window w
attends only the first w rows (``attn_window`` on the slot layout) or
gathers and writes back only the table columns that cover them (the
view); each window is a graph of its own, as JAX compiles one per
window, and window 0 is the full pass.

Row = slot: every buffer holds ``rows`` (the engine's ``max_batch``)
rows, whether a slot decodes, walks its prompt or is idle, so the state
stays on the device across admissions. The static buffers:

- ``tokens`` / ``use_prev`` / ``prev``: each row's input token is
  ``where(use_prev, prev, tokens)``, as JAX's ``toks_in``: a row that
  decoded in the last dispatch takes that dispatch's last token on the
  device, a fresh one the token the host wrote;
- ``lengths`` (rows in the cache), ``active`` (the rows that decode);
- ``temps`` / ``top_ps`` / ``top_ks``: sampling params;
- ``tables`` [rows, Mp]: block tables;
- ``out`` [T, rows]: the dispatch's sampled tokens.

The host rewrites them (:meth:`DecodeGraph.upload`, a ``copy_`` from a
pinned host tensor per buffer) only when the scheduler changed them;
between such events a dispatch uploads nothing. Inside the pass, lengths
advance by one per step, and at its end active rows' lengths advance by
T, clamped at ``max_seq`` (as ``_advance_lengths``), ``prev`` takes the
last step's tokens and ``use_prev`` the active mask. Inactive rows never
write the pool: the step forces their page ids out of range with
``active``, and the write kernel drops them.

On CUDA, :meth:`DecodeGraph.launch` replays one ``torch.cuda.CUDAGraph``
per window and value of ``all_greedy`` (an all-greedy batch skips the
sampler's candidate search and draws no noise), captured at first use
(or ahead of traffic by :meth:`DecodeGraph.warm`) after one warm-up run
on a side stream, all graphs in one memory pool. There is no eager path on the
card: capture or replay raise, they do not fall back. The pools and the
params are captured by address; a replay checks that they are still the
tensors it captured. The sampled graph registers the engine's
generator, so each replay draws fresh noise from it. On the CPU the same
pass runs on the same buffers, uncaptured.

Dispatch and collect are split, so the host can schedule while a pass
runs: ``launch`` replays and queues ``out`` into the next buffer of a
ring of pinned host buffers (``non_blocking``) behind a CUDA event, and
returns a handle; ``collect`` waits on the handle's event and returns
the tokens. A ring buffer is written again only after its handle was
collected (or discarded): ``launch`` raises rather than overwrite one.
Every device write is on the current stream, the uploads included, so a
pass in flight that writes pages a later collect frees is ordered before
any later write to them.

Launch counters: a kernel wrapper counts when Python calls it, which a
replay does not do. The counts made during a capture are taken back off
(the capture launched nothing) and added again on every replay.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import numpy as np
import torch

from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import (paged_chunk_attention,
                                   paged_decode_attention,
                                   paged_tree_attention)
from ..ops.paged_kv import (gather_view, kv_write, rope_kv_write,
                           scatter_chunk_kv, scatter_decode_kv)
from ..ops.quant import wq_gemm
from .sampling import sample_batch

#: the kernel wrappers whose launch counters a replay carries on
COUNTED = (flash_attention, paged_decode_attention, paged_chunk_attention,
           paged_tree_attention, kv_write, rope_kv_write, scatter_chunk_kv,
           wq_gemm)
#: how a pass runs its steps (see the module docstring)
LAYOUTS = ("paged", "slot", "view")
_COUNTERS = ("launches", "launches_int8", "launches_int4")

#: the buffers the host writes, with their dtypes
STATE = {"tokens": torch.int64, "use_prev": torch.bool,
         "lengths": torch.int32, "active": torch.bool,
         "temps": torch.float32, "top_ps": torch.float32,
         "top_ks": torch.int64, "tables": torch.int32}


def _counts() -> dict:
    return {(fn, attr): getattr(fn, attr) for fn in COUNTED
            for attr in _COUNTERS if hasattr(fn, attr)}


def _leaves(tree) -> list:
    """The tensors of a params dict or a pool (plain, or ``{q, s}``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _addresses(*trees) -> tuple:
    return tuple(t.data_ptr() for tree in trees for t in _leaves(tree))


class DecodeGraph:
    """T decode steps over ``rows`` slots on static device buffers.

    step_fn, for ``layout="paged"``: (params, tokens [rows] int64,
        k_pool, v_pool, tables [rows, Mp], lengths [rows] int32,
        active=[rows] bool) -> (logits [rows, V], k_pool, v_pool),
        updating the pools in place (e.g. ``llama_decode_step_paged``);
        for ``"slot"`` and ``"view"``: (params, tokens, k_cache,
        v_cache, lengths[, attn_window=w]) -> (logits, k_cache,
        v_cache) on dense caches [L, rows, S, Hkv, hd], written in place
        (e.g. ``moe_decode_step``); rows at or past S drop their write.
    windows: the decode windows (dense layouts); page_size and
        view_dtype: the view's table columns per window and the dtype a
        quantized pool's view dequantizes to.
    """

    def __init__(self, step_fn: Callable, params, *, rows: int,
                 max_pages: int, n_pages: int, steps: int, max_seq: int,
                 device: str | torch.device,
                 generator: torch.Generator | None = None,
                 ring: int = 2, layout: str = "paged",
                 windows: tuple = (), page_size: int = 1,
                 view_dtype: torch.dtype | None = None) -> None:
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got "
                             f"{layout!r}")
        if windows and layout == "paged":
            raise ValueError("decode windows apply to the dense layouts")
        self.step_fn = step_fn
        self.params = params
        self.steps = steps
        self.max_seq = max_seq
        self.layout = layout
        self.windows = tuple(windows)
        self.page_size = page_size
        self.view_dtype = view_dtype
        self.device = torch.device(device)
        self.generator = generator
        dev, pin = self.device, self.device.type == "cuda"
        shapes = {"tables": (rows, max_pages)}
        fills = {"top_ps": 1, "tables": n_pages}
        for name, dtype in STATE.items():
            setattr(self, name, torch.full(shapes.get(name, (rows,)),
                                           fills.get(name, 0), dtype=dtype,
                                           device=dev))
        self.prev = torch.zeros(rows, dtype=torch.int64, device=dev)
        self.out = torch.zeros((steps, rows), dtype=torch.int64, device=dev)
        #: pinned host staging, one tensor per host-written buffer
        self._host = {name: torch.empty_like(getattr(self, name),
                                             device="cpu", pin_memory=pin)
                      for name in STATE}
        #: pinned host buffers the dispatches' tokens land in, in turn
        self._ring = [torch.empty_like(self.out, device="cpu",
                                       pin_memory=pin)
                      for _ in range(max(2, ring))]
        self._ring_events = [torch.cuda.Event() if pin else None
                             for _ in self._ring]
        #: ring buffers whose dispatch has not been collected yet
        self._ring_busy = [False] * len(self._ring)
        self._ring_next = 0
        self._uploaded = torch.cuda.Event() if pin else None
        #: (window, all_greedy) -> its graph, and the launches it holds
        self._graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self._graph_launches: dict[tuple, dict] = {}
        self._mempool = None
        self._captured = None           # addresses of params and pools
        self.captures = 0
        self.replays = 0
        #: window -> passes run at it (replays on CUDA), 0 = the full pass
        self.passes_by_window = {w: 0 for w in (0, *self.windows)}
        #: seconds spent capturing (warm-up run included)
        self.capture_s = 0.0

    # ------------------------------------------------------------ state
    def upload(self, **arrays: np.ndarray) -> int:
        """Copy host arrays into the named buffers, in place (a graph
        reads them by address); returns the host-to-device transfers
        made (one per buffer)."""
        if self._uploaded is not None:
            # the staging tensors are rewritten only once the last
            # uploads out of them have landed
            self._uploaded.synchronize()
        for name, value in arrays.items():
            host = self._host[name]
            host.numpy()[...] = value
            getattr(self, name).copy_(host, non_blocking=True)
        if self._uploaded is not None:
            self._uploaded.record()
        return len(arrays)

    def save(self) -> dict:
        """A copy of every buffer and of the generator's state."""
        saved = {name: getattr(self, name).clone()
                 for name in (*STATE, "prev", "out")}
        if self.generator is not None:
            saved["generator"] = self.generator.get_state()
        return saved

    def restore(self, saved: dict) -> None:
        """Put back what :meth:`save` copied, in place."""
        for name, value in saved.items():
            if name == "generator":
                self.generator.set_state(value)
            else:
                getattr(self, name).copy_(value)

    # ------------------------------------------------------------- pass
    def body(self, k_pool, v_pool, all_greedy: bool, window: int = 0) -> None:
        """The pass itself, on the static buffers: T steps, each feeding
        its sampled tokens to the next (on the view: one gather before
        them, the new rows written back after them), then the state
        advance. What a graph holds; on the CPU, what :meth:`launch`
        calls."""
        toks = torch.where(self.use_prev, self.prev, self.tokens)
        lens = self.lengths
        k_run, v_run, tables = k_pool, v_pool, self.tables
        if self.layout == "view":
            if window:
                tables = tables[:, :-(-window // self.page_size)]
            k_run = gather_view(k_pool, tables, self.view_dtype)
            v_run = gather_view(v_pool, tables, self.view_dtype)
        sampled = []
        for _ in range(self.steps):
            if self.layout == "paged":
                logits = self.step_fn(self.params, toks, k_run, v_run,
                                      tables, lens, active=self.active)[0]
            else:
                kw = {"attn_window": window} \
                    if window and self.layout == "slot" else {}
                logits = self.step_fn(self.params, toks, k_run, v_run, lens,
                                      **kw)[0]
            toks = sample_batch(logits, self.temps, self.top_ps, self.top_ks,
                                generator=self.generator,
                                all_greedy=all_greedy).long()
            sampled.append(toks)
            lens = lens + 1
        if self.layout == "view":
            scatter_decode_kv(k_pool, v_pool, tables, k_run, v_run,
                              self.lengths, self.steps)
        self.out.copy_(torch.stack(sampled))
        self.prev.copy_(toks)
        self.use_prev.copy_(self.active)
        self.lengths.copy_(torch.where(
            self.active, (self.lengths + self.steps).clamp(max=self.max_seq),
            self.lengths))

    def launch(self, k_pool, v_pool, all_greedy: bool,
               window: int = 0) -> int:
        """Start one dispatch at ``window`` (0: the full pass) and return
        its handle without waiting: the captured graph's replay on CUDA
        (captured now if this is its first use), the uncaptured pass on
        the CPU; either way ``out`` goes on to the next ring buffer.
        Raises if that buffer's last dispatch was neither collected nor
        discarded."""
        if window not in self.passes_by_window:
            raise ValueError(f"decode graph: no window {window}; the "
                             f"windows are {self.windows}")
        handle = self._ring_next
        if self._ring_busy[handle]:
            raise RuntimeError(
                f"decode graph: ring buffer {handle} of {len(self._ring)} "
                f"still holds an uncollected dispatch; collect it before "
                f"launching another")
        host = self._ring[handle]
        key = (window, all_greedy)
        if self.device.type == "cpu":
            self.body(k_pool, v_pool, all_greedy, window)
            host.copy_(self.out)
        else:
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._capture(k_pool, v_pool, all_greedy, window)
            if _addresses(self.params, k_pool, v_pool) != self._captured:
                raise RuntimeError("decode graph: the params or KV pools "
                                   "are not the tensors the graph captured "
                                   "(reallocated or reassigned since)")
            graph.replay()
            self.replays += 1
            for (fn, attr), n in self._graph_launches[key].items():
                setattr(fn, attr, getattr(fn, attr) + n)
            host.copy_(self.out, non_blocking=True)
            self._ring_events[handle].record()
        self.passes_by_window[window] += 1
        self._ring_busy[handle] = True
        self._ring_next = (handle + 1) % len(self._ring)
        return handle

    def collect(self, handle: int) -> np.ndarray:
        """Wait for the dispatch ``handle`` and return its sampled tokens
        [T, rows]; its ring buffer is free again."""
        if not self._ring_busy[handle]:
            raise RuntimeError(f"decode graph: ring buffer {handle} holds "
                               f"no dispatch to collect")
        if self._ring_events[handle] is not None:
            self._ring_events[handle].synchronize()
        out = self._ring[handle].numpy().copy()
        self._ring_busy[handle] = False
        return out

    def discard(self, handle: int) -> None:
        """Give up a dispatch's tokens unread: its ring buffer is free
        again (the copy still in flight lands before any later one)."""
        self._ring_busy[handle] = False

    def run(self, k_pool, v_pool, all_greedy: bool) -> np.ndarray:
        """One dispatch, waited for: :meth:`launch` then
        :meth:`collect`. Returns the sampled tokens [T, rows]."""
        return self.collect(self.launch(k_pool, v_pool, all_greedy))

    def warm(self, k_pool, v_pool) -> None:
        """Make every pass ready ahead of traffic with every row
        inactive (paged: every K/V write drops; dense: every row parked
        at ``max_seq``, so every write drops too): on CUDA capture the
        greedy and the sampled graph of each window, on the CPU run each
        pass once. The state buffers and the generator are left as they
        were."""
        saved = self.save()
        self.active.zero_()
        if self.layout != "paged":
            self.lengths.fill_(self.max_seq)
        for window in (0, *self.windows):
            for all_greedy in (True, False):
                if self.device.type == "cpu":
                    self.body(k_pool, v_pool, all_greedy, window)
                elif (window, all_greedy) not in self._graphs:
                    self._capture(k_pool, v_pool, all_greedy, window)
        self.restore(saved)

    def _capture(self, k_pool, v_pool, all_greedy: bool, window: int = 0):
        """Capture the pass for ``all_greedy`` at ``window``. One warm-up
        run on a side stream first, so lazy set-up (library handles,
        kernel builds, workspaces) happens outside the capture; its effect
        on the state buffers and the generator is undone, and the KV rows
        it wrote are written again by the pass before anything reads
        them."""
        t0 = time.perf_counter()
        addresses = _addresses(self.params, k_pool, v_pool)
        if self._captured is None:
            self._captured = addresses
        elif addresses != self._captured:
            raise RuntimeError("decode graph: the params or KV pools are not "
                               "the tensors the first graph captured")
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        saved = self.save()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.body(k_pool, v_pool, all_greedy, window)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.restore(saved)
        graph = torch.cuda.CUDAGraph()
        if not all_greedy and self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _counts()
        # the cycle collector must not run inside the capture: freeing a
        # dead engine's graphs there is refused while a stream captures,
        # which invalidates this capture. Dead cycles go now, and the
        # collector waits until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._mempool,
                                  capture_error_mode="thread_local"):
                self.body(k_pool, v_pool, all_greedy, window)
        finally:
            if collecting:
                gc.enable()
        after = _counts()
        launched = {key: after[key] - before[key] for key in after
                    if after[key] != before[key]}
        for (fn, attr), n in launched.items():   # the capture ran nothing
            setattr(fn, attr, getattr(fn, attr) - n)
        self._graph_launches[(window, all_greedy)] = launched
        self._graphs[(window, all_greedy)] = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph
