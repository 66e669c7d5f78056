#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes on one CUDA GPU.

    python3 scripts/torch_decode_profile.py [--out FILE]

Drives the port's device calls of the serving path at the Llama-3.2-1B
shape (``LlamaConfig.llama3_1b()``, random bf16 weights, seed 0): one
eager paged decode step (``llama_decode_step_paged`` + sampling) at the
batches and lengths the chip smoke serves, on a bf16 pool and on an int8
one (``quantize_pool`` of the same random pool); the same step as the
engine dispatches it, T = 8 steps replayed as one CUDA graph
(``serving/decode_graph.DecodeGraph``, greedy, lengths advancing on the
card), at the same shapes (``case: "decode_graph"``, every number also
given per step), also pipelined as the engine runs it at depth 1 (each
dispatch launched before the one before it is collected:
``pipelined_wall_ms``) and with the host time of one ``launch`` call
(``launch_host_ms``); and one group prefill (``llama_prefill_last``) per
bucket width, with the host time until the call returns, unsynchronised
(``host_ms``). For each it prints one JSON line with

- ``wall_ms``: host clock around the call, synchronised (median of 20
  decode steps / 5 prefills after warm-up);
- ``device_busy_ms``: summed device time of the kernels the call ran,
  from ``torch.profiler`` over the traced calls, and ``idle_share`` =
  1 - busy / wall: how far the host holds the card back;
- ``launches``: kernels per call (in a graph case also per decode step,
  ``per_step``), and the device time and launches grouped as attention
  kernels (this repository's), the K/V write kernels (``kv_write``: the
  per-layer, slab and fused RoPE + write entries of ``csrc/kv_write.cu``),
  GEMMs and the rest (``busy_ms_by_kind``, ``launches_by_kind``), with
  the top kernels by device time;
- ``api_calls``: CUDA API calls (``cuda*``, ``cu*``) the host made per call
  (kernel launches, graph launches, copies, syncs), by name.

The card's name and power limit (``nvidia-smi``) lead the output. The
whole result is also written to ``--out`` (default
``build/torch_profile.json``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gofr_tpu_torch.device import resolve_device  # noqa: E402
from gofr_tpu_torch.models.llama import (LlamaConfig,  # noqa: E402
                                         llama_decode_step_paged,
                                         llama_init, llama_prefill_last,
                                         make_pool)
from gofr_tpu_torch.ops.paged_kv import quantize_pool  # noqa: E402
from gofr_tpu_torch.serving.decode_graph import DecodeGraph  # noqa: E402
from gofr_tpu_torch.serving.sampling import sample_batch  # noqa: E402


def _kind(name: str) -> str:
    if "flash_fwd" in name or "paged_decode" in name:
        return "attention_kernels"
    if "kv_write" in name:      # kv_write_kernel, rope_kv_write_kernel,
        return "kv_write"       # kv_write_slab_kernel
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "sm90")):
        return "gemm"
    return "other"


def _profile(fn, calls: int) -> dict:
    """Trace ``calls`` calls of ``fn``: wall, device busy, idle share,
    kernel launches and the top kernels, per call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels, api = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            if evt.key.startswith("cu"):
                api[evt.key] = evt.count / calls
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        kernels[evt.key] = (dev_us / 1e3 / calls, evt.count / calls)
    busy = sum(ms for ms, _ in kernels.values())
    by_kind: dict[str, float] = {}
    launches_by_kind: dict[str, float] = {}
    for name, (ms, n) in kernels.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
        launches_by_kind[_kind(name)] = launches_by_kind.get(
            _kind(name), 0.0) + n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"traced_wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "launches": sum(n for _, n in kernels.values()),
            "api_calls": sum(api.values()), "api_calls_by_name": api,
            "busy_ms_by_kind": by_kind, "launches_by_kind": launches_by_kind,
            "top_kernels": [{"name": n[:90], "ms": ms, "count": c}
                            for n, (ms, c) in top]}


def _wall_ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def decode_case(params, cfg, dev, lens_l: list[int], kv_dtype: str,
                pg: int = 64) -> dict:
    b = len(lens_l)
    mp = -(-(max(lens_l) + 64) // pg)
    kp, vp = make_pool(cfg, b * mp, pg, dev)
    kp.normal_()
    vp.normal_()
    if kv_dtype == "int8":
        kp, vp = quantize_pool(kp), quantize_pool(vp)
    tables = torch.arange(b * mp, dtype=torch.int32, device=dev).reshape(b, mp)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    toks = torch.zeros(b, dtype=torch.int64, device=dev)
    temps, top_ps = torch.zeros(b, device=dev), torch.ones(b, device=dev)

    def step():
        # a fixed length: the step writes the same row every call
        logits, _, _ = llama_decode_step_paged(params, toks, kp, vp, tables,
                                               lens, cfg)
        sample_batch(logits, temps, top_ps)

    out = {"case": "decode_step", "kv_dtype": kv_dtype, "batch": b,
           "lengths": lens_l, "wall_ms": _wall_ms(step, 5, 20)}
    out.update(_profile(step, 10))
    return out


def graph_case(params, cfg, dev, lens_l: list[int], kv_dtype: str,
               steps: int = 8, pg: int = 64) -> dict:
    """The decode dispatch as the engine runs it: ``steps`` greedy steps
    replayed as one CUDA graph, all rows active, lengths advancing on the
    card (the pool has room for every dispatch of the run)."""
    b = len(lens_l)
    dispatches = 3 + 20 + 10 + 1 + 3 * 20 + 1 + 12
    mp = -(-(max(lens_l) + steps * dispatches + 64) // pg)
    kp, vp = make_pool(cfg, b * mp, pg, dev)
    kp.normal_()
    vp.normal_()
    if kv_dtype == "int8":
        kp, vp = quantize_pool(kp), quantize_pool(vp)

    def step(params, toks, k_pool, v_pool, tables, lengths, active=None):
        return llama_decode_step_paged(params, toks, k_pool, v_pool, tables,
                                       lengths, cfg, active=active)

    graph = DecodeGraph(step, params, rows=b, max_pages=mp, n_pages=b * mp,
                        steps=steps, max_seq=mp * pg, device=dev)
    graph.upload(lengths=lens_l, active=[True] * b,
                 tables=[[i * mp + j for j in range(mp)] for i in range(b)])

    def dispatch():
        graph.run(kp, vp, True)

    dispatch()                       # the capture
    wall = _wall_ms(dispatch, 3, 20)
    out = {"case": "decode_graph", "kv_dtype": kv_dtype, "batch": b,
           "lengths": lens_l, "steps_per_dispatch": steps,
           "wall_ms": wall}
    prof = _profile(dispatch, 10)
    out.update(prof)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    dispatch()
    end.record()
    end.synchronize()
    out["event_ms_per_dispatch"] = start.elapsed_time(end)

    def pipelined(n: int = 20) -> float:
        """ms per dispatch with one dispatch always in flight."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = graph.launch(kp, vp, True)
        for _ in range(n - 1):
            following = graph.launch(kp, vp, True)
            graph.collect(handle)
            handle = following
        graph.collect(handle)
        return (time.perf_counter() - t0) * 1e3 / n

    out["pipelined_wall_ms"] = statistics.median(pipelined()
                                                 for _ in range(3))
    launch = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = graph.launch(kp, vp, True)
        launch.append((time.perf_counter() - t0) * 1e3)
        graph.collect(handle)
    out["launch_host_ms"] = statistics.median(launch[2:])
    out["per_step"] = {
        "wall_ms": wall / steps,
        "traced_wall_ms": prof["traced_wall_ms"] / steps,
        "device_busy_ms": prof["device_busy_ms"] / steps,
        "launches": prof["launches"] / steps,
        "launches_by_kind": {kind: n / steps for kind, n
                             in prof["launches_by_kind"].items()},
        "api_calls": prof["api_calls"] / steps,
        "idle_share": prof["idle_share"],
        "pipelined_wall_ms": out["pipelined_wall_ms"] / steps}
    return out


def prefill_case(params, cfg, dev, p: int, s: int) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (p, s), generator=gen,
                           device=dev)
    lens = torch.full((p,), s, dtype=torch.int32, device=dev)

    def call():
        llama_prefill_last(params, tokens, cfg, kv_lengths=lens)

    out = {"case": "prefill", "group": p, "bucket": s,
           "wall_ms": _wall_ms(call, 2, 5)}
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    out["host_ms"] = statistics.median(host[1:])
    out.update(_profile(call, 3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "torch_profile.json"))
    args = ap.parse_args()
    dev = resolve_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    results = []
    with torch.no_grad():
        for lens in ([21, 151, 401, 901], [1000] * 8):
            for kv_dtype in ("bf16", "int8"):
                for case in (decode_case, graph_case):
                    results.append(case(params, cfg, dev, lens, kv_dtype))
                    print(json.dumps(results[-1]), flush=True)
        for p, s in ((1, 32), (1, 1024), (4, 512), (8, 512)):
            results.append(prefill_case(params, cfg, dev, p, s))
            print(json.dumps(results[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
