#!/usr/bin/env python3
"""Where the PyTorch port's train step spends its time on one CUDA GPU.

    python3 scripts/torch_train_profile.py [--steps 2] [--out FILE]

Builds chip_smoke.py's ``train_llama`` cell: ``LlamaConfig.llama3_1b()``
(bf16, random weights from seed 0), ``make_train_state`` /
``make_train_step`` on a ``{dp: 1, tp: 1}`` mesh over a one-rank
``nccl`` group, one fixed 4 x 512 batch. After three warm-up steps it
prints one JSON line with

- ``step_wall_ms``: the host clock around whole steps, synchronised
  (median of 5), and the same for the parts of a step run alone:
  ``forward_ms`` (the forward and the loss without gradients),
  ``loss_and_grads_ms`` (forward + backward + the dp sum) and
  ``update_ms`` (the clip, AdamW and the new parameters);
- ``device_busy_ms``: the summed device time of the kernels one step
  ran (``torch.profiler`` over ``--steps`` steps), and ``idle_share`` =
  1 - busy / wall;
- ``busy_ms_by_kind`` and ``launches_by_kind``: device time and kernel
  count per step grouped as GEMMs (cuBLAS / CUTLASS names), NCCL,
  softmax, reductions, elementwise and the rest, and the top kernels by
  device time.

The card's name and power limit (``nvidia-smi``) lead the output; the
line is also written to ``--out`` (default ``build/torch_train_profile
.json``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gofr_tpu_torch.device import resolve_device  # noqa: E402
from gofr_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from gofr_tpu_torch.parallel.mesh import (create_mesh,  # noqa: E402
                                          init_process_group)
from gofr_tpu_torch.parallel.train import (_nll,  # noqa: E402
                                           apply_updates, make_train_state,
                                           make_train_step)

KINDS = (("nccl", ("nccl",)),
         ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")),
         ("softmax", ("softmax",)),
         ("reduce", ("reduce",)),
         ("elementwise", ("elementwise",)))


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _wall_ms(fn, n: int = 5) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "torch_train_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = resolve_device("cuda")
    cfg = LlamaConfig.llama3_1b()
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(dev, f"file://{tmp}/rendezvous")
        try:
            mesh = create_mesh({"dp": 1, "tp": 1})
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            state, opt = make_train_state(gen, cfg, mesh)
            gen.manual_seed(1)
            toks = torch.randint(0, cfg.vocab_size, (4, 513), generator=gen,
                                 device=dev)
            batch = (toks[:, :-1].contiguous(), toks[:, 1:].contiguous(),
                     torch.ones((4, 512), dtype=torch.int32, device=dev))
            step = make_train_step(cfg, mesh)
            for _ in range(3):
                state, _ = step(state, *batch)
            holder = {"state": state}

            def whole():
                holder["state"], _ = step(holder["state"], *batch)

            def forward():
                with torch.no_grad():
                    _nll(step.forward(holder["state"].params, batch[0]),
                         batch[1]).mean()

            grads = {}

            def backward():
                grads["g"] = step.loss_and_grads(holder["state"].params,
                                                 *batch)[1]

            def update():
                upd, _ = opt.update(grads["g"], holder["state"].opt_state,
                                    holder["state"].params)
                apply_updates(holder["state"].params, upd)

            out = {"case": "train_step", "nvidia_smi": smi,
                   "batch": [4, 512], "step_wall_ms": _wall_ms(whole),
                   "forward_ms": _wall_ms(forward),
                   "loss_and_grads_ms": _wall_ms(backward)}
            out["update_ms"] = _wall_ms(update)
            grads.clear()
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.steps):
                    whole()
                torch.cuda.synchronize()
            busy, launches, by_name = {}, {}, {}
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                ms = (e.time_range.end - e.time_range.start) / 1e3
                kind = _kind(e.name)
                busy[kind] = busy.get(kind, 0.0) + ms / args.steps
                launches[kind] = launches.get(kind, 0) + 1 / args.steps
                by_name[e.name] = by_name.get(e.name, 0.0) + ms / args.steps
            total = sum(busy.values())
            out.update({
                "device_busy_ms": total,
                "idle_share": 1 - total / out["step_wall_ms"],
                "busy_ms_by_kind": busy,
                "launches_by_kind": {k: round(v) for k, v in
                                     launches.items()},
                "top_kernels_ms": dict(sorted(
                    ((k[:90], v) for k, v in by_name.items()),
                    key=lambda kv: -kv[1])[:15])})
        finally:
            dist.destroy_process_group()
    line = json.dumps(out)
    print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
