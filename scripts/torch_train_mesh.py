#!/usr/bin/env python3
"""The trainer on a mesh across separate cards over NCCL.

    python3 scripts/torch_train_mesh.py [--world 4] [--out FILE]

Runs ``chip_smoke.py``'s ``train_mesh`` jobs (a)-(d) with one rank a
card (``cuda:<rank>``), joined over ``nccl``: (a) ``llama3_1b`` uncut,
bf16, dense steps at ``{dp: 2, tp: 2}`` (``{tp: 2}`` at ``--world 2``);
(b) GPipe at ``{dp: 2, pp: 2}``, M = 4; (c) the MoE model at
``mixtral_8x7b`` width, 1 layer, at ``{dp: 2, ep: 2}``; (d) ring
attention at sp = ``--world``. The references are the port's one-rank
steps on card 0, computed first (``chip_smoke._mesh_reference``); the
checks, the planted faults and the figures are the phase's
(``chip_smoke._mesh_checks``, ``_mesh_figures``). At ``--world 2`` the
ring's reversed-hop fault is the same permutation as the right one and
is not planted. (e), the sharded checkpoint, gathers every leaf on the
host over the mesh's groups: a ``gloo`` run's (the card phase), not
this one's.

The card's name and power limit (``nvidia-smi``) lead the output; one
JSON line per job, then the summary, go to stdout, and all of them to
``--out`` (default ``build/torch_train_mesh.json``, git-ignored). The
exit code is 1 when a check fails or a planted fault passes.

``--device cpu`` rehearses the same flow on the CPU over ``gloo`` at
``LlamaConfig.tiny()`` width (no card; the numbers are not a card's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=4, choices=(2, 4))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", default=str(ROOT / "build"
                                             / "torch_train_mesh.json"))
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ["GOFR_TELEMETRY"] = "false"
    import torch
    import chip_smoke as cs
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.models.moe import MoEConfig
    cuda = args.device == "cuda"
    if cuda:
        if torch.cuda.device_count() < args.world:
            print(f"torch_train_mesh: {args.world} cards needed, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(smi, flush=True)
        cs.phase_build()
        cfg, moe_cfg = (LlamaConfig.llama3_1b(),
                        MoEConfig.mixtral_8x7b().scaled(n_layers=1))
        shapes = {"ring_shape": cs.MESH_RING_SHAPE,
                  "batch_shape": (cs.TRAIN_B, cs.TRAIN_S),
                  "moe_shape": (cs.MESH_MOE_B, cs.MESH_MOE_S)}
        dev = torch.device("cuda", 0)
    else:
        smi = "cpu rehearsal (gloo): no card"
        cfg = LlamaConfig.tiny().scaled(dtype=torch.bfloat16,
                                        tie_embeddings=True)
        moe_cfg = MoEConfig.tiny().scaled(n_layers=1, dtype=torch.bfloat16)
        shapes = {"ring_shape": (1, 64, 4, 8), "batch_shape": (4, 16),
                  "moe_shape": (4, 8)}
        dev = torch.device("cpu")
    t0 = time.perf_counter()
    ref: dict = {}
    with tempfile.TemporaryDirectory(prefix="gofr_mesh_") as tmp:
        def make_plan() -> dict:
            ref.update(cs._mesh_reference(dev, cfg, moe_cfg,
                                          directory=Path(tmp), **shapes))
            cs._free(dev)
            return {"cfg": cfg, "moe_cfg": moe_cfg, "dir": Path(tmp),
                    "device": "cuda:{rank}" if cuda else "cpu",
                    "backend": "nccl" if cuda else "gloo",
                    "timeout_s": cs.MESH_TIMEOUT_S,
                    "jobs": ["a", "b", "c", "d"], "resume": False,
                    "planted_rank": 0, "axes": cs._mesh_axes(args.world),
                    "batch": ref.pop("batch"),
                    "pipe_batch": ref.pop("pipe_batch"),
                    "moe_batch": ref.pop("moe_batch")}

        ranks, plan, _ = cs._run_ranks(args.world, make_plan, 900.0)
    failed, planted = cs._mesh_checks(ranks, ref, plan)
    rows, seq = shapes["batch_shape"]
    figs = cs._mesh_figures(ranks, ref, plan, {
        "a": rows * seq, "b": 2 * rows * seq,
        "c": shapes["moe_shape"][0] * shapes["moe_shape"][1]})
    lines = [{"job": job, "card": smi, "mesh": plan["axes"][job], **fig}
             for job, fig in figs.items()]
    lines.append({"script": "torch_train_mesh", "card": smi,
                  "world": args.world, "backend": ranks[0]["backend"],
                  "devices": [r["device"] for r in ranks],
                  "launches": ranks[0]["launches"],
                  "wall_s": time.perf_counter() - t0,
                  "failed_checks": failed, "planted": planted})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    for line in lines:
        print(json.dumps(line), flush=True)
    bad = {k: v for k, v in failed.items() if v}
    missed = [k for k, v in planted.items() if not v]
    if bad or missed:
        print(f"torch_train_mesh: failed checks {bad}, planted faults that "
              f"passed: {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
