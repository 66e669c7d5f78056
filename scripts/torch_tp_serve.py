#!/usr/bin/env python3
"""Tensor-parallel serving across separate cards over NCCL.

    python3 scripts/torch_tp_serve.py [--world 4] [--layers 8] [--out FILE]

Runs ``chip_smoke.py``'s ``serve_tp`` cell (``LlamaConfig.llama3_70b()``
at full width, ``--layers`` of its 80 layers, bf16, random weights from
seed 0; ``_tp_engine_config``: the paged layout through its view,
speculation on; ``_tp_workload``: a batch of four, a prefix hit, a
prompt walked past the widest bucket, speculative passes) on
``--world`` processes, one card each, joined over ``nccl``:

- the reference: the unsharded engine on rank 0's card alone (the other
  ranks wait);
- tp = 2 (ranks 0-1) and, with four cards, tp = 4 (ranks 0-3):
  ``llama_engine(mesh=create_mesh({"tp": t}))`` on each rank's shards,
  rank 0 serving and the others following (``serving.lockstep``), the
  decode dispatch a captured CUDA graph holding the all-reduces.

Per run: every request's tokens against the reference's (equal, or
parting at a near tie by ``chip_smoke._near_tie_judge``), TTFT p50 of
the batch of four, the walked prompt's TTFT, the batch's decode
tokens/s, graph captures and replays, each rank's weight bytes. The
card's name and power limit (``nvidia-smi``) lead the output; one JSON
line goes to stdout and to ``--out`` (default ``build/torch_tp_serve
.json``, git-ignored). The exit code is 1 when a check fails.

``--device cpu`` rehearses the same flow on the CPU over ``gloo`` at
``LlamaConfig.tiny()`` width with 4 KV heads (no graph; the numbers are
not a card's).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _config(args):
    import torch
    import chip_smoke as cs
    from gofr_tpu_torch.models.llama import LlamaConfig
    if args.device == "cpu":
        return LlamaConfig.tiny().scaled(vocab_size=4096, max_seq=2048,
                                         n_kv_heads=4, dtype=torch.bfloat16)
    return cs._tp_config(args.layers)


def _rank(rank: int, args, rendezvous: str, out_dir: str) -> None:
    """One rank process: the reference on rank 0, then every tp size
    that fits the world."""
    try:
        sys.path.insert(0, str(ROOT))
        import torch
        import torch.distributed as dist
        import chip_smoke as cs
        from gofr_tpu_torch.parallel.mesh import (create_mesh,
                                                  init_process_group)
        from gofr_tpu_torch.serving.glue import llama_engine
        from gofr_tpu_torch.serving.lockstep import follow
        cuda = args.device != "cpu"
        dev = init_process_group(f"cuda:{rank}" if cuda else "cpu",
                                 f"file://{rendezvous}", rank=rank,
                                 world_size=args.world,
                                 timeout_s=cs.TP_TIMEOUT_S)
        cfg = _config(args)
        ec = cs._tp_engine_config(cfg)
        workload = cs._tp_workload(cfg.vocab_size)
        control = dist.new_group(backend="gloo")
        out: dict = {"rank": rank, "device": str(dev),
                     "backend": dist.get_backend()}

        def free():
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

        if rank == 0:
            engine = llama_engine(cs._tp_params(cfg, dev), cfg, ec,
                                  device=dev)
            out["reference"] = cs._tp_serve(engine, workload)
            engine.stop()
            del engine
            free()
        dist.barrier(group=control)
        for tp in (t for t in (2, 4) if t <= args.world):
            mesh = create_mesh({"tp": tp})
            if mesh.rank is not None:
                engine = llama_engine(cs._tp_params(cfg, dev), cfg, ec,
                                      mesh=mesh)
                free()
                if rank == mesh.leader:
                    try:
                        run = cs._tp_serve(engine, workload)
                    finally:
                        engine.stop()
                    run["weight_bytes"] = cs._tree_bytes(engine.params)
                    out[f"tp{tp}"] = run
                else:
                    out[f"tp{tp}_follower_ops"] = follow(engine)
                    out[f"tp{tp}_weight_bytes"] = cs._tree_bytes(
                        engine.params)
                del engine
                free()
            dist.barrier(group=control)
        dist.destroy_process_group()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=str(ROOT / "build"
                                             / "torch_tp_serve.json"))
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ["GOFR_TELEMETRY"] = "false"
    import torch
    import torch.multiprocessing as mp
    import chip_smoke as cs
    if args.device != "cpu":
        if torch.cuda.device_count() < args.world:
            print(f"torch_tp_serve: {args.world} cards needed, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(smi, flush=True)
        cs.phase_build()
    else:
        smi = "cpu rehearsal (gloo): no card"
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, args, f"{tmp.name}/rdv",
                                             tmp.name))
             for r in range(args.world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(1800)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [Path(tmp.name, f"rank{r}.err").read_text()
              for r in range(args.world)
              if Path(tmp.name, f"rank{r}.err").exists()]
    if errors or any(p.exitcode != 0 for p in procs):
        print("\n".join(errors), file=sys.stderr)
        return 1
    lead = json.loads(Path(tmp.name, "rank0.json").read_text())
    cfg = _config(args)
    dev = torch.device("cuda:0" if args.device != "cpu" else "cpu")
    judge = cs._near_tie_judge(cs._tp_params(cfg, dev), cfg)
    ref = lead["reference"]
    runs, faults = {}, []
    for name in ("tp2", "tp4"):
        if name not in lead:
            continue
        run, ties = lead[name], {}
        faults += cs._tp_token_faults(name, run, ref, judge, ties)
        runs[name] = {k: run[k] for k in (
            "ttft_ms_batch4_p50", "ttft_ms_walk", "decode_tok_s_batch4",
            "wall_s", "warmup_s", "stats", "weight_bytes")}
        runs[name]["near_ties"] = ties
        if args.device != "cpu" and run["stats"]["graph_captures"] < 1:
            faults.append(f"{name}: no decode graph captured")
    line = {"script": "torch_tp_serve", "card": smi, "world": args.world,
            "model": f"llama3_70b width, {cfg.n_layers} of 80 layers"
            if args.device != "cpu" else "tiny", "backend": lead["backend"],
            "reference": {k: ref[k] for k in (
                "ttft_ms_batch4_p50", "ttft_ms_walk", "decode_tok_s_batch4",
                "wall_s", "warmup_s", "stats")},
            "runs": runs, "faults": faults,
            "seconds": time.perf_counter() - t0}
    text = json.dumps(line)
    print(text, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text + "\n")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
