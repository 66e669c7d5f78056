#!/usr/bin/env python3
"""Which collectives ``gloo`` takes on CUDA tensors: two ranks on one card.

    python3 scripts/torch_gloo_cuda_probe.py [--out FILE]

Each case runs in a fresh pair of rank processes on ``cuda:0`` joined
over ``gloo`` (a case that kills a rank cannot hide the next one):
``torch.distributed``'s own ``all_reduce`` (bf16, float32),
``broadcast``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``send`` / ``recv`` and ``batch_isend_irecv`` on CUDA tensors, then the
port's ``parallel/comm.py`` functions that the trainer calls on them
(``ppermute``, ``send`` / ``recv``, ``all_reduce_``, ``gather``). Per
case and rank: the exit code, whether the result is right, the error.
One JSON line per case to stdout; all of them to ``--out`` (default
``build/gloo_cuda_probe.json``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: case -> what each rank must hold after it (rank r starts from
#: arange(8) + 10 r, float32)
WANT = {
    "all_reduce_bf16": [[10.0 + 2 * i for i in range(8)]] * 2,
    "all_reduce_f32": [[10.0 + 2 * i for i in range(8)]] * 2,
    "broadcast": [[float(i) for i in range(8)]] * 2,
    "all_gather_into_tensor": [[float(i) for i in range(8)]
                               + [10.0 + i for i in range(8)]] * 2,
    "reduce_scatter_tensor": [[10.0, 12.0, 14.0, 16.0],
                              [18.0, 20.0, 22.0, 24.0]],
    "send_recv": [None, [float(i) for i in range(8)]],
    "batch_isend_irecv": [[10.0 + i for i in range(8)],
                          [float(i) for i in range(8)]],
    "comm_ppermute": [[10.0 + i for i in range(8)],
                      [float(i) for i in range(8)]],
    "comm_send_recv": [None, [float(i) for i in range(8)]],
    "comm_all_reduce_": [[10.0 + 2 * i for i in range(8)]] * 2,
    "comm_gather": [[float(i) for i in range(8)]
                    + [10.0 + i for i in range(8)]] * 2,
}


def _case(case: str, rank: int, x, dist, comm, mesh):
    import torch
    if case == "all_reduce_bf16":
        y = x.bfloat16()
        dist.all_reduce(y)
        return y.float()
    if case == "all_reduce_f32":
        dist.all_reduce(x)
        return x
    if case == "broadcast":
        dist.broadcast(x, 0)
        return x
    if case == "all_gather_into_tensor":
        out = torch.empty(16, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out
    if case == "reduce_scatter_tensor":
        out = torch.empty(4, device=x.device)
        dist.reduce_scatter_tensor(out, x)
        return out
    if case == "send_recv":
        if rank == 0:
            dist.send(x, 1)
            return None
        dist.recv(x, 0)
        return x
    if case == "batch_isend_irecv":
        y = torch.zeros_like(x)
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, 1 - rank),
                 dist.P2POp(dist.irecv, y, 1 - rank)]):
            req.wait()
        return y
    if case == "comm_ppermute":
        return comm.ppermute(x, mesh, "sp", [(0, 1), (1, 0)])
    if case == "comm_send_recv":
        if rank == 0:
            comm.send(x, mesh, "sp", 1)
            return None
        return comm.recv(x, mesh, "sp", 0)
    if case == "comm_all_reduce_":
        return comm.all_reduce_(x, mesh, "sp")
    return comm.gather(x, mesh, "sp", 0)


def _rank(case: str, rank: int, rendezvous: str, out_dir: str) -> None:
    path = Path(out_dir, f"{case}.{rank}.json")
    try:
        sys.path.insert(0, str(ROOT))
        import torch
        import torch.distributed as dist
        from gofr_tpu_torch.parallel import comm
        from gofr_tpu_torch.parallel.mesh import (create_mesh,
                                                  init_process_group)
        dev = init_process_group("cuda", f"file://{rendezvous}", rank=rank,
                                 world_size=2, backend="gloo", timeout_s=30)
        mesh = create_mesh({"sp": 2})
        x = torch.arange(8, device=dev, dtype=torch.float32) + 10 * rank
        got = _case(case, rank, x, dist, comm, mesh)
        torch.cuda.synchronize(dev)
        got = None if got is None else got.cpu().tolist()
        path.write_text(json.dumps({"ok": got == WANT[case][rank],
                                    "got": got}))
        dist.destroy_process_group()
    except BaseException:
        path.write_text(json.dumps({"ok": False,
                                    "error": traceback.format_exc()[-600:]}))
        os._exit(1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "build"
                                             / "gloo_cuda_probe.json"))
    args = parser.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {(case, r): ctx.Process(
            target=_rank, args=(case, r, f"{tmp}/{case}.rdv", tmp))
            for case in WANT for r in range(2)}
        for p in procs.values():
            p.start()
        end = time.monotonic() + 120
        for p in procs.values():
            p.join(max(0.0, end - time.monotonic()))
        for case in WANT:
            line = {"case": case, "torch": torch.__version__}
            for r in range(2):
                p = procs[(case, r)]
                if p.is_alive():
                    p.kill()
                    p.join(5)
                f = Path(tmp, f"{case}.{r}.json")
                line[f"rank{r}"] = {"exit": p.exitcode,
                                    **(json.loads(f.read_text())
                                       if f.exists() else {"ok": False})}
            lines.append(line)
            print(json.dumps(line), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
