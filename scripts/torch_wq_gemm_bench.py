#!/usr/bin/env python3
"""Device times of the weight-dequantizing GEMM (``ops/quant.wq_gemm``)
at llama3_1b's quantized products, beside its bound, cuBLAS bf16 on the
weights dequantized beforehand, and optionally another checkout's
kernel on the same card in the same process:

    python scripts/torch_wq_gemm_bench.py --parent <parent checkout>
    python scripts/torch_wq_gemm_bench.py --splits      # S = 1, 2, 4, 8
    python scripts/torch_wq_gemm_bench.py --sweep       # M = 16 .. 2048

Products (name, K, N): wq 2048 -> 2048, wk 2048 -> 512, w1 2048 -> 8192,
w2 8192 -> 2048 (bf16 out) and the head 2048 -> 128256 (float32 out),
int8 and int4 codes, N(0, 1/K) weights quantized on the card, x ~ N(0,
1) bf16, at M = 1, 8 and 128 rows (``--rows``). Every time is
``chip_smoke.device_ms(cold=True)``: ``torch.profiler`` over 25 calls,
a 64 MiB buffer zeroed before each so the weights come from HBM. The
bound is ``chip_smoke.bound``: codes, scales, x and y over 3.35 TB/s,
or the products over the bf16 peak. ``--parent``: the root of a
checkout whose ``gofr_tpu_torch`` is imported under another name; its
kernel takes its own layout (``[K, N]`` layer codes and ``trans``
before the ``[N, K]`` redesign, else ``[N, K]``). ``--splits``: the
kernel at each S of the cluster split and 1 or 2 consumer warpgroups a
block as well as at ``wq_splits`` / ``wq_groups``'s.
``--sweep``: the kernel against the plain route (dequantize, then
``torch.matmul``) at w1's shape, M = 16 .. 2048, which sets
``ops/quant.M_MAX``. One JSON line a row, headed by the card's
``nvidia-smi`` name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

#: (name, K, N, head)
PRODUCTS = (("wq", 2048, 2048, False), ("wk", 2048, 512, False),
            ("w1", 2048, 8192, False), ("w2", 8192, 2048, False),
            ("head", 2048, 128256, True))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _parent_quant(root: Path):
    """``gofr_tpu_torch.ops.quant`` of the checkout at ``root``, as the
    package ``gofr_tpu_torch_parent`` (its relative imports resolve
    inside it; its kernels build under its own ``build/``)."""
    pkg = root / "gofr_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "gofr_tpu_torch_parent", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["gofr_tpu_torch_parent"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("gofr_tpu_torch_parent.ops.quant")


def _parent_call(pq, wt, head: bool, form: str):
    """The parent's weight and call: ``[N, K]`` codes if its wrapper
    has no ``trans``, else its own layout for the product."""
    qfn = pq.quantize_int8 if form == "int8" else pq.quantize_int4
    f32 = {"out_dtype": __import__("torch").float32} if head else {}
    if "trans" not in inspect.signature(pq.wq_gemm).parameters:
        w = qfn(wt, axis=1)
        return lambda x: pq.wq_gemm(x, w, **f32)
    if head:
        w = qfn(wt, axis=1)
        return lambda x: pq.wq_gemm(x, w, trans=True, **f32)
    w = qfn(wt.t().contiguous(), axis=0)
    return lambda x: pq.wq_gemm(x, w, **f32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rows", default="1,8,128")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_wq_gemm_bench: needs a CUDA device", file=sys.stderr)
        return 2
    smoke = _load(HERE / "chip_smoke.py", "chip_smoke")
    from gofr_tpu_torch.ops import quant as Q
    pq = _parent_quant(Path(args.parent).resolve()) if args.parent else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = [int(r) for r in args.rows.split(",")]

    def ms(fn):
        return smoke.device_ms(fn, cold=True)

    for form in ("int8", "int4"):
        qfn = Q.quantize_int8 if form == "int8" else Q.quantize_int4
        int4 = form == "int4"
        for name, k, n, head in PRODUCTS:
            wt = (torch.randn(n, k, generator=gen, device=dev)
                  * k ** -0.5).bfloat16()
            w = qfn(wt, axis=1)
            parent = _parent_call(pq, wt, head, form) if pq else None
            deq = (Q.codes_of(w).bfloat16() * w["s"].bfloat16()).t()
            del wt
            out = torch.float32 if head else None
            for m in rows:
                x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
                nbytes = (w["q"].numel() + 4 * n + 2 * m * k
                          + m * n * (4 if head else 2))
                bound_ms, bound_by = smoke.bound(2.0 * m * n * k, nbytes)
                row = {"form": form, "name": name, "m": m, "k": k, "n": n,
                       "groups": Q.wq_groups(m, n),
                       "splits": Q.wq_splits(m, n, k, int4=int4,
                                             groups=Q.wq_groups(m, n)),
                       "device_ms": ms(lambda: Q.wq_gemm(x, w,
                                                          out_dtype=out)),
                       "bound_ms": bound_ms, "bound_by": bound_by}
                if head:
                    row["cublas_device_ms"] = ms(lambda: torch.mm(
                        x, deq, out_dtype=torch.float32))
                else:
                    row["cublas_device_ms"] = ms(lambda: torch.matmul(x, deq))
                if parent is not None:
                    row["parent_device_ms"] = ms(lambda: parent(x))
                if args.splits:
                    y = torch.empty(m, n, device=dev, dtype=out
                                    or torch.bfloat16)
                    for g in (1, 2):
                        for s in (1, 2, 4, 8):
                            def call(s=s, g=g):
                                rc = Q._kernel(int4)(
                                    x.data_ptr(), w["q"].data_ptr(),
                                    w["s"].data_ptr(), y.data_ptr(), m, n,
                                    k, int(head), s, g,
                                    torch.cuda.current_stream().cuda_stream)
                                assert rc == 0, rc
                            row[f"G{g}S{s}_device_ms"] = ms(call)
                print(json.dumps(row), flush=True)
            del w, deq, parent
            torch.cuda.empty_cache()
    if args.sweep:
        for form in ("int8", "int4"):
            qfn = Q.quantize_int8 if form == "int8" else Q.quantize_int4
            w = qfn((torch.randn(8192, 2048, generator=gen, device=dev)
                     * 2048 ** -0.5).bfloat16(), axis=1)
            for m in (16, 32, 64, 128, 256, 512, 1024, 2048):
                x = torch.randn(m, 2048, generator=gen, device=dev).bfloat16()
                print(json.dumps({
                    "sweep": "w1", "form": form, "m": m,
                    "kernel_device_ms": ms(lambda: Q.wq_gemm(x, w)),
                    "plain_device_ms": ms(lambda: Q.wq_gemm_plain(x, w))}),
                    flush=True)
            del w
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
