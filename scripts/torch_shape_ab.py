#!/usr/bin/env python3
"""Device time of the attention kernels at the other head dims and types
(the rows of ``chip_smoke.py``'s ``kernel_shapes`` for ``SHAPE_CASES``)
for the port of each ``--root`` checkout, in turns, in one command: the
way to set a change's times beside its parent's on one card.

    python3 scripts/torch_shape_ab.py --root <parent> --root . --root . \\
        --root <parent>

Each root runs in a process of its own (the two packages share a name),
in the order given, with this checkout's ``chip_smoke.py`` driving its
package: every row is checked against its plain version with its
planted faults as in the smoke, and its kernel call is timed,
``device_ms`` (``torch.profiler``, ``chip_smoke.device_ms``) and ``ms``
(CUDA events, the wrapper included); the plain and library calls are not
timed. A root whose package predates ``_build.attention_route`` is held
to the limits without the P-rounding term (its kernels keep P in
float32). Prints one JSON line per root ({"root", "card", "device_ms":
{row: ms}, "ms": {row: ms}}) and a last line with each row's device ms
per root, in the order run. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
MARK = "torch_shape_ab "


def _smoke():
    """This checkout's ``chip_smoke.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def child(root: Path) -> int:
    """Time the rows for the package at ``root``; print them after MARK."""
    cs = _smoke()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("torch_shape_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from gofr_tpu_torch.ops import _build
    if not hasattr(_build, "attention_route"):
        cs._route = lambda kernel, dtype, d: {"kernel_route": "parent",
                                              "source": "parent"}

    def timed_row(fields, shape, dtype, check_out, call, *rest, **kw):
        return {**fields, "device_ms": cs.device_ms(call),
                "ms": cs.time_ms(call)}

    cs._shape_row = timed_row
    smi_line, _ = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda")
    rows = [row for case in cs.SHAPE_CASES
            for row in cs.kernel_shapes(dev, *case)]
    print(MARK + json.dumps({
        "root": str(root), "card": smi_line,
        "device_ms": {r["name"]: r["device_ms"] for r in rows},
        "ms": {r["name"]: r["ms"] for r in rows}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(Path(args.root[0]).resolve())
    runs = []
    for root in args.root:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             "--root", str(Path(root).resolve())],
            capture_output=True, text=True, check=False)
        lines = [ln[len(MARK):] for ln in proc.stdout.splitlines()
                 if ln.startswith(MARK)]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"torch_shape_ab: root {root} failed "
                             f"(exit {proc.returncode})")
        print(lines[-1], flush=True)
        runs.append(json.loads(lines[-1]))
    names = list(runs[0]["device_ms"])
    print(json.dumps({"roots": [r["root"] for r in runs],
                      "device_ms": {n: [r["device_ms"].get(n) for r in runs]
                                    for n in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
