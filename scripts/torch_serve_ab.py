#!/usr/bin/env python3
"""Run one checkout's ``chip_smoke.py`` ``serve`` phase on the card: its
kernels built from its sources, the three waves of ``POST /chat``
through its app on ``llama3_1b`` (random weights, seed 0), and the
phase's JSON line (decode tokens/s without the graph captures, TTFT,
launches).

    python3 scripts/torch_serve_ab.py [--root <checkout>]

``--root`` defaults to this checkout. To compare two commits on one
card, unpack the other one under ``build/`` (``git archive <commit>
gofr_tpu_torch chip_smoke.py | tar -x -C build/parent_root``) and run
the two in turns in one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[1]),
                        help="the checkout whose port and smoke to run")
    root = Path(parser.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    from gofr_tpu_torch.device import resolve_device
    dev = resolve_device("cuda")
    print(f"root {root}", flush=True)
    smi_line, _ = smoke.phase_env()
    smoke.phase_build()
    smoke.phase_serve(dev, smi_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
