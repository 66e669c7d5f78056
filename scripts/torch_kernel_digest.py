#!/usr/bin/env python3
"""SHA-256 of each bf16 kernel's output on seeded inputs, for the port
at ``--root`` (default: this checkout). Run it on two checkouts on the
same card to show that a change leaves the bf16 kernels bit for bit as
they were:

    python scripts/torch_kernel_digest.py --root <parent checkout>
    python scripts/torch_kernel_digest.py

Shapes: the smoke's (``chip_smoke.py``) flash, paged decode, paged chunk
and paged tree cases, with seeded random inputs. Prints one JSON line,
kernel name -> digest. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention,
                                                    paged_tree_attention)
    if not torch.cuda.is_available():
        print("torch_kernel_digest: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    def table(rows, pg, n_pages, mp):
        t = torch.full((len(rows), mp), n_pages, dtype=torch.int32)
        used = 0
        for i, n in enumerate(rows):
            need = -(-n // pg)
            t[i, :need] = torch.arange(used, used + need, dtype=torch.int32)
            used += need
        return t.to(dev)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    outs = {}
    q, k, v = randn(4, 512, 32, 64), randn(4, 512, 8, 64), randn(4, 512, 8, 64)
    outs["flash_attention"] = flash_attention(q, k, v,
                                              kv_lengths=ints([1, 200, 511, 512]))
    kp, vp = randn(8, 256, 64, 64), randn(8, 256, 64, 64)
    lens = [0, 1, 63, 64, 65, 1500, 300, 1000]
    outs["paged_decode_attention"] = paged_decode_attention(
        randn(8, 32, 64), kp, vp, table(lens, 64, 256, 24), ints(lens))
    hists, clens = [0, 1024, 896, 0], [1024, 777, 6, 0]
    outs["paged_chunk_attention"] = paged_chunk_attention(
        randn(4, 1024, 32, 64), kp, vp,
        table([h + c for h, c in zip(hists, clens)], 64, 256, 32),
        ints(hists), ints(clens))
    hists, clens = [0, 1, 63, 64, 65, 1500, 300, 1000], [0, 7, 9, 5, 6, 9, 1, 8]
    masks = torch.randint(0, 2 ** 31 - 1, (8, 16), generator=gen, device=dev,
                          dtype=torch.int32) | 1
    outs["paged_tree_attention"] = paged_tree_attention(
        randn(8, 16, 32, 64), kp, vp,
        table([h + c for h, c in zip(hists, clens)], 64, 256, 32),
        ints(hists), ints(clens), masks)
    torch.cuda.synchronize()
    print(json.dumps({"root": str(root), **{
        name: hashlib.sha256(out.cpu().view(torch.int16).numpy().tobytes())
        .hexdigest() for name, out in outs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
