#!/usr/bin/env python3
"""SHA-256 of each kernel's output on seeded inputs, for the port at
``--root`` (default: this checkout), and with ``--time`` each kernel's
device time. Run it on two checkouts on the same card, in one command,
to show which kernels a change leaves bit for bit as they were and what
it does to their times:

    python scripts/torch_kernel_digest.py --time --root <parent checkout>
    python scripts/torch_kernel_digest.py --time

Shapes: the smoke's (``chip_smoke.py``) flash, paged decode, paged chunk
and paged tree cases, with seeded random inputs, at head dim 64 and
again at 128 (``_d128``); the paged kernels on a bf16 pool and on
``quantize_pool`` of it (``_int8``); and the KV write kernel's three
entries, both pool forms (the written pools hashed, and the rotated q):
every bf16 kernel that runs on the tensor-core route. A head dim or type
that route does not hold is left out, so a change that adds other cases
hashes the same calls as its parent. Prints one JSON
line, kernel name -> digest; with ``--time`` a second one, kernel name
-> median device ms per call (``chip_smoke.device_ms``: ``torch.profiler``
over 25 calls after warm-up, host time left out), headed by the card's
``nvidia-smi`` name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _smoke():
    """This checkout's ``chip_smoke.py`` (its timer), loaded by path so
    that a ``--root`` checkout's copy never stands in for it."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    # registered first: a dataclass of the module looks itself up there
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--time", action="store_true",
                    help="also print each kernel's device time")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    device_ms = _smoke().device_ms if args.time else None
    sys.path.insert(0, str(root))
    import torch
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention,
                                                    paged_tree_attention)
    from gofr_tpu_torch.ops.paged_kv import quantize_pool
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

    calls = {}      # kernel name -> a call of it on its inputs
    for d, tag in ((64, ""), (128, "_d128")):
        _attention_calls(calls, tag, d, randn, table, ints, gen, dev,
                         quantize_pool, flash_attention,
                         paged_decode_attention, paged_chunk_attention,
                         paged_tree_attention)
        _write_calls(calls, tag, d, randn, ints, dev, quantize_pool)
    outs = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    print(json.dumps({"root": str(root), **{
        name: _digest(out) for name, out in outs.items()}}), flush=True)
    if device_ms is not None:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"root": str(root), "card": card,
                          "device_ms": {name: device_ms(call)
                                        for name, call in calls.items()}}),
              flush=True)
    return 0


def _digest(out) -> str:
    """SHA-256 of a tensor's bytes (a bf16 tensor as int16, as before the
    write kernels joined), or of a tuple's or a quantized pool's leaves
    in order."""
    import torch
    h = hashlib.sha256()
    leaves = [out] if isinstance(out, torch.Tensor) else [
        t for part in out for t in (
            part.values() if isinstance(part, dict) else [part])]
    for t in leaves:
        t = t.contiguous().cpu()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 \
            else t.view(torch.uint8)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _attention_calls(calls, tag, d, randn, table, ints, gen, dev,
                     quantize_pool, flash_attention, paged_decode_attention,
                     paged_chunk_attention, paged_tree_attention) -> None:
    """The four attention kernels at head dim ``d``, named with ``tag``."""
    import torch
    q, k, v = randn(4, 512, 32, d), randn(4, 512, 8, d), randn(4, 512, 8, d)
    lens = ints([1, 200, 511, 512])
    calls["flash_attention" + tag] = lambda: flash_attention(
        q, k, v, kv_lengths=lens)
    kp, vp = randn(8, 256, 64, d), randn(8, 256, 64, d)
    pools = {"": (kp, vp), "_int8": (quantize_pool(kp), quantize_pool(vp))}
    d_lens = [0, 1, 63, 64, 65, 1500, 300, 1000]
    d_q, d_tab, d_len = randn(8, 32, d), table(d_lens, 64, 256, 24), \
        ints(d_lens)
    hists, clens = [0, 1024, 896, 0], [1024, 777, 6, 0]
    c_q = randn(4, 1024, 32, d)
    c_args = (table([h + c for h, c in zip(hists, clens)], 64, 256, 32),
              ints(hists), ints(clens))
    hists, clens = [0, 1, 63, 64, 65, 1500, 300, 1000], [0, 7, 9, 5, 6, 9, 1, 8]
    masks = torch.randint(0, 2 ** 31 - 1, (8, 16), generator=gen, device=dev,
                          dtype=torch.int32) | 1
    t_q = randn(8, 16, 32, d)
    t_args = (table([h + c for h, c in zip(hists, clens)], 64, 256, 32),
              ints(hists), ints(clens), masks)
    for suffix, (kpool, vpool) in pools.items():
        calls["paged_decode_attention" + suffix + tag] = \
            lambda kpool=kpool, vpool=vpool: paged_decode_attention(
                d_q, kpool, vpool, d_tab, d_len)
        calls["paged_chunk_attention" + suffix + tag] = \
            lambda kpool=kpool, vpool=vpool: paged_chunk_attention(
                c_q, kpool, vpool, *c_args)
        calls["paged_tree_attention" + suffix + tag] = \
            lambda kpool=kpool, vpool=vpool: paged_tree_attention(
                t_q, kpool, vpool, *t_args)


def _write_calls(calls, tag, d, randn, ints, dev, quantize_pool) -> None:
    """The KV write kernel's entries at head dim ``d``, both pool forms:
    each call writes a fresh copy of its pools and returns them (and the
    fused entry's rotated q)."""
    import torch
    from gofr_tpu_torch.ops.paged_kv import (kv_write, rope_kv_write,
                                             scatter_chunk_kv)
    from gofr_tpu_torch.ops.rope import rope_frequencies
    n_layers, hkv, n_pages, pg = 2, 8, 32, 64
    base = [randn(n_layers, hkv, n_pages, pg, d) for _ in range(2)]
    n = 8
    pids = ints([3, 7, n_pages, 0, 31, -1, 12, 5])
    offs = ints([0, 63, 5, 17, 1, 2, 64, 40])
    positions = ints([0, 1, 63, 64, 500, 1000, 2047, 8191])
    q, k, v = randn(n, 32, d), randn(n, hkv, d), randn(n, hkv, d)
    inv = rope_frequencies(d, device=dev)
    slabs = [randn(n_layers, 3, 96, hkv, d) for _ in range(2)]
    tables = ints([[4, 1], [0, 9], [n_pages, n_pages]])
    offsets, chunk = ints([5, 0, 0]), ints([90, 21, 1])
    for suffix, quant in (("", False), ("_int8", True)):
        def fresh(quant=quant):
            pools = [t.clone() for t in base]
            return [quantize_pool(t) for t in pools] if quant else pools

        def rope(fresh=fresh):
            kp, vp = fresh()
            return rope_kv_write(q, k, v, positions, inv, kp, vp, 1, pids,
                                 offs), kp, vp

        def slab(fresh=fresh):
            return scatter_chunk_kv(*fresh(), tables, *slabs, offsets, chunk)

        def rows(fresh=fresh):
            return kv_write(*fresh(), 0, pids, offs, k, v)

        calls["rope_kv_write" + suffix + tag] = rope
        calls["scatter_chunk_kv" + suffix + tag] = slab
        calls["kv_write" + suffix + tag] = rows


if __name__ == "__main__":
    sys.exit(main())
