#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gofr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exit != 0):

1. env     — the card (``nvidia-smi`` name and power limit), torch/CUDA.
2. build   — builds the three CUDA kernels from ``gofr_tpu_torch/csrc/``
             (one ``nvcc`` per source, in parallel) into ``build/``.
3. kernels — each kernel (flash prefill, paged decode, paged chunk)
             against its plain PyTorch version on the card, at the
             serving path's shapes, bf16, ragged lengths; CUDA event
             times (median of 25 after warm-up) of the kernel, the plain
             version and one PyTorch library call of the same function,
             and the roofline bound of the work. A planted fault (a
             shortened length, a dropped or swapped page) must fail the
             same check.
4. model   — Llama-3.2-1B shape (``llama3_1b``), random bf16 weights from
             seed 0: ``llama_prefill_last`` + 3 ``llama_decode_step_paged``
             steps through the kernels and through the plain versions on
             the same inputs; logits must agree, and a planted fault in
             the decode kernel's lengths must not. Then
             ``llama_prefill_chunk_paged``: kernels vs plain on a chunk
             with and without history (a planted history fault must
             fail), and an 1800-token prompt walked in two chunks vs
             whole-prompt flash prefill.
5. serve   — the port's HTTP app (``gofr_tpu_torch.serving.app``) on a
             free port: 4 concurrent greedy ``POST /chat`` requests, an
             1801-token prompt (walked in chunks, not clamped), then 3
             requests that hit the prefix cache; every kernel's launch
             counter, zeroed just before, must rise.

Then a ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line and, as
the last line, ``{"ok": true, "device": {...}}``. Exits non-zero with no
result when CUDA is absent or the package is not beside this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain, per element: |out - ref| <= atol + RTOL |ref|
# (+ P_ROUND · sum_j p_j |v_j| / l for flash and paged chunk). Both
# sides round their output to bf16 (each <= 2^-8 relative), so RTOL =
# 2^-7. Flash and paged chunk also round each softmax weight p_j to
# bf16 (<= 2^-8 relative) before P·V
# while l sums the float32 weights: its output moves by at most 2^-8 of
# the attention average of |V|, which for a row that averages
# cancelling values is far above 2^-8 |out|. The atol covers the
# float32 exp and summation-order differences.
RTOL = 2.0 ** -7
P_ROUND = 2.0 ** -8
ATOL = 1e-3
LOGITS_TOL = 0.1    # see phase_model


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median CUDA-event time of one call of ``fn``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(out, ref, extra=0.0) -> tuple[float, list]:
    """Max abs err, and per leading index (batch row or slot) the worst
    |out - ref| / (ATOL + RTOL |ref| + extra): above 1 fails."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    ratio = diff / (ATOL + RTOL * ref.abs() + extra)
    return diff.max().item(), ratio.flatten(1).amax(1).tolist()


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time the card could take: the larger of flops over the bf16
    tensor-core peak and bytes over the HBM rate, in ms."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_env() -> tuple[str, dict]:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    env = {"phase": "env", "nvidia_smi": smi_line,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(env)
    return smi_line, env


def phase_build() -> None:
    from gofr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": secs, "ptxas": _build.build_logs})


def _flash_case(dev, gen):
    import torch
    p, s, hq, hkv, d = 4, 512, 32, 8, 64
    q = torch.randn(p, s, hq, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(p, s, hkv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(p, s, hkv, d, generator=gen, device=dev).bfloat16()
    lens = torch.tensor([1, 200, 511, 512], dtype=torch.int32, device=dev)
    return q, k, v, lens


def kernel_flash(dev, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from gofr_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_plain)
    q, k, v, lens = _flash_case(dev, gen)
    p, s, hq, d = q.shape
    hkv = k.shape[2]
    out = flash_attention(q, k, v, kv_lengths=lens)
    ref = flash_attention_plain(q, k, v, kv_lengths=lens)
    p_term = P_ROUND * flash_attention_plain(q, k, v.abs(),
                                             kv_lengths=lens).float()
    err, ratios = check(out, ref, p_term)
    # planted fault: every kv_len above 1 short by one column (for the
    # 512-long row only its last query row sees the change)
    fault = flash_attention(q, k, v, kv_lengths=(lens - 1).clamp(min=1))
    _, fault_ratios = check(fault, ref, p_term)
    emit({"phase": "kernel_check", "name": "flash_attention",
          "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
          "p_round": P_ROUND,
          "worst_ratio_per_row": ratios,
          "planted_fault_worst_ratio_per_row": fault_ratios})
    if max(ratios) > 1.0:
        raise AssertionError(f"flash kernel vs plain: worst err/limit per "
                             f"row {ratios} > 1")
    if any(r <= 1.0 for n, r in zip(lens.tolist(), fault_ratios) if n > 1):
        raise AssertionError(f"flash check passed a planted fault: "
                             f"{fault_ratios}")
    # the library yardstick: SDPA with GQA expanded and the same mask,
    # built outside the timed call
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    r = torch.arange(s, device=dev)
    mask = ((r[None, :] <= r[:, None])[None]
            & (r[None, None, :] < lens[:, None, None]))[:, None]
    ms = time_ms(lambda: flash_attention(q, k, v, kv_lengths=lens))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v,
                                                     kv_lengths=lens))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    # flops: 2 products x 2 flops x D per visible (row, col) per q head;
    # row r of batch b sees min(r + 1, kv_len) columns.
    # bytes: q and out once, the K/V rows below kv_len once, lengths.
    lens_l = lens.tolist()
    visible = sum(min(r_ + 1, n) for n in lens_l for r_ in range(s))
    flops = 4.0 * d * hq * visible
    nbytes = (2 * p * s * hq * d * 2 + 2 * sum(min(n, s) for n in lens_l)
              * hkv * d * 2 + 4 * p)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {"name": "flash_attention", "route": "cuda",
           "source": "gofr_tpu_torch/csrc/flash_attention.cu",
           "replaces": "gofr_tpu/ops/flash_attention.py:33",
           "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": "kernel", "shape": "P=4 S=512 Hq=32 Hkv=8 D=64 bf16, "
          "kv_lengths 1/200/511/512", "kernel_ms": ms, **row})
    return row


def kernel_paged(dev, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from gofr_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    from gofr_tpu_torch.ops.paged_kv import slot_view
    b, hq, hkv, d, pg, n_pages = 8, 32, 8, 64, 64, 256
    lens_l = [0, 1, 63, 64, 65, 1500, 300, 1000]
    mp = -(-max(lens_l) // pg)
    tables = torch.full((b, mp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(2))
    used = 0
    for i, n in enumerate(lens_l):
        need = -(-n // pg)
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    tables = tables.to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
    kp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    out = paged_decode_attention(q, kp, vp, tables, lens)
    ref = paged_decode_attention_plain(q, kp, vp, tables, lens)
    err, ratios = check(out, ref)
    # planted fault: each slot longer than a page loses the rows of its
    # partial last page (65 -> 64, 300 -> 256, 1000 -> 960, 1500 -> 1472)
    cut = torch.where(lens > pg, lens - lens % pg, lens)
    fault = paged_decode_attention(q, kp, vp, tables, cut)
    _, fault_ratios = check(fault, ref)
    emit({"phase": "kernel_check", "name": "paged_decode_attention",
          "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
          "worst_ratio_per_slot": ratios,
          "planted_fault_worst_ratio_per_slot": fault_ratios})
    if max(ratios) > 1.0 or out[0].abs().max().item() != 0.0:
        raise AssertionError(f"paged decode kernel vs plain: worst "
                             f"err/limit per slot {ratios} > 1, or the "
                             f"zero-length slot is not exactly zero")
    if any(r <= 1.0 for a, b, r in zip(lens.tolist(), cut.tolist(),
                                       fault_ratios) if a != b):
        raise AssertionError(f"paged decode check passed a planted tail-"
                             f"page fault: {fault_ratios}")
    # library yardstick: SDPA on the gathered view, GQA expanded
    view_k = slot_view(kp, tables).repeat_interleave(hq // hkv, dim=2)
    view_v = slot_view(vp, tables).repeat_interleave(hq // hkv, dim=2)
    kt = view_k.transpose(1, 2).contiguous()
    vt = view_v.transpose(1, 2).contiguous()
    mask = (torch.arange(mp * pg, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    ms = time_ms(lambda: paged_decode_attention(q, kp, vp, tables, lens))
    plain_ms = time_ms(lambda: paged_decode_attention_plain(
        q, kp, vp, tables, lens))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kt, vt, attn_mask=mask))
    # bytes: K and V rows below each length (2·len·hd·2 per KV head), q,
    # out, the table entries walked, lengths; flops: 4·hd per row per q head
    nbytes = (sum(2 * n * hkv * d * 2 for n in lens_l) + 2 * b * hq * d * 2
              + sum(-(-n // pg) for n in lens_l) * 4 + 4 * b)
    flops = sum(4.0 * n * hq * d for n in lens_l)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "gofr_tpu_torch/csrc/paged_decode.cu",
           "replaces": "gofr_tpu/ops/paged_attention.py:134",
           "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": "kernel", "shape": "B=8 Hq=32 Hkv=8 hd=64 pg=64 Np=256 "
          "bf16, lengths 0/1/63/64/65/1500/300/1000, OOB-padded tables",
          "kernel_ms": ms, **row})
    return row


def kernel_chunk(dev, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from gofr_tpu_torch.ops.paged_attention import (
        paged_chunk_attention, paged_chunk_attention_plain)
    from gofr_tpu_torch.ops.paged_kv import slot_view
    # the serve path's shapes: llama3_1b heads, 64-row pages, tables of
    # max_seq 2048 / 64 = 32 pages padded with the OOB id, a 1024-row
    # chunk (the widest bucket); (history, chunk) per slot: a fresh
    # prompt, the second chunk of an 1801-token walk, a prefix-cache
    # suffix of 6 rows after 896 cached rows, an empty pad row
    sq, hq, hkv, d, pg, n_pages, mp = 1024, 32, 8, 64, 64, 128, 32
    hists, clens = [0, 1024, 896, 0], [1024, 777, 6, 0]
    b = len(hists)
    tables = torch.full((b, mp), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(3))
    used = 0
    for i, (h, c) in enumerate(zip(hists, clens)):
        need = -(-(h + c) // pg)
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    # planted fault: each slot's last history page swapped for a page no
    # slot holds
    bad = tables.clone()
    for i, h in enumerate(hists):
        if h:
            bad[i, (h - 1) // pg] = int(perm[used + i])
    tables, bad = tables.to(dev), bad.to(dev)
    q = torch.randn(b, sq, hq, d, generator=gen, device=dev).bfloat16()
    kp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(hkv, n_pages, pg, d, generator=gen, device=dev).bfloat16()
    hist = torch.tensor(hists, dtype=torch.int32, device=dev)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    args = (q, kp, vp, tables, hist, clen)
    out = paged_chunk_attention(*args)
    ref = paged_chunk_attention_plain(*args)
    # the kernel rounds P to bf16 as flash does: same per-element limit
    p_term = P_ROUND * paged_chunk_attention_plain(
        q, kp, vp.abs(), tables, hist, clen).float()
    err, ratios = check(out, ref, p_term)
    fault = paged_chunk_attention(q, kp, vp, bad, hist, clen)
    _, fault_ratios = check(fault, ref, p_term)
    padding = torch.arange(sq, device=dev)[None, :] >= clen[:, None]
    pad_finite = bool(torch.isfinite(out[padding].float()).all().item())
    empty_zero = out[3].abs().max().item() == 0.0
    emit({"phase": "kernel_check", "name": "paged_chunk_attention",
          "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
          "p_round": P_ROUND, "worst_ratio_per_slot": ratios,
          "planted_fault_worst_ratio_per_slot": fault_ratios,
          "padding_rows_finite": pad_finite,
          "empty_slot_exact_zeros": empty_zero})
    if max(ratios) > 1.0 or not pad_finite or not empty_zero:
        raise AssertionError(f"paged chunk kernel vs plain: worst err/limit "
                             f"per slot {ratios} > 1, padding finite "
                             f"{pad_finite}, empty slot zero {empty_zero}")
    if any(r <= 1.0 for h, r in zip(hists, fault_ratios) if h):
        raise AssertionError(f"paged chunk check passed a planted history-"
                             f"page fault: {fault_ratios}")
    # library yardstick: SDPA on the gathered view, GQA expanded and the
    # same visibility as a boolean mask, all built outside the timed call
    group = hq // hkv
    qt = q.transpose(1, 2).contiguous()
    kt = slot_view(kp, tables).repeat_interleave(group, dim=2) \
        .transpose(1, 2).contiguous()
    vt = slot_view(vp, tables).repeat_interleave(group, dim=2) \
        .transpose(1, 2).contiguous()
    pos = torch.arange(mp * pg, device=dev)[None, None, :]
    q_pos = (hist[:, None] + torch.arange(sq, device=dev)[None, :])[:, :, None]
    mask = ((pos <= q_pos) & (pos < (hist + clen)[:, None, None]))[:, None]
    ms = time_ms(lambda: paged_chunk_attention(*args))
    plain_ms = time_ms(lambda: paged_chunk_attention_plain(*args))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    # flops: 4·hd per visible (row, position) per q head; chunk row i of
    # slot b sees history + i + 1 positions (within the table).
    # bytes: the q rows of each chunk once, all of out once, the K/V rows
    # of history + chunk once, the table entries walked, both lengths.
    visible = sum(min(h + i + 1, mp * pg) for h, c in zip(hists, clens)
                  for i in range(c))
    flops = 4.0 * d * hq * visible
    kv_rows = [min(h + c, mp * pg) for h, c in zip(hists, clens)]
    nbytes = (sum(clens) * hq * d * 2 + b * sq * hq * d * 2
              + 2 * sum(kv_rows) * hkv * d * 2
              + sum(-(-n // pg) for n in kv_rows) * 4 + 8 * b)
    bound_ms, bound_by = bound(flops, nbytes)
    row = {"name": "paged_chunk_attention", "route": "cuda",
           "source": "gofr_tpu_torch/csrc/paged_chunk.cu",
           "replaces": "gofr_tpu/ops/paged_attention.py:357",
           "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": "kernel", "shape": "B=4 Sq=1024 Hq=32 Hkv=8 hd=64 pg=64 "
          "Np=128 Mp=32 bf16, (history, chunk) (0, 1024) (1024, 777) "
          "(896, 6) (0, 0), OOB-padded tables", "kernel_ms": ms, **row})
    return row


def phase_model(dev) -> None:
    """llama3_1b prefill + 3 paged decode steps, kernels vs plain, and
    once more with a planted fault.

    LOGITS_TOL: the paths differ only inside attention, where the
    kernels round P to bf16 and sum in another order; each attention
    output then differs by about one bf16 ulp (~0.4 % relative). Through
    16 residual layers that stays a perturbation of order 1e-2 of the
    final hidden state, and the logits (rms-normed hidden · embeddings
    of std 0.02 over dim 2048, so |logit| ~ 1) move by a few 1e-2.
    The planted fault passes ``lengths - 1`` to the decode kernel (the
    newest row is not attended); its decode steps must differ from the
    plain path by more than LOGITS_TOL, so the limit sits between a
    sound reading and a faulty one.
    """
    from unittest import mock

    import torch
    from gofr_tpu_torch.models import llama as llama_module
    from gofr_tpu_torch.models.llama import (LlamaConfig, llama_decode_step_paged,
                                             llama_init, llama_prefill_last,
                                             make_pool)
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention
    from gofr_tpu_torch.ops.paged_kv import scatter_chunk

    def short_by_one(q, k_pool, v_pool, tables, lengths):
        return paged_decode_attention(q, k_pool, v_pool, tables, lengths - 1)

    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    p, s, pg = 2, 256, 64
    tokens = torch.randint(0, cfg.vocab_size, (p, s), generator=gen,
                           device=dev)
    lens = torch.tensor([256, 100], dtype=torch.int32, device=dev)
    mp = -(-(s + 3) // pg)
    tables = torch.arange(p * mp, dtype=torch.int32,
                          device=dev).reshape(p, mp)
    results: dict = {}
    step_tokens: list = []   # both paths decode the kernel path's picks
    t0 = time.perf_counter()
    for run in ("auto", "plain", "fault"):
        impl = "plain" if run == "plain" else "auto"
        logits, (k, v) = llama_prefill_last(params, tokens, cfg,
                                            kv_lengths=lens,
                                            implementation=impl)
        kp, vp = make_pool(cfg, p * mp, pg, dev)
        zeros = torch.zeros_like(lens)
        scatter_chunk(kp, tables, k, zeros, lens)
        scatter_chunk(vp, tables, v, zeros, lens)
        results[run] = [logits]
        cur = lens.clone()
        for step in range(3):
            if run == "auto":
                step_tokens.append(results["auto"][-1].argmax(-1))
            with mock.patch.object(llama_module, "paged_decode_attention",
                                   short_by_one if run == "fault"
                                   else paged_decode_attention):
                logits, kp, vp = llama_decode_step_paged(
                    params, step_tokens[step], kp, vp, tables, cur, cfg,
                    implementation=impl)
            results[run].append(logits)
            cur = cur + 1
    torch.cuda.synchronize()

    def diffs(run):
        return [(a - b).abs().max().item()
                for a, b in zip(results[run], results["plain"])]

    errs, fault_errs = diffs("auto"), diffs("fault")[1:]
    finite = all(torch.isfinite(t).all().item()
                 for ts in results.values() for t in ts)
    scale = max(t.abs().max().item() for t in results["plain"])
    emit({"phase": "model", "config": "llama3_1b bf16 random seed 0",
          "prefill": "P=2 S=256 kv_lengths 256/100", "decode_steps": 3,
          "max_abs_logits_diff_per_call": errs, "max_abs_logit": scale,
          "tolerance": LOGITS_TOL, "finite": finite,
          "planted_fault_diff_per_decode_step": fault_errs,
          "seconds": time.perf_counter() - t0})
    if not finite or max(errs) > LOGITS_TOL:
        raise AssertionError(f"model kernels vs plain: logits diff {errs} "
                             f"(tolerance {LOGITS_TOL}), finite={finite}")
    if min(fault_errs) <= LOGITS_TOL:
        raise AssertionError(f"model check passed a planted fault: decode "
                             f"logits diff {fault_errs} <= {LOGITS_TOL}")
    del params, results
    torch.cuda.empty_cache()


def phase_model_chunk(dev) -> None:
    """llama3_1b through ``llama_prefill_chunk_paged``, at full width.

    (a) A two-row chunk — a fresh 128-token prompt, and 100 tokens after
    a 640-row history (prefilled through flash and written to the pool)
    — through the kernels and through the plain versions, each on its
    own copy of the pools: logits within LOGITS_TOL (the reasoning of
    ``phase_model`` holds: the paths differ only inside attention, by
    bf16 rounding of P). A planted fault passes ``history - 1`` to the
    chunk kernel, so each row of the history slot loses its own K/V row
    and sees one stale one; its logits must differ by more.
    (b) An 1800-token prompt walked in two chunks (1024 rows, then the
    rest padded to the 1024 bucket, as the engine walks it) against
    ``llama_prefill_last`` over the whole prompt, both through the
    kernels: the chunk kernel against the flash kernel on the same work,
    within LOGITS_TOL.
    """
    from unittest import mock

    import torch
    from gofr_tpu_torch.models import llama as llama_module
    from gofr_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                             llama_prefill_chunk_paged,
                                             llama_prefill_last, make_pool)
    from gofr_tpu_torch.ops.paged_attention import paged_chunk_attention
    from gofr_tpu_torch.ops.paged_kv import scatter_chunk

    def history_short_by_one(q, k_pool, v_pool, tables, history, chunk):
        return paged_chunk_attention(q, k_pool, v_pool, tables,
                                     (history - 1).clamp(min=0), chunk)

    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama_init(cfg, gen, dev)
    t0 = time.perf_counter()
    pg, hist_len, s = 64, 640, 128
    mp = -(-(hist_len + s) // pg)
    tables = torch.arange(2 * mp, dtype=torch.int32, device=dev).reshape(2, mp)
    history = torch.randint(0, cfg.vocab_size, (1, hist_len), generator=gen,
                            device=dev)
    _, (k, v) = llama_prefill_last(
        params, history, cfg,
        kv_lengths=torch.tensor([hist_len], dtype=torch.int32, device=dev))
    kp0, vp0 = make_pool(cfg, 2 * mp, pg, dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    full = torch.tensor([hist_len], dtype=torch.int32, device=dev)
    scatter_chunk(kp0, tables[1:], k, zero, full)
    scatter_chunk(vp0, tables[1:], v, zero, full)
    tokens = torch.randint(0, cfg.vocab_size, (2, s), generator=gen,
                           device=dev)
    offsets = torch.tensor([0, hist_len], dtype=torch.int32, device=dev)
    lens = torch.tensor([s, 100], dtype=torch.int32, device=dev)
    logits = {}
    for run in ("auto", "plain", "fault"):
        with mock.patch.object(llama_module, "paged_chunk_attention",
                               history_short_by_one if run == "fault"
                               else paged_chunk_attention):
            logits[run], _, _ = llama_prefill_chunk_paged(
                params, tokens, kp0.clone(), vp0.clone(), tables, offsets,
                lens, cfg, implementation="plain" if run == "plain"
                else "auto")
    diff = (logits["auto"] - logits["plain"]).abs().amax(1).tolist()
    fault = (logits["fault"] - logits["plain"]).abs().amax(1).tolist()

    n, first = 1800, 1024
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    whole, _ = llama_prefill_last(
        params, prompt, cfg,
        kv_lengths=torch.tensor([n], dtype=torch.int32, device=dev))
    mp_w = -(-n // pg)
    kp, vp = make_pool(cfg, mp_w, pg, dev)
    walk_tables = torch.arange(mp_w, dtype=torch.int32, device=dev)[None]
    for off in (0, first):
        chunk = torch.zeros(1, first, dtype=torch.long, device=dev)
        piece = prompt[:, off:off + first]
        chunk[:, :piece.shape[1]] = piece
        walked, kp, vp = llama_prefill_chunk_paged(
            params, chunk, kp, vp, walk_tables,
            torch.tensor([off], dtype=torch.int32, device=dev),
            torch.tensor([piece.shape[1]], dtype=torch.int32, device=dev), cfg)
    walk_diff = (walked - whole).abs().max().item()
    torch.cuda.synchronize()
    finite = all(torch.isfinite(t).all().item()
                 for t in (*logits.values(), whole, walked))
    emit({"phase": "model_chunk", "config": "llama3_1b bf16 random seed 0",
          "chunk": "rows (offset 0, 128 tokens) and (offset 640, 100 "
          "tokens), pg 64", "max_abs_logits_diff_per_row": diff,
          "planted_fault_diff_per_row": fault,
          "walk": "1800 tokens in chunks of 1024 + 776 vs whole-prompt "
          "flash prefill", "walk_max_abs_logits_diff": walk_diff,
          "tolerance": LOGITS_TOL, "finite": finite,
          "seconds": time.perf_counter() - t0})
    if not finite or max(diff) > LOGITS_TOL or walk_diff > LOGITS_TOL:
        raise AssertionError(f"model chunk path: kernel vs plain {diff}, "
                             f"walk vs whole prompt {walk_diff} (tolerance "
                             f"{LOGITS_TOL}), finite={finite}")
    if fault[1] <= LOGITS_TOL:
        raise AssertionError(f"model chunk check passed a planted fault: "
                             f"history-row logits diff {fault[1]} <= "
                             f"{LOGITS_TOL}")
    del params, logits, kp, vp, kp0, vp0
    torch.cuda.empty_cache()


def _post(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(dev, smi_line: str) -> dict:
    """The port's app on a free port, serving ``app.serve_config`` (8
    slots, max_seq 2048, 64-row pages, buckets to 1024, prefix cache
    on). Three waves of greedy ``POST /chat``, 32 new tokens each:

    1. the four concurrent prompts of 21 / 151 / 401 / 901 tokens (flash
       group prefill, then paged decode);
    2. one 1801-token prompt alone: wider than every bucket, so it walks
       in two chunks (1024, 777) through the chunk kernel, unclamped;
    3. three concurrent prompts that share a page-aligned prefix with a
       wave-1 prompt or the long one (896, 384 and 1792 cached rows):
       prefix-cache hits that walk only their suffix.

    Every kernel's launch counter is zeroed before wave 1 and read after
    wave 3; each must have risen."""
    import torch
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import (paged_chunk_attention,
                                                    paged_decode_attention)
    from gofr_tpu_torch.serving.app import build_engine, build_server
    kernels = {"flash_attention": flash_attention,
               "paged_decode_attention": paged_decode_attention,
               "paged_chunk_attention": paged_chunk_attention}
    engine = build_engine(LlamaConfig.llama3_1b(), device=dev, seed=0)
    server = build_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    engine.start()
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/chat"
    words = ("the quick brown fox jumps over the lazy dog while a paged "
             "cache keeps every token of the conversation in place ")
    story = ("a long request walks through the chunk kernel one bucket at "
             "a time and every page it writes stays in the pool ")
    long_prompt = (story * 30)[:1800]
    waves = [[(words * 20)[:n] for n in (20, 150, 400, 900)], [long_prompt],
             [(words * 20)[:900] + " but the question at the end is new",
              (words * 20)[:400] + " and this ending differs",
              long_prompt[:1795] + " until a new ending"]]
    # each hit's twin in `answers`: the 901-token, 401-token and long prompts
    twins = [3, 2, 4]
    answers: list = []
    walls = []

    def ask(prompt, out, i):
        out[i] = _post(url, {"prompt": prompt, "max_tokens": 32,
                             "temperature": 0})

    try:
        for fn in kernels.values():
            fn.launches = 0
        for wave in waves:
            got: list = [None] * len(wave)
            t0 = time.perf_counter()
            workers = [threading.Thread(target=ask, args=(p, got, i))
                       for i, p in enumerate(wave)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=600)
            walls.append(time.perf_counter() - t0)
            answers += got
        launches = {name: fn.launches for name, fn in kernels.items()}
        stats = dict(engine.stats)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    if any(a is None or a[0] != 200 for a in answers):
        raise AssertionError(f"serve: not every answer was 200: {answers}")
    usage = [a[1]["data"]["usage"] for a in answers]
    n_tokens = [len(a[1]["data"]["tokens"]) for a in answers]
    if n_tokens != [32] * len(answers):
        raise AssertionError(f"serve: token counts {n_tokens} != 32 each")
    if usage[4]["prompt_tokens"] != len(long_prompt) + 1:
        raise AssertionError(f"serve: the long prompt was cut to "
                             f"{usage[4]['prompt_tokens']} tokens")
    if stats["prefix_hits"] < len(waves[2]):
        raise AssertionError(f"serve: {stats['prefix_hits']} prefix hits for "
                             f"{len(waves[2])} sharing requests")
    if min(launches.values()) < 1:
        raise AssertionError(f"serve: a kernel never launched: {launches}")
    ttft = [u["ttft_ms"] for u in usage]
    emit({"phase": "serve", "card": smi_line, "requests": len(answers),
          "waves": [len(w) for w in waves], "wall_s_per_wave": walls,
          "prompt_tokens": [u["prompt_tokens"] for u in usage],
          "completion_tokens": n_tokens, "ttft_ms": ttft,
          "prefix_hit_ttft_ms_vs_twin": [[ttft[5 + i], ttft[t]]
                                         for i, t in enumerate(twins)],
          "prefix_hits": stats["prefix_hits"],
          "prefix_evictions": stats["prefix_evictions"],
          "decode_tokens": stats["decode_tokens"],
          "decode_s": stats["decode_s"],
          "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
          "prefill_calls": stats["prefill_calls"],
          "prefill_s": stats["prefill_s"], "launches": launches})
    del engine
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import gofr_tpu_torch  # noqa: F401 — fails outside the repository
    from gofr_tpu_torch.device import resolve_device
    dev = resolve_device("cuda")
    smi_line, env = phase_env()
    phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = [kernel_flash(dev, gen), kernel_paged(dev, gen),
            kernel_chunk(dev, gen)]
    phase_model(dev)
    phase_model_chunk(dev)
    launches = phase_serve(dev, smi_line)
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                 "count": env["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
