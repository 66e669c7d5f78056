"""Causal flash prefill attention: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of ``gofr_tpu/ops/flash_attention.py``).

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``gofr_tpu/ops/flash_attention.py:_flash_kernel``; its source says what
bounds it on the H100 and what the design does about it. It takes what
the TPU kernel takes: bf16, float16 or float32, any head dim that is a
multiple of 4 from 16 to 256, any GQA group. The routes
(``_build.attention_route``): bf16 and float16 on the tensor cores
(``wgmma``, the head dim staged padded to a multiple of 64), float32 in
float32 FMAs (``csrc/attn_simt.cuh``: TF32 is not JAX's float32).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import xla_attention

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").gofr_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kv_lengths: torch.Tensor | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The plain version: the masked softmax of ``xla_attention``
    (causal, per-row kv lengths)."""
    return xla_attention(q, k, v, causal=True, kv_lengths=kv_lengths,
                         scale=scale)


def _check(q, k, v, kv_lengths) -> int:
    """What the kernels take (raise on anything else): q [B, Sq, Hq, D]
    and k, v [B, Skv, Hkv, D] of one type, bf16, float16 or float32, with
    D a multiple of 4 from 16 to 256; contiguous, on one device, aligned
    to four elements (the kernels stage rows in copies of at least four
    elements); int32 [B] kv_lengths. Returns the type's ``dtype``
    code."""
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: k/v must be [B, Skv, Hkv, D] "
                         f"matching q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    _build.check_head_dim("flash_attention", d)
    code = _build.dtype_code("flash_attention", "q", q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} must be {q.dtype} "
                            f"(q's type), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"flash_attention: {name} must be aligned to "
                             f"4 elements")
    if kv_lengths.dtype != torch.int32 or kv_lengths.shape != (b,) \
            or kv_lengths.device != q.device \
            or not kv_lengths.is_contiguous():
        raise ValueError("flash_attention: kv_lengths must be a contiguous "
                         f"int32 [B] tensor on {q.device}")
    return code


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_lengths: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Causal flash attention. q [B,Sq,Hq,D]; k,v [B,Skv,Hkv,D].

    CPU tensors run the plain version. CUDA tensors launch the kernel
    (bf16, float16 or float32; contiguous; D a multiple of 4 from 16 to
    256) or raise — there is no fallback.
    A ``kv_lengths[b] == 0`` row gives zeros here and the uniform
    average of V in the plain version; the engine never prefills one.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lengths=kv_lengths,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, sq, hq, d = q.shape
    if kv_lengths is None:
        kv_lengths = torch.full((b,), k.shape[1], dtype=torch.int32,
                                device=q.device)
    code = _check(q, k, v, kv_lengths)
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   kv_lengths.data_ptr(), out.data_ptr(), b, sq, k.shape[1],
                   hq, k.shape[2], d, code, scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention.launches += 1
    return out


#: kernel launches since the last reset (a plain integer; set it to 0
#: to start counting)
flash_attention.launches = 0
