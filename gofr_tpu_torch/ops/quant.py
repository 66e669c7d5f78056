"""Weight-only int8 / int4 quantization (counterpart of
``gofr_tpu/ops/quant.py``) and the wrapper of the weight-dequantizing
GEMM kernel ``csrc/wq_gemm.cu``.

A quantized matrix is the dict ``{"q": codes, "s": float32 scales}``
with the JAX package's keys. Scales are per output channel: max-abs over
the contraction axis over 127 (int8) or 8 (int4, the full two's
complement range [-8, 7]), so the scale applies after the product.

One layout. In the port's trees every quantized matrix is stored
output-major, ``[N, K]`` (output channels by the contraction, the
contraction contiguous): layer matrices ``[L, out, in]`` with scales
``[L, out, 1]``, an untied head ``[V, D]`` with ``[V, 1]``, the
embedding ``[V, D]`` with per-row scales ``[V, 1]`` (they serve the
gather and, tied, the LM head). ``quantize_llama_int8`` / ``_int4``
transpose each layer matrix and an untied head (plain leaves keep JAX's
``[in, out]``) before they quantize, reducing ``in``, so the codes are
JAX's codes transposed bit for bit. Every quantized product is
``x @ W^T`` (:func:`qmatmul_t`), one kernel layout for all of them.
:func:`quantize_int8` / :func:`quantize_int4` keep JAX's contract on one
matrix (codes in the weight's shape), and :func:`qmatmul` of a quantized
``[K, N]`` matrix stays JAX's function on CPU tensors — on CUDA it
raises, naming the ``[N, K]`` layout.

Storage: int8 codes are an ``int8`` tensor. int4 codes are **packed two
per byte along the last axis** (K in the port's trees) into a ``uint8``
tensor whose last axis is half the weight's: byte ``c`` holds element
``2c`` in its low nibble and ``2c + 1`` in its high nibble, each a
4-bit two's-complement value (sign-extended on unpack). The dtype of
``q`` tells the two forms apart. :func:`quantized_bytes` counts what is
stored: half a byte per int4 code, one per int8 code, four per scale.

Products route by the number of rows M (a fixed rule, not a fallback):
on CUDA the kernel takes every product with ``M <= M_MAX`` (the decode
step's ``max_batch`` rows and the tree verify's ``B x width`` rows) and
every LM head (``out_dtype=torch.float32``) whatever its M; only the
wide backbone products of a group prefill or a chunk walk run the plain
version, which dequantizes the codes into a scratch and calls
``torch.matmul`` — the plain large product XLA also computes outside
any Pallas kernel. CPU tensors run the plain version.

The plain version's rounding is JAX's ``qmatmul``: the backbone
``y = x @ q`` in ``x``'s dtype (float32 accumulation inside the GEMM),
then ``y * s`` with ``s`` cast to that dtype; the head (``out_dtype=
float32``) a float32 product times the float32 scale; the gather
``q[idx] * s[idx]`` in the target dtype.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from . import _build

#: the kernel takes backbone products of at most this many rows — the
#: decode step (max_batch = 8), the tree verify (8 rows x a 16-node
#: width bucket) and group prefills of up to 512 tokens; wider products
#: dequantize and call torch.matmul. The crossing measured on the H100
#: at w1's shape (scripts/torch_wq_gemm_bench.py --sweep): int8 between
#: 512 and 1024 rows (int4 past 2048)
M_MAX = 512
#: the scale's divisor per form
_QMAX = {"int8": 127.0, "int4": 8.0}


def _quantize(w: torch.Tensor, axis: int, form: str) -> tuple:
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    # tensor divisors: PyTorch's CUDA kernels divide by a Python scalar
    # as a product with its reciprocal, one bit off the IEEE quotient
    # that the CPU and the JAX package compute
    scale = amax.clamp(min=1e-8) / torch.full_like(amax, _QMAX[form])
    lo = -127 if form == "int8" else -8
    codes = torch.round(wf / scale).clamp(lo, 127 if form == "int8" else 7)
    return codes.to(torch.int8).contiguous(), scale.contiguous()


def quantize_int8(w: torch.Tensor, *, axis: int = 0) -> dict:
    """Symmetric per-channel int8: ``axis`` is the REDUCED axis (the
    contraction axis of the later product), so scales are per output
    channel. w [.., in, out] with axis=-2 -> s [.., 1, out]. Codes
    ``round(w / s)`` (half to even) clipped to [-127, 127], scale
    ``max(amax, 1e-8) / 127``: bit for bit JAX's ``quantize_int8``."""
    codes, scale = _quantize(w, axis, "int8")
    return {"q": codes, "s": scale}


def quantize_int4(w: torch.Tensor, *, axis: int = 0) -> dict:
    """Per-channel int4 over [-8, 7]: scale ``max(amax, 1e-8) / 8``,
    codes clipped to [-8, 7] (a weight equal to +amax pins to +7), then
    packed two per byte along the last axis (:func:`pack_int4`). The
    codes are JAX's ``quantize_int4``'s bit for bit."""
    codes, scale = _quantize(w, axis, "int4")
    return {"q": pack_int4(codes), "s": scale}


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], last axis even -> uint8, last axis halved:
    element 2c in the low nibble of byte c, element 2c + 1 in the high."""
    if codes.shape[-1] % 2:
        raise ValueError(f"pack_int4: the last axis must be even, got "
                         f"{tuple(codes.shape)}")
    nib = codes.to(torch.int16) & 0xF
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: uint8 [..., n] -> int8 codes
    [..., 2n], each nibble sign-extended."""
    b = packed.to(torch.int16)
    nib = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=-1)
    return ((nib ^ 8) - 8).to(torch.int8).flatten(-2)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def is_int4(w: dict) -> bool:
    """A quantized leaf holds packed int4 codes (uint8), not int8."""
    return w["q"].dtype == torch.uint8


def codes_of(w: dict) -> torch.Tensor:
    """The int8 codes of a quantized leaf, int4 unpacked."""
    return unpack_int4(w["q"]) if is_int4(w) else w["q"]


class HeadProduct(torch.autograd.Function):
    """x [M, K] @ w [K, N] -> float32 [M, N] for bf16 operands: on CUDA
    one GEMM in the operands' dtype with a float32 output (``torch.mm``'s
    ``out_dtype``, float32 accumulation, as the JAX head's
    ``preferred_element_type``), on the CPU the float32 product of the
    widened operands (exact widening, the same sums). ``torch.mm`` with
    ``out_dtype`` has no derivative, so the backward is written here:
    the float32 gradient rounded to the operands' dtype, then the two
    GEMMs of the gradient in that dtype (float32 accumulation inside
    each), ``g @ w.T`` and ``x.T @ g``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.matmul(x.float(), w.float())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, w = ctx.saved_tensors
        g = grad.to(w.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with a float32 output: a float32 product for float32
    weights, else :class:`HeadProduct` (differentiable)."""
    x = x.to(w.dtype)
    if w.dtype == torch.float32:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    return HeadProduct.apply(x.reshape(-1, x.shape[-1]), w).reshape(
        *lead, -1)


def _scaled_product(x: torch.Tensor, codes: torch.Tensor, s: torch.Tensor,
                    out_dtype: torch.dtype | None) -> torch.Tensor:
    """(x @ codes) * s for int8 codes [K, N] and scales [N]: the codes
    widened to ``x``'s dtype, one product, then the scale — a float32
    product times the float32 scale for ``out_dtype`` float32, else the
    product in ``x``'s dtype times the scale cast to it (JAX's
    ``qmatmul``)."""
    codes = codes.to(x.dtype)
    if out_dtype == torch.float32:
        return _matmul_f32(x, codes) * s.float()
    y = torch.matmul(x, codes)
    return y * s.to(y.dtype)


def wq_gemm_plain(x: torch.Tensor, w: dict, *,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain version of :func:`wq_gemm`, on any device: the ``[N,
    K]`` codes dequantized into a scratch in ``x``'s dtype, one product
    with their transpose, then the scale — JAX's ``qmatmul_t``."""
    return _scaled_product(x, codes_of(w).t(), w["s"].reshape(-1), out_dtype)


def qmatmul(x: torch.Tensor, w: Any, *,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ w for a plain ``w`` ([K, N]); ``out_dtype=torch.float32`` is
    a bf16 LM head's product (float32 out). A quantized ``[K, N]``
    matrix is JAX's layout, which the port's trees do not hold: CPU
    tensors get JAX's ``qmatmul``, CUDA ones raise (the kernel reads
    ``[N, K]`` codes through :func:`qmatmul_t`)."""
    if not is_quantized(w):
        if out_dtype == torch.float32:
            return _matmul_f32(x, w)
        return torch.matmul(x.to(w.dtype), w)
    if x.device.type != "cpu":
        raise ValueError(
            f"qmatmul: a quantized [K, N] matrix on {x.device}: the "
            "port stores quantized matrices [N, K] (quantize_llama_*, "
            "params_from_jax, load_llama_checkpoint) and multiplies them "
            "with qmatmul_t")
    return _scaled_product(x, codes_of(w), w["s"].reshape(-1), out_dtype)


def qmatmul_t(x: torch.Tensor, w: Any, *,
              out_dtype: torch.dtype | None = None,
              plain: bool = False) -> torch.Tensor:
    """x @ w.T for plain or quantized ``w`` ([N, K], scales [N, 1]) —
    every quantized product of the port: layer matrices, an untied head,
    the tied embedding's head. ``out_dtype=torch.float32`` is the LM
    head's product: float32 out, and on CUDA always the kernel.
    ``plain`` takes the plain version on any device (the reference the
    kernel is held against)."""
    if not is_quantized(w):
        if out_dtype == torch.float32:
            return _matmul_f32(x, w.t())
        return torch.matmul(x.to(w.dtype), w.t())
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if plain or x.device.type == "cpu" or route_of(
            x2.shape[0], head=out_dtype == torch.float32) != "wq_gemm":
        y = wq_gemm_plain(x2, w, out_dtype=out_dtype)
    else:
        y = wq_gemm(x2, w, out_dtype=out_dtype)
    return y.reshape(*lead, y.shape[-1])


def route_of(m: int, *, head: bool) -> str:
    """Which route a CUDA product of ``m`` rows takes: ``"wq_gemm"`` or
    ``"dequant+matmul"``."""
    return "wq_gemm" if head or m <= M_MAX else "dequant+matmul"


def qgather(w: Any, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding-table row gather for plain or quantized tables
    (per-row scales [V, 1]): ``dtype(dtype(q[idx]) * dtype(s[idx]))``."""
    if not is_quantized(w):
        return w[idx]
    q = w["q"][idx]
    codes = unpack_int4(q) if is_int4(w) else q
    return codes.to(dtype) * w["s"][idx].to(dtype)


def quantized_bytes(tree: Any) -> int:
    """Bytes a tree of tensors occupies as stored: every leaf's elements
    times their size — int8 codes 1 byte, packed int4 codes (uint8, two
    a byte) half a byte per code, scales 4 — over weight trees and the
    paged KV pool's ``{"q", "s"}`` alike."""
    if isinstance(tree, dict):
        return sum(quantized_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(quantized_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _quantize_llama(params: dict, qfn) -> dict:
    out: dict = {"final_norm": params["final_norm"]}
    out["layers"] = {
        # [L, in, out] -> [L, out, in], reduce in -> scales [L, out, 1]
        name: w if name.endswith("_norm")
        else qfn(w.transpose(1, 2).contiguous(), axis=2)
        for name, w in params["layers"].items()}
    # embed [V, D]: per-row scales serve the gather AND the tied head
    out["embed"] = qfn(params["embed"], axis=1)
    if "lm_head" in params:  # [D, V] -> [V, D], reduce D
        out["lm_head"] = qfn(params["lm_head"].t().contiguous(), axis=1)
    return out


def quantize_llama_int8(params: dict) -> dict:
    """Quantize a Llama tree into the port's ``[N, K]`` layout: the
    seven per-layer matrices (``[L, in, out]`` stored ``[L, out, in]``,
    reduce ``in``), the embedding (per row) and an untied head (``[D,
    V]`` stored ``[V, D]``); norm gains pass through untouched. The
    codes and scales are JAX's ``quantize_llama_int8``'s transposed."""
    return _quantize_llama(params, quantize_int8)


def quantize_llama_int4(params: dict) -> dict:
    """int4 variant of :func:`quantize_llama_int8` (codes packed)."""
    return _quantize_llama(params, quantize_int4)


# ------------------------------------------------------------ the kernel

#: C entry by code form; each takes (x, q, s, y, M, N, K, out_f32,
#: n_splits, groups, stream)
_SYMBOLS = {False: "gofr_wq_gemm_i8", True: "gofr_wq_gemm_i4"}
_fns: dict = {}
#: the C source's tile: output channels a consumer warpgroup (wgmma's
#: M), and the contraction one stage covers (128 code bytes a channel)
BLOCK_N = 64
STAGE_K = {False: 128, True: 256}
#: the most splits of the contraction a cluster takes (the portable size)
MAX_SPLITS = 8
_SMS = 132


def _kernel(int4: bool):
    fn = _fns.get(int4)
    if fn is None:
        fn = getattr(_build.load("wq_gemm"), _SYMBOLS[int4])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[int4] = fn
    return fn


def row_tile(m: int) -> int:
    """Rows of x a block holds (wgmma's N): M rounded up to 8, 16, 32
    or 64, else tiles of 128."""
    return next((r for r in (8, 16, 32, 64) if m <= r), 128)


def wq_groups(m: int, n: int) -> int:
    """Consumer warpgroups a block, 64 output channels each, sharing the
    block's x tile: two where the x tile is 64 rows or more and the
    product has output channels for two waves of blocks (the LM head),
    which halves the x tiles read from L2; else one."""
    return 2 if row_tile(m) >= 64 and -(-n // BLOCK_N) >= 2 * _SMS else 1


def wq_splits(m: int, n: int, k: int, *, int4: bool,
              groups: int = 1) -> int:
    """S, the blocks of one thread-block cluster that split the
    contraction (shapes only): doubled from 1 while the doubled grid
    still fits the card's SMs — half of them for x tiles of 64 rows or
    more, whose blocks each fill an SM's shared memory and whose merge
    moves 32 KB partial tiles — and every split keeps a stage of the
    contraction (past that a split adds merge work, not bandwidth)."""
    blocks = -(-n // (BLOCK_N * groups)) * -(-m // row_tile(m))
    target = _SMS // 2 if row_tile(m) >= 64 else _SMS
    steps = -(-k // STAGE_K[int4])
    s = 1
    while s < MAX_SPLITS and blocks * 2 * s <= target and steps >= 2 * s:
        s *= 2
    return s


def _check(x, w, out_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"wq_gemm: no kernel for device {x.device}")
    q, s = w["q"], w["s"]
    int4 = is_int4(w)
    if q.dtype not in (torch.int8, torch.uint8) or q.dim() != 2:
        raise TypeError(f"wq_gemm: codes must be a 2-D int8 or packed "
                        f"uint8 tensor, got {q.dtype} {tuple(q.shape)}")
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise TypeError(f"wq_gemm: x must be a 2-D bfloat16 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"wq_gemm: out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    n, k = q.shape[0], q.shape[1] * (2 if int4 else 1)
    if x.shape[1] != k:
        raise ValueError(f"wq_gemm: x {tuple(x.shape)} does not contract "
                         f"with [N, K] codes {tuple(q.shape)}")
    step = 32 if int4 else 16
    if k % step:
        raise ValueError(f"wq_gemm: K={k} must be a multiple of {step}")
    if s.dtype != torch.float32 or s.numel() != n:
        raise TypeError(f"wq_gemm: scales must be {n} float32 values, got "
                        f"{s.dtype} {tuple(s.shape)}")
    for name, t in (("x", x), ("codes", q), ("scales", s)):
        if t.device != x.device:
            raise ValueError(f"wq_gemm: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wq_gemm: {name} must be contiguous and "
                             f"16-byte aligned")
    return int4, n, k


def wq_gemm(x: torch.Tensor, w: dict, *,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y [M, N] = (x [M, K] @ dequant(q)^T) * s through the kernel.

    ``w`` is a quantized 2-D leaf in the port's layout: codes ``[N, K]``
    (a layer matrix, an untied head, the tied embedding), int8 or packed
    int4 (uint8, K halved), and N float32 scales. x is bf16.
    ``out_dtype`` float32 gives ``acc * s`` (the head); else bf16
    ``bf16(bf16(acc) * bf16(s))``, the plain version's two roundings.
    CPU tensors run :func:`wq_gemm_plain`; CUDA tensors launch the
    kernel on the current stream (no host sync, no allocation beyond the
    output, so a CUDA graph can hold it) or raise — there is no
    fallback. Counts ``wq_gemm.launches`` (int8) /
    ``wq_gemm.launches_int4``."""
    if x.device.type == "cpu":
        return wq_gemm_plain(x, w, out_dtype=out_dtype)
    int4, n, k = _check(x, w, out_dtype)
    m = x.shape[0]
    f32 = out_dtype == torch.float32
    y = torch.empty(m, n, device=x.device,
                    dtype=torch.float32 if f32 else torch.bfloat16)
    if m == 0:
        return y
    groups = wq_groups(m, n)
    splits = wq_splits(m, n, k, int4=int4, groups=groups)
    rc = _kernel(int4)(
        x.data_ptr(), w["q"].data_ptr(), w["s"].data_ptr(), y.data_ptr(),
        m, n, k, int(f32), splits, groups,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wq_gemm{'_int4' if int4 else ''} kernel launch "
                           f"failed: cudaError {rc}")
    counter = "launches_int4" if int4 else "launches"
    setattr(wq_gemm, counter, getattr(wq_gemm, counter) + 1)
    return y


#: kernel launches since the last reset, per code form (plain integers;
#: set one to 0 to start counting)
wq_gemm.launches = 0            # int8 codes
wq_gemm.launches_int4 = 0       # packed int4 codes
