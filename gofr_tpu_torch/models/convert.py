"""Convert the JAX package's parameters to the port's tensors: Llama and
MoE (:func:`params_from_jax`), BERT (:func:`bert_params_from_jax`) and
Whisper (:func:`whisper_params_from_jax`).

The input is the JAX pytree read as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``): ``{"embed", "layers": {...},
"final_norm"[, "lm_head"]}`` with the stacked per-layer dict of
``gofr_tpu/models/llama.py:llama_init``, or of
``gofr_tpu/models/moe.py:moe_init`` (the router ``gate`` [L, D, E], the
experts' ``w1`` / ``w3`` [L, E, D, F] and ``w2`` [L, E, F, D]). The
layout is kept as it is — matrices stay ``[in, out]`` — so the port's
products read ``x @ w`` exactly as the JAX ones do.

A quantized tree (``quantize_llama_int8`` / ``_int4``) holds ``{"q",
"s"}`` leaves; they stay quantized, in the port's ``[N, K]`` layout
(``ops/quant.py``): JAX's layer matrices ``[L, in, out]`` (scales ``[L,
1, out]``) and an untied head ``[D, V]`` (``[1, V]``) are transposed to
``[L, out, in]`` / ``[V, D]`` with their scales to match, before any
int4 packing; the embedding ``[V, D]`` is already output-major. int8
codes stay ``int8``, JAX's int4 codes (a numpy array of the 4-bit
``int4`` dtype) are packed two per byte along K
(``ops/quant.pack_int4``), scales are float32. Every other leaf is a
float tensor in ``config.dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import is_quantized, pack_int4
from .bert import BertConfig
from .llama import LlamaConfig
from .whisper import WhisperConfig


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # bf16 leaves (a numpy type torch cannot read) widen to float32
    # exactly on the way
    arr = np.ascontiguousarray(np.asarray(a).astype(np.float32))
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _codes(a, device, transpose: bool) -> torch.Tensor:
    """int8 codes as they are; 4-bit codes (the dtype is named ``int4``:
    the test process's ml_dtypes type, which numpy casts to int8
    exactly) packed; the last two axes swapped first if asked."""
    a = np.asarray(a)
    codes = a.astype(np.int8)
    if transpose:
        codes = np.swapaxes(codes, -1, -2)
    codes = torch.from_numpy(np.ascontiguousarray(codes))
    if a.dtype.name == "int4":
        codes = pack_int4(codes)
    elif a.dtype != np.int8:
        raise TypeError(f"params_from_jax: quantized codes must be int8 or "
                        f"int4, got {a.dtype}")
    return codes.to(device)


def _convert(value, dtype: torch.dtype, device, transpose: bool = False):
    if is_quantized(value):
        s = np.asarray(value["s"])
        if transpose:   # [.., 1, out] -> [.., out, 1]
            s = np.swapaxes(s, -1, -2)
        return {"q": _codes(value["q"], device, transpose),
                "s": _tensor(s, torch.float32, device)}
    if isinstance(value, dict):
        # JAX's quantized layer matrices and untied head are [in, out]
        return {k: _convert(v, dtype, device,
                            k in ("layers", "lm_head") or transpose)
                for k, v in value.items()}
    return _tensor(value, dtype, device)


def params_from_jax(np_params: dict, config: LlamaConfig,
                    device: str | torch.device) -> dict:
    """numpy JAX pytree -> the port's parameter dict on ``device``:
    float leaves in ``config.dtype``, quantized leaves kept quantized."""
    return _convert(np_params, config.dtype, device)


def bert_params_from_jax(np_params: dict, config: BertConfig,
                         device: str | torch.device) -> dict:
    """numpy JAX ``bert_init`` tree -> the port's BERT parameters on
    ``device`` in ``config.dtype``, layout unchanged."""
    return _convert(np_params, config.dtype, device)


def whisper_params_from_jax(np_params: dict, config: WhisperConfig,
                            device: str | torch.device) -> dict:
    """numpy JAX ``whisper_init`` tree -> the port's Whisper parameters
    on ``device`` in ``config.dtype``: the convolutions' ``[k, in, out]``
    transposed to ``[out, in, k]``, every other leaf as it is."""
    out = _convert(np_params, config.dtype, device)
    for key in ("conv1_w", "conv2_w"):
        out[key] = out[key].permute(2, 1, 0).contiguous()
    return out
