"""Normalization ops (counterpart of ``gofr_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (Llama-family): x * w / rms(x), statistics in float32,
    cast back to ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (BERT/Whisper-family): statistics in float32 (the
    biased variance), cast back to ``x``'s dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * (var + eps) ** -0.5
    return (normed * weight.float() + bias.float()).to(x.dtype)
