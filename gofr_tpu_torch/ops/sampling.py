"""Token sampling with one setting for the whole batch: greedy,
temperature, top-k, top-p (counterpart of ``gofr_tpu/ops/sampling.py``).
The engine samples per row through ``serving/sampling.sample_batch``."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def sample_tokens(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  generator: torch.Generator | None = None,
                  uniform: torch.Tensor | None = None) -> torch.Tensor:
    """Sample next tokens from logits [B, V] -> [B] int32.

    ``temperature == 0.0`` is greedy: ``argmax``, exact ties to the
    lowest index. Otherwise top-k and then top-p filter
    ``logits / temperature`` and a Gumbel-max draw picks the token.
    ``uniform`` [B, V] in (0, 1) is the noise (tests feed the JAX
    function's draw); without it the noise comes from ``generator``.
    """
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p < 1.0:
        ordered = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(ordered, dim=-1), dim=-1)
        keep = torch.roll(cum, 1, dims=-1) < top_p
        keep[..., 0] = True
        threshold = torch.where(keep, ordered, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, NEG_INF)
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=generator,
                             device=logits.device) * (1.0 - 1e-20) + 1e-20
    gumbel = -torch.log(-torch.log(uniform + 1e-20))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
