"""Per-row token sampling (counterpart of
``gofr_tpu/serving/engine.py:_sample_batch``)."""

from __future__ import annotations

import torch

#: static cap on the candidate set per row: stochastic rows sample
#: within their TOPK_BOUND most likely tokens
TOPK_BOUND = 64

NEG_INF = -1e30


def sample_batch(logits: torch.Tensor, temperatures: torch.Tensor,
                 top_ps: torch.Tensor, top_ks: torch.Tensor | None = None,
                 *, generator: torch.Generator | None = None,
                 uniform: torch.Tensor | None = None,
                 all_greedy: bool | None = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32.

    Greedy rows (temperature <= 0) take ``argmax``, which breaks exact
    ties to the lowest index — never ``topk(...).indices[:, 0]``, whose
    tie order PyTorch does not guarantee. An all-greedy batch skips the
    candidate search entirely: ``all_greedy`` says whether it is one,
    decided by the caller on the host (the engine knows its requests'
    params), so that no device value is read; None reads it from
    ``temperatures`` (one host sync on CUDA). ``all_greedy=False`` on an
    all-greedy batch gives the same tokens, through the search.
    Stochastic rows take their ``TOPK_BOUND`` best candidates of
    ``logits / temperature``, keep the row's top-k (0 = off), then top-p
    on the renormalised survivors, and Gumbel-sample. ``uniform`` [B, TOPK_BOUND] in (0, 1) supplies the
    noise (tests feed both implementations the same numbers); otherwise
    it is drawn from ``generator``.
    """
    logits = logits.float()
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if all_greedy is None:
        all_greedy = bool((temperatures <= 0.0).all())
    if all_greedy:
        return greedy
    bound = min(TOPK_BOUND, logits.shape[-1])
    safe_t = temperatures.float().clamp(min=1e-6)[:, None]
    vals, idx = torch.topk(logits / safe_t, bound, dim=-1)   # sorted desc
    pos = torch.arange(bound, device=logits.device)[None, :]
    if top_ks is not None:
        k_eff = torch.where(top_ks > 0, top_ks.clamp(max=bound),
                            torch.full_like(top_ks, bound))
        vals = vals.masked_fill(pos >= k_eff[:, None], NEG_INF)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = torch.roll(cum, 1, dims=-1) < top_ps[:, None]
    keep[:, 0] = True
    filtered = vals.masked_fill(~keep, NEG_INF)
    if uniform is None:
        uniform = torch.rand(vals.shape, generator=generator,
                             device=logits.device) * (1.0 - 1e-20) + 1e-20
    gumbel = -torch.log(-torch.log(uniform + 1e-20))
    choice = torch.argmax(filtered + gumbel, dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperatures <= 0.0, greedy, sampled)
