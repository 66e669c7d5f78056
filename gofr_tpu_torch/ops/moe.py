"""Mixture-of-experts ops: top-k routing and the gated expert MLP
(counterpart of ``gofr_tpu/ops/moe.py``).

The dense formulation of the reference: every expert is computed for
every token, in float32, and the routing weights combine them. The
combine matrix is a ``scatter_`` of the weights into zeros (the top-k
indices of a row are distinct, so it holds the same values as the
reference's one-hot contraction), which keeps the step free of host
syncs, so a decode step that runs it can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F


def _top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    in descending order, equal values toward the lowest index, as
    ``lax.top_k`` breaks ties (``torch.topk`` promises no order between
    equal values): a stable descending sort, cut to k."""
    values, indices = torch.sort(logits, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def top_k_routing(gate_logits: torch.Tensor, k: int,
                  renormalize: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route tokens: [T, E] logits -> (float32 weights [T, k], indices
    [T, k]), the k largest logits of each row in descending order; the
    weights are the softmax over those k (``renormalize``) or each
    one's share of the softmax over all E. Ties go to the lowest
    expert index."""
    values, indices = _top_k(gate_logits, k)
    if renormalize:
        weights = torch.softmax(values.float(), dim=-1)
    else:
        weights = torch.softmax(gate_logits.float(), dim=-1).gather(
            -1, indices)
    return weights, indices


class ExpertShard(NamedTuple):
    """An expert-parallel rank's part of :func:`moe_layer`: its experts
    start at ``first``; ``copy`` (identity forward, gradient summed over
    the expert ranks backward) takes the replicated router weights and
    expert input into per-rank work, ``reduce`` sums the partial
    combine over the expert ranks (``parallel/comm.py``)."""
    first: int
    copy: Callable
    reduce: Callable


def moe_layer(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor,
              w3: torch.Tensor, w2: torch.Tensor, *, num_selected: int = 2,
              shard: ExpertShard | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixtral-style sparse MLP, computed densely over all E experts.

    x [T, D]; gate_w [D, E]; w1, w3 [E, D, F]; w2 [E, F, D]. Returns
    (output [T, D] in x's dtype, router logits [T, E] float32 for the
    load-balancing loss). With ``shard`` the expert weights are this
    rank's ``E / ep`` experts: the router still scores all E, the rank
    computes its own experts' products and combine, and the float32
    combine is summed over the expert ranks before the cast."""
    xf = x.float()
    gate_logits = xf @ gate_w.float()                          # [T, E]
    weights, indices = top_k_routing(gate_logits, num_selected)
    # combine[t, e]: the routing weight of expert e for token t, 0 if
    # the token is not routed there
    combine = torch.zeros_like(gate_logits).scatter_(-1, indices, weights)
    if shard is not None:
        combine = shard.copy(combine)[:, shard.first:shard.first
                                      + w1.shape[0]]
        xf = shard.copy(xf)
    hidden = F.silu(torch.einsum("td,edf->tef", xf, w1.float()))
    hidden *= torch.einsum("td,edf->tef", xf, w3.float())
    expert_out = torch.einsum("tef,efd->ted", hidden, w2.float())
    del hidden
    out = torch.einsum("te,ted->td", combine, expert_out)
    if shard is not None:
        out = shard.reduce(out)
    return out.to(x.dtype), gate_logits


def load_balancing_loss(router_logits: torch.Tensor,
                        num_selected: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e (fraction of routed slots
    taken by e * mean router probability of e), over every leading
    axis of ``router_logits`` [..., E]."""
    n_experts = router_logits.shape[-1]
    probs = torch.softmax(router_logits.float(), dim=-1)
    _, indices = _top_k(router_logits, num_selected)
    counts = F.one_hot(indices, n_experts).float()
    counts = counts.reshape(-1, num_selected, n_experts).sum(dim=(0, 1))
    fraction = counts / counts.sum().clamp(min=1.0)
    mean_prob = probs.reshape(-1, n_experts).mean(dim=0)
    return n_experts * (fraction * mean_prob).sum()
