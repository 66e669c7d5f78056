"""Pipeline-parallel (GPipe) training step (counterpart of
``gofr_tpu/parallel/pipeline.py``).

Layer stages live on the ``pp`` mesh axis (the stacked ``[L, ...]``
weights shard their leading axis, ``sharding.py``); microbatches go
through the stages GPipe-style. JAX runs every stage on every one of
the ``M + P - 1`` ticks, zero-weighting the bubbles, and differentiates
through ``ppermute``. Here a stage runs only its ``M`` busy ticks, which
gives the same numbers: stage ``s`` takes microbatch ``m`` at tick
``m + s``, received from stage ``s - 1`` by a blocking point-to-point
receive (the embedding on stage 0), and sends its output to ``s + 1``;
the last stage applies the head and sums the loss. The backward pass is
written out: the last stage runs each microbatch's backward from its
loss, the others from the output gradient received from ``s + 1``, in
reverse microbatch order, each sending its input's gradient to
``s - 1``. The loss is the global masked mean (summed over ``pp`` and
``dp``); the gradients of the leaves every stage holds (embedding, final
norm, head) are summed over ``pp``, all of them over ``dp``; the clip
takes the norm of the whole gradient, every stage's layers in it.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.llama import (LlamaConfig, _attn_block, _inv_freq, _logits,
                            _mlp_block)
from ..ops.quant import qgather
from . import comm
from .mesh import Mesh, mesh_axes
from .sharding import llama_param_specs
from .train import (GradientTransformation, TrainState, _layers, _leaves,
                    _map, _nll, _rows, _trainable, apply_updates,
                    default_optimizer, sharded_global_norm)


def _stage_forward(x, layers_local: dict, c: LlamaConfig, inv_freq,
                   positions):
    """Run this stage's slice of layers over activations x [mb, S, D],
    with the dense path's block math (models/llama.py), so pipeline
    stages can never drift from single-device semantics."""
    for lp in _layers({"layers": layers_local}):
        out, _k, _v = _attn_block(x, lp, c, inv_freq, positions, None,
                                  "plain")
        x = x + out
        x = x + _mlp_block(x, lp, c, "plain")
    return x


def make_pipeline_train_step(config: LlamaConfig, mesh: Mesh, *,
                             optimizer: GradientTransformation | None = None,
                             num_microbatches: int | None = None,
                             donate: bool = True) -> Callable:
    """GPipe train step for a ('dp', 'pp') mesh.

    Batch layout: tokens/targets/mask [M, mb, S], every rank the global
    arrays (each keeps its dp rows of axis 1), M = microbatches
    (defaults to the pp size). Returns (new state, global loss).
    """
    axes = mesh_axes(mesh)
    pp = axes.get("pp", 1)
    if axes.get("tp", 1) != 1:
        raise ValueError("pipeline step composes with dp only; use the "
                         "dense GSPMD step for tp/sp meshes")
    M = num_microbatches or pp
    if M < pp:
        raise ValueError(f"need at least {pp} microbatches to fill the pipe")
    optimizer = optimizer or default_optimizer()
    specs = llama_param_specs(mesh)
    c = config

    def train_step(state: TrainState, tokens, targets, mask):
        tokens, targets, mask = (_rows(t, mesh, 1) for t in
                                 (tokens, targets, mask))
        stage = mesh.coord("pp")
        first, last = stage == 0, stage == pp - 1
        mb, s = tokens.shape[1], tokens.shape[2]
        dev = tokens.device
        inv_freq = _inv_freq(c, dev)
        positions = torch.arange(s, device=dev)[None, :].expand(mb, s)
        count = comm.all_reduce_(mask.float().sum(), mesh, "dp").clamp(
            min=1.0)
        params = _trainable(state.params)
        like = torch.empty((mb, s, c.dim), dtype=c.dtype, device=dev)
        ins, outs = [], []
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for m in range(M):
            if first:
                x = qgather(params["embed"], tokens[m], c.dtype)
            else:
                x = comm.recv(like, mesh, "pp", stage - 1).requires_grad_()
            y = _stage_forward(x, params["layers"], c, inv_freq, positions)
            if last:
                nll = _nll(_logits(params, c, y, "plain"), targets[m])
                y = (nll * mask[m].float()).sum() / count
                loss_sum = loss_sum + y.detach()
            else:
                comm.send(y.detach(), mesh, "pp", stage + 1)
            ins.append(x)
            outs.append(y)
        for m in reversed(range(M)):
            if last:
                outs[m].backward()
            else:
                outs[m].backward(comm.recv(like, mesh, "pp", stage + 1))
            if not first:
                comm.send(ins[m].grad, mesh, "pp", stage - 1)
        grads = _map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad.contiguous(), params)
        for key in ("embed", "final_norm", "lm_head"):
            if key in grads:
                comm.all_reduce_(grads[key], mesh, "pp")
        for g in _leaves(grads):
            comm.all_reduce_(g, mesh, "dp")
        loss = comm.all_reduce_(comm.all_reduce_(loss_sum, mesh, "pp"),
                                mesh, "dp")
        params = _map(torch.Tensor.detach, params)
        g_norm = sharded_global_norm(grads, mesh, specs)
        # handed over, not kept: the clip's output replaces the gradients
        held = [grads]
        del grads
        updates, opt_state = optimizer.update(held.pop(), state.opt_state,
                                              params, g_norm=g_norm)
        return TrainState(params=apply_updates(params, updates),
                          opt_state=opt_state, step=state.step + 1), loss

    return train_step
