"""Sharded training step: dp + tp + sp (+ep for MoE) (counterpart of
``gofr_tpu/parallel/train.py``).

JAX's step is one jit over GSPMD-placed parameters. Here each rank holds
its own shards (``sharding.py``) and runs the Megatron form of the
model's own blocks (``models/llama.py``: ``_attn_block``, ``_mlp_block``,
``_logits``) with the collectives named (``comm.py``):

- the embedding is vocabulary-sharded over ``tp``: each rank gathers its
  rows (zeros for tokens outside them), and the sum over ``tp`` is a
  reduce-scatter along the sequence, which leaves the residual stream
  sequence-sharded over ``tp`` between blocks (Megatron's sequence
  parallelism, JAX's ``constrain``);
- each block all-gathers the sequence, runs its column-parallel
  products on this rank's heads or hidden columns, its row-parallel
  product to a partial sum, and reduce-scatters that back onto the
  sequence shard; the norms' gains enter through ``copy_to`` so their
  gradients are summed over ``tp``;
- the head gives this rank's vocabulary columns, all-gathered into the
  float32 logits on every rank.

The batch is sharded over ``dp``: each rank's loss is its rows' summed
negative log-likelihood over the global mask count, and the gradients
are summed over ``dp`` after the backward pass, so every rank applies
the same update. The forward takes ``implementation="plain"``, as JAX's
trainer takes ``"xla"``: no Pallas kernel, and here no CUDA kernel (none
has a backward). Pipeline (``pp``) meshes route through ``pipeline.py``
(``make_train_step`` dispatches).

The optimizer is optax's arithmetic written over the parameter dict:
:func:`clip_by_global_norm` (``where(norm < max, g, g / norm * max)``,
the norm of the whole gradient: a sharded step hands it in as
``g_norm``, :func:`sharded_global_norm` over its shards, since a rank's
own shards give only part of it),
:func:`scale_by_adam` (moments in the parameters' dtype, an int32
``count``), :func:`add_decayed_weights`, :func:`scale_by_learning_rate`,
composed by :func:`chain`; the state has optax's structure, so a JAX
train state's leaves map onto it one for one (``checkpoint.py``,
``models/convert.train_state_from_jax``). Optimizer state inherits the
parameters' shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..models.llama import (LlamaConfig, _attn_block, _inv_freq, _logits,
                            _mlp_block, llama_init)
from ..models.moe import MoEConfig
from ..ops.quant import qgather
from . import comm
from .mesh import Mesh, mesh_axes
from .sharding import (Sharding, _match_specs, batch_spec, llama_param_specs,
                       moe_param_specs, shard_params)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor

    def tree_children(self) -> tuple:
        """The three subtrees in JAX's order (its pytree registration):
        checkpoints key them ``[<flat index i>]``, as JAX does."""
        return (self.params, self.opt_state, self.step)

    @classmethod
    def from_children(cls, children) -> "TrainState":
        params, opt_state, step = children
        return cls(params=params, opt_state=opt_state, step=step)


# ------------------------------------------------------------- optimizer

class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """The transforms in order; keyword arguments of ``update`` (optax's
    extra args) reach every one. The chain keeps no reference to a
    transform's input once it is handed on (``held``), so each tree is
    freed as soon as the transform that reads it returns: at a step's
    peak every tree of the model's size counts."""
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None, **extra):
        held = [updates]
        del updates
        new_state = []
        for t, s in zip(transforms, state):
            out, s = t.update(held.pop(), s, params, **extra)
            held.append(out)
            del out
            new_state.append(s)
        return held.pop(), tuple(new_state)

    return GradientTransformation(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, accumulated in float32."""
    return torch.sqrt(sum((x.float() * x.float()).sum() for x in
                          _leaves(tree)))


def sharded_global_norm(tree, mesh: Mesh, specs) -> torch.Tensor:
    """The global norm of a tree of this rank's shards placed by
    ``specs``: each leaf's float32 sum of squares summed over the mesh
    axes its spec shards it over (a replicated leaf counted once), so
    every rank gets the norm of the whole tree."""
    groups: dict = {}
    specs = _match_specs(tree, specs)
    for x, spec in zip(_leaves(tree), _leaves(specs)):
        axes = tuple(a for entry in spec if entry is not None
                     for a in (entry if isinstance(entry, tuple)
                               else (entry,)))
        square = (x.float() * x.float()).sum()
        groups[axes] = groups[axes] + square if axes in groups else square
    total = torch.zeros((), dtype=torch.float32,
                        device=_leaves(tree)[0].device)
    for axes, square in groups.items():
        for axis in axes:
            square = comm.all_reduce_(square, mesh, axis)
        total = total + square
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's rule: leaves pass unchanged while the global norm is
    below ``max_norm``, else ``g / norm * max_norm`` (no host sync: both
    branches are computed and selected on the device). ``g_norm``: the
    norm of the whole gradient when ``updates`` holds one rank's shards
    (:func:`sharded_global_norm`); else the norm of ``updates``."""
    def update(updates, state, params=None, g_norm=None, **extra):
        if g_norm is None:
            g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return _map(lambda t: torch.where(
            trigger, t, (t / g_norm.to(t.dtype)) * max_norm),
            updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        leaf = _leaves(params)[0]
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=_map(torch.zeros_like, params),
            nu=_map(torch.zeros_like, params))

    def update(updates, state, params=None, **extra):
        mu = _map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = _map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates,
                  state.nu)
        del updates             # a tree less while ``out`` is built
        count = torch.where(state.count < torch.iinfo(torch.int32).max,
                            state.count + 1, state.count)
        # bias corrections in float32, cast to each moment's dtype
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        out = _map(lambda m, v: (m / bc1.to(m.dtype))
                   / (torch.sqrt(v / bc2.to(v.dtype)) + eps), mu, nu)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update(updates, state, params=None, **extra):
        return _map(lambda g, p: g + weight_decay * p, updates,
                    params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_learning_rate(learning_rate: float) -> GradientTransformation:
    def update(updates, state, params=None, **extra):
        return _map(lambda g: g * -learning_rate, updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def apply_updates(params, updates):
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def default_optimizer(learning_rate: float = 3e-4) -> GradientTransformation:
    return chain(
        clip_by_global_norm(1.0),
        adamw(learning_rate, b1=0.9, b2=0.95, weight_decay=0.1),
    )


def optimizer_bytes(opt_state) -> int:
    """Bytes held by an optimizer state's tensors."""
    if isinstance(opt_state, dict):
        return sum(optimizer_bytes(v) for v in opt_state.values())
    if isinstance(opt_state, tuple):
        return sum(optimizer_bytes(v) for v in opt_state)
    if isinstance(opt_state, torch.Tensor):
        return opt_state.numel() * opt_state.element_size()
    return 0


# ------------------------------------------------------------------ loss

def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE. logits [B,S,V] f32, targets [B,S] int; with a
    mask, the masked sum over ``max(sum(mask), 1)``."""
    nll = _nll(logits, targets)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


# --------------------------------------------------------------- forward

def _layers(params: dict) -> list[dict]:
    """Every layer's weights as views of the stacked leaves, from one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where L indexings (``models/llama._layer``) would each add a whole
    ``[L, ...]`` gradient, L x the traffic."""
    views = {name: w.unbind(0) for name, w in params["layers"].items()}
    n = len(next(iter(views.values())))
    return [{name: v[li] for name, v in views.items()} for li in range(n)]


def _vocab_embed(embed: torch.Tensor, tokens: torch.Tensor, c: LlamaConfig,
                 mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a vocabulary-sharded embedding, zeros for
    tokens outside them: [B, S, D], partial over ``tp``."""
    if mesh.size("tp") == 1:
        return qgather(embed, tokens, c.dtype)
    rows = embed.shape[0]
    idx = tokens - mesh.coord("tp") * rows
    keep = (idx >= 0) & (idx < rows)
    x = qgather(embed, idx.clamp(0, rows - 1), c.dtype)
    return x * keep[..., None].to(c.dtype)


def sharded_forward(params: dict, tokens: torch.Tensor, config: LlamaConfig,
                    mesh: Mesh) -> torch.Tensor:
    """The Megatron forward of one rank: local shards, tokens [b, S]
    (this rank's dp rows) -> float32 logits [b, S, V], whole on every
    ``tp`` rank. The residual stream between blocks is [b, S / tp, D]."""
    c = config
    b, s = tokens.shape
    inv_freq = _inv_freq(c, tokens.device)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)

    def enter(x):    # whole sequence in, gradients reduce-scattered back
        return comm.gather_rs(x, mesh, "tp", 1)

    def leave(x):    # partial sums out, onto this rank's sequence shard
        return comm.reduce_scatter(x, mesh, "tp", 1)

    x = leave(_vocab_embed(params["embed"], tokens, c, mesh))
    for lp in _layers(params):
        for gain in ("attn_norm", "ffn_norm"):
            lp[gain] = comm.copy_to(lp[gain], mesh, "tp")
        attn_out, _, _ = _attn_block(enter(x), lp, c, inv_freq, positions,
                                     None, "plain")
        x = x + leave(attn_out)
        x = x + leave(_mlp_block(enter(x), lp, c, "plain"))
    head = {k: params[k] for k in ("embed", "lm_head") if k in params}
    head["final_norm"] = comm.copy_to(params["final_norm"], mesh, "tp")
    logits = _logits(head, c, enter(x), "plain")
    return comm.gather(logits, mesh, "tp", -1)


# ------------------------------------------------------------ state, step

def make_train_state(generator: torch.Generator, config: LlamaConfig,
                     mesh: Mesh, *,
                     optimizer: GradientTransformation | None = None,
                     init_fn: Callable = llama_init,
                     specs_fn: Callable = llama_param_specs
                     ) -> tuple[TrainState, GradientTransformation]:
    """Init (``init_fn(config, generator, device)``) + shard params and
    optimizer state over the mesh: each rank keeps its own shards."""
    optimizer = optimizer or default_optimizer()
    params = init_fn(config, generator, mesh.device)
    params = shard_params(params, mesh, specs_fn(mesh))
    opt_state = optimizer.init(params)   # moments inherit the shards
    step = torch.zeros((), dtype=torch.int32, device=mesh.device)
    return TrainState(params=params, opt_state=opt_state,
                      step=step), optimizer


def _rows(x: torch.Tensor, mesh: Mesh, axis_index: int = 0) -> torch.Tensor:
    """This rank's dp rows of a global batch, on the mesh's device."""
    spec = [None] * x.ndim
    spec[axis_index] = batch_spec(mesh)[0]
    return Sharding(mesh, spec).shard(x)


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """The gradient tree of ``params``. No reference cycle may hold the
    gradients: a tree kept until the collector runs is a tree more at
    the update's peak."""
    leaves = _leaves(params)
    # a transposed product (the tied head's) can leave a leaf's gradient
    # strided; the collectives take contiguous tensors
    grads = iter([torch.zeros_like(p) if g is None else g.contiguous()
                  for p, g in zip(leaves, torch.autograd.grad(
                      loss, leaves, allow_unused=True))])
    return _map(lambda p: next(grads), params)


def _trainable(params: dict) -> dict:
    return _map(lambda p: p.detach().requires_grad_(), params)


def make_train_step(config: LlamaConfig, mesh: Mesh, *,
                    optimizer: GradientTransformation | None = None,
                    forward_fn: Callable | None = None,
                    donate: bool = True) -> Callable:
    """Build the full train step for a dense model on a dp/tp/sp mesh;
    pipeline meshes (pp > 1) get ``pipeline.make_pipeline_train_step``.

    ``step(state, tokens, targets, mask)`` takes the global batch [B, S]
    (every rank the same arrays; each keeps its dp rows) and returns
    (new state, loss: the global masked mean, on every rank). A custom
    ``forward_fn(params, tokens) -> logits`` gets this rank's shards and
    rows and must return the whole float32 logits of those rows, with
    gradients that need only the sum over ``dp`` (``comm.py``).
    ``donate``: the step builds a new state and never writes into the
    one it was given; as in JAX the caller must not reuse a donated
    state. ``step.forward`` is the forward it runs,
    ``step.loss_and_grads(params, tokens, targets, mask)`` its loss and
    dp-summed gradients without the update, and ``step.grad_norm`` the
    last step's gradient norm before clipping (a device scalar): the
    whole gradient's, from the shards of every rank, placed as
    ``make_train_state`` placed the parameters (``moe_param_specs`` for a
    :class:`~gofr_tpu_torch.models.moe.MoEConfig`, else
    ``llama_param_specs``)."""
    axes = mesh_axes(mesh)
    if axes.get("pp", 1) > 1:
        if forward_fn is not None:
            raise ValueError(
                "pipeline meshes run the built-in llama stage forward; "
                "custom forward_fn is only supported on dense meshes")
        from .pipeline import make_pipeline_train_step
        return make_pipeline_train_step(config, mesh, optimizer=optimizer,
                                        donate=donate)

    optimizer = optimizer or default_optimizer()
    fwd = forward_fn or (lambda params, tokens: sharded_forward(
        params, tokens, config, mesh))
    specs = (moe_param_specs if isinstance(config, MoEConfig)
             else llama_param_specs)(mesh)

    def loss_and_grads(params, tokens, targets, mask):
        tokens, targets, mask = (_rows(t, mesh) for t in
                                 (tokens, targets, mask))
        maskf = mask.float()
        count = comm.all_reduce_(maskf.sum(), mesh, "dp").clamp(min=1.0)
        params = _trainable(params)
        nll = _nll(fwd(params, tokens), targets)
        loss = (nll * maskf).sum() / count
        grads = _grads(loss, params)
        for g in _leaves(grads):
            comm.all_reduce_(g, mesh, "dp")
        return comm.all_reduce_(loss.detach(), mesh, "dp"), grads

    def train_step(state: TrainState, tokens, targets, mask):
        loss, grads = loss_and_grads(state.params, tokens, targets, mask)
        g_norm = sharded_global_norm(grads, mesh, specs)
        train_step.grad_norm = g_norm
        # handed over, not kept: the clip's output replaces the gradients
        held = [grads]
        del grads
        updates, opt_state = optimizer.update(held.pop(), state.opt_state,
                                              state.params, g_norm=g_norm)
        new = TrainState(params=apply_updates(state.params, updates),
                         opt_state=opt_state, step=state.step + 1)
        return new, loss

    train_step.forward = fwd
    train_step.loss_and_grads = loss_and_grads
    train_step.grad_norm = None
    return train_step
