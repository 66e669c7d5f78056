"""Differentiable collectives along one mesh axis.

JAX's GSPMD inserts these and ``jax.grad`` transposes them; here each is
a ``torch.autograd.Function`` whose backward is the transpose written
out (Megatron's conjugate pairs):

=====================  ============================  =======================
function               forward                       backward
=====================  ============================  =======================
:func:`copy_to`        identity                      all-reduce (sum)
:func:`reduce_from`    all-reduce (sum)              identity
:func:`gather`         all-gather along ``dim``      this rank's chunk
:func:`split`          this rank's chunk             all-gather
:func:`gather_rs`      all-gather along ``dim``      reduce-scatter
:func:`reduce_scatter` reduce-scatter along ``dim``  all-gather
:func:`ppermute`       send along ``perm``           send back along it
=====================  ============================  =======================

A rank holds a replicated value's gradient in full only after the sum
over the ranks that share its work: :func:`copy_to` at the point where
a replicated value enters per-rank partial work makes that so inside
the backward pass, so a trainer sums gradients over ``dp`` alone.

Each runs through the axis's process group, also when the group has one
rank (the card's smoke run: the collectives go through ``nccl``); an
axis with no group (no process group, or an axis the mesh lacks) is of
size 1 and every function is the identity. :func:`all_reduce_` is the
plain in-place sum, for gradients and reported losses.

On a ``gloo`` group (ranks sharing one card) every collective of a
CUDA tensor is staged through host memory: the tensor is copied to the
host, the CPU collective runs there, and the result is copied back.
``gloo`` hands a CUDA tensor's device address to its TCP transport in
``send`` / ``recv`` (and so in :func:`ppermute`'s exchange): the write
fails with "Bad address" and the sender aborts. Its own CUDA path takes
``all_reduce``, ``broadcast``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` in torch 2.11; one route serves every
collective. Sums run in the tensor's own dtype on both backends:
``gloo`` reduces bf16 on the host, ``nccl`` on the card, and at two
ranks either's sum is the one rounding of ``a + b``.

:class:`TensorParallel` holds a serving rank's tp collectives: plain
calls, no autograd (``models/llama.py``'s tp steps).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.quant import qgather
from .mesh import Mesh

# newer torch renames the single-tensor collectives (the old names warn)
_gather_into = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)
_scatter_into = (getattr(dist, "reduce_scatter_single", None)
                 or dist.reduce_scatter_tensor)


def _axis(mesh: Mesh, axis: str):
    """(group, size, index) of this rank along ``axis``; group None means
    a world of one along it."""
    group = mesh.group(axis)
    size = mesh.size(axis)
    if group is None and size != 1:
        raise RuntimeError(f"mesh axis {axis!r} of size {size} has no "
                           "process group on this rank")
    return group, size, mesh.coord(axis)


def _staged(x: torch.Tensor, group) -> bool:
    """A CUDA tensor on a ``gloo`` group: its collective runs on a host
    copy."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if _staged(x, group):
        return _all_reduce(x.cpu(), group).to(x.device)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    if _staged(x, group):
        return _all_gather(x.cpu(), dim, group, size).to(x.device)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((size * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    _gather_into(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group,
                    size: int) -> torch.Tensor:
    if _staged(x, group):
        return _reduce_scatter(x.cpu(), dim, group, size).to(x.device)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % size:
        raise ValueError(f"reduce-scatter of {xt.shape[0]} rows over "
                         f"{size} ranks")
    out = torch.empty((xt.shape[0] // size,) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    _scatter_into(out, xt, group=group)
    return out.movedim(0, dim)


def _chunk(x: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    if x.shape[dim] % size:
        raise ValueError(f"split of {x.shape[dim]} along dim {dim} over "
                         f"{size} ranks")
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, index, scatter_back):
        ctx.args = (dim, group, size, index, scatter_back)
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, size, index, scatter_back = ctx.args
        gx = (_reduce_scatter(g, dim, group, size) if scatter_back
              else _chunk(g, dim, size, index))
        return gx, None, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        ctx.args = (dim, group, size)
        return _chunk(x, dim, size, index)

    @staticmethod
    def backward(ctx, g):
        dim, group, size = ctx.args
        return _all_gather(g, dim, group, size), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.args = (dim, group, size)
        return _reduce_scatter(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, size = ctx.args
        return _all_gather(g, dim, group, size), None, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    group, _, _ = _axis(mesh, axis)
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    group, _, _ = _axis(mesh, axis)
    return x if group is None else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather along ``dim``; the backward keeps this rank's chunk
    (every rank computes the same function of the gathered value)."""
    group, size, index = _axis(mesh, axis)
    return x if group is None else _Gather.apply(x, dim, group, size, index,
                                                 False)


def gather_rs(x: torch.Tensor, mesh: Mesh, axis: str,
              dim: int) -> torch.Tensor:
    """All-gather along ``dim``; the backward reduce-scatters (each rank
    computes a partial function of the gathered value)."""
    group, size, index = _axis(mesh, axis)
    return x if group is None else _Gather.apply(x, dim, group, size, index,
                                                 True)


def split(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    group, size, index = _axis(mesh, axis)
    return x if group is None else _Split.apply(x, dim, group, size, index)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str,
                   dim: int) -> torch.Tensor:
    group, size, _ = _axis(mesh, axis)
    return x if group is None else _ReduceScatter.apply(x, dim, group, size)


def _exchange(x: torch.Tensor, peers_to: list, peers_from: list,
              group) -> torch.Tensor:
    """Send ``x`` to every global rank in ``peers_to``, receive one
    tensor like ``x`` from ``peers_from`` (empty: zeros)."""
    if _staged(x, group):
        return _exchange(x.cpu(), peers_to, peers_from, group).to(x.device)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, p, group=group) for p in peers_to]
    ops += [dist.P2POp(dist.irecv, out, p, group=group) for p in peers_from]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, perm, index, group):
        ctx.args = (line, perm, index, group)
        return _exchange(x, [line[d] for s, d in perm if s == index],
                         [line[s] for s, d in perm if d == index], group)

    @staticmethod
    def backward(ctx, g):
        line, perm, index, group = ctx.args
        back = [(d, s) for s, d in perm]
        return (_exchange(g, [line[d] for s, d in back if s == index],
                          [line[s] for s, d in back if d == index], group),
                None, None, None, None)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: list[tuple[int, int]]) -> torch.Tensor:
    """JAX's ``lax.ppermute`` along ``axis``: (source, destination)
    index pairs; a rank no pair sends to receives zeros. The backward
    sends each gradient back along the reversed pairs."""
    group, size, index = _axis(mesh, axis)
    if group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Permute.apply(x, mesh.line(axis), list(perm), index, group)


def _sum_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group``."""
    if _staged(x, group):
        return x.copy_(_sum_(x.cpu(), group))
    dist.all_reduce(x, group=group)
    return x


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """In-place sum over ``axis`` (not differentiable)."""
    group, _, _ = _axis(mesh, axis)
    return x if group is None else _sum_(x, group)


def send(x: torch.Tensor, mesh: Mesh, axis: str, to: int) -> None:
    """Blocking send of ``x`` to index ``to`` along ``axis``."""
    group, _, _ = _axis(mesh, axis)
    x = x.cpu() if _staged(x, group) else x
    dist.send(x.contiguous(), mesh.line(axis)[to], group=group)


def recv(like: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """Blocking receive of a tensor shaped like ``like`` from index
    ``src`` along ``axis``."""
    group, _, _ = _axis(mesh, axis)
    if _staged(like, group):
        return recv(like.cpu(), mesh, axis, src).to(like.device)
    out = torch.empty_like(like)
    dist.recv(out, mesh.line(axis)[src], group=group)
    return out


class TensorParallel:
    """A serving rank's collectives along ``axis`` (plain calls, no
    autograd), for the tp forms of ``models/llama.py``'s steps:

    - :meth:`embed`: this rank's rows of the vocabulary-sharded
      embedding (zeros for tokens outside them), summed over the axis;
    - :meth:`reduce`: the in-place sum of a row-parallel product's
      partial (after ``wo`` and after ``w2``);
    - :meth:`logits`: this rank's vocabulary columns of the head,
      all-gathered along the last dim: whole on every rank, so each
      rank's sampler draws the same token from the same generator.

    An axis of size 1 without a group makes every call the identity.
    """

    def __init__(self, mesh: Mesh, axis: str = "tp") -> None:
        self.group, self.size, self.index = _axis(mesh, axis)

    def embed(self, embed, tokens: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        if self.group is None:
            return qgather(embed, tokens, dtype)
        rows = (embed["q"] if isinstance(embed, dict) else embed).shape[0]
        idx = tokens - self.index * rows
        keep = (idx >= 0) & (idx < rows)
        x = qgather(embed, idx.clamp(0, rows - 1), dtype)
        x = x * keep[..., None].to(dtype)
        return _sum_(x, self.group)

    def reduce(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.group is not None:
            _sum_(x, self.group)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x
        return _all_gather(x, x.ndim - 1, self.group,
                           self.size).contiguous()
