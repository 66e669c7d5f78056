"""Named grids of ranks over the ``torch.distributed`` world
(counterpart of ``gofr_tpu/parallel/mesh.py``).

JAX builds a ``jax.sharding.Mesh`` of devices and lets XLA insert the
collectives. Here every rank is a process with one device, and a
:class:`Mesh` is the grid of global ranks with one process subgroup per
axis: the ranks that share every other coordinate with this one. The
parallel layer's collectives (``parallel/comm.py``) run over those
groups. Axis conventions are JAX's:

- ``dp``: data parallel (batch; gradients summed over it)
- ``pp``: pipeline parallel (layer stages; activations sent point to point)
- ``tp``: tensor parallel (heads, the MLP's hidden width, the
  vocabulary; the residual stream's sequence between blocks)
- ``sp``: sequence parallel for long context (ring attention)
- ``ep``: expert parallel (MoE expert axis)

Without a process group the world is one rank on the caller's device
(the card unless the caller asks for the CPU): every axis is then of
size 1 and every collective is the identity. A one-rank group (the
card's smoke run) still runs its collectives through the backend.
:func:`init_process_group` takes the backend from the device: ``nccl``
for CUDA, ``gloo`` for the CPU, unless ``backend=`` names one: NCCL
refuses two ranks on one card, so ranks that share a card run ``gloo``
on their CUDA tensors (``comm.py`` routes the collectives ``gloo``
lacks for them). Beside its device groups a mesh holds
:attr:`Mesh.control`, one ``gloo`` group over all its ranks for host
messages (the serving lockstep's op codes, ``serving/lockstep.py``).

JAX's ``shard_map_compat`` and ``named`` have no counterpart: a rank's
code is already the per-shard function, and a placement is a
:class:`~gofr_tpu_torch.parallel.sharding.Sharding`.
"""

from __future__ import annotations

import itertools
import math
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def init_process_group(device: str | torch.device, init_method: str, *,
                       rank: int = 0, world_size: int = 1,
                       timeout_s: float = 600.0,
                       backend: str | None = None) -> torch.device:
    """Join the world as ``rank`` of ``world_size`` through
    ``init_method`` (``tcp://host:port`` or ``file:///path``), on
    ``backend``: by default ``nccl`` for a CUDA device and ``gloo`` for
    the CPU; ``"gloo"`` on a CUDA device lets several ranks share one
    card. Returns the resolved device (``cuda:<local index>`` is made
    current). A collective that waits longer than ``timeout_s`` raises
    (``gloo``; ``nccl``'s watchdog takes the process down); a mesh's
    groups take the same limit."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    global _world_device, _world_timeout
    _world_device = dev
    _world_timeout = timedelta(seconds=timeout_s)
    return dev


#: the device :func:`init_process_group` resolved (a mesh's default)
_world_device: torch.device | None = None
#: its collective timeout, which a mesh's groups take too
_world_timeout: timedelta | None = None


class Mesh:
    """``ranks``: the grid of global ranks, one array axis per name;
    ``rank``: this process's global rank (None outside the grid);
    ``device``: this rank's device; ``groups``: per axis, the subgroup
    along that axis through this rank (None without a process group);
    ``control``: a ``gloo`` group over every rank of the grid, for host
    messages (None without a process group); ``backend``: the device
    groups' backend (None without a process group)."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple,
                 rank: int | None, device: torch.device,
                 groups: dict | None = None, control=None,
                 backend: str | None = None) -> None:
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.device = device
        self.groups = groups or {}
        self.control = control
        self.backend = backend

    @property
    def leader(self) -> int:
        """The grid's first global rank (the serving lockstep's rank 0)."""
        return int(self.ranks.flat[0])

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coords(self) -> dict[str, int]:
        if self.rank is None:
            raise ValueError(f"rank is outside the mesh {self.shape}")
        where = np.argwhere(self.ranks == self.rank)[0]
        return dict(zip(self.axis_names, (int(i) for i in where)))

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        return self.coords().get(axis, 0) if axis in self.axis_names else 0

    def line(self, axis: str) -> list[int]:
        """The global ranks along ``axis`` through this rank, in order."""
        if axis not in self.axis_names:
            return [self.rank]
        index = list(np.argwhere(self.ranks == self.rank)[0])
        index[self.axis_names.index(axis)] = slice(None)
        return [int(r) for r in self.ranks[tuple(index)]]

    def group(self, axis: str):
        """The process group along ``axis`` (None: no process group, or
        an axis the mesh does not have — a world of one along it)."""
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def mesh_axes(mesh: Mesh) -> dict[str, int]:
    return mesh.shape


def create_mesh(axes: dict[str, int], devices=None, *,
                device: str | torch.device | None = None) -> Mesh:
    """Build a mesh from {axis: size} over ``devices`` (global ranks;
    default: the whole world); one size may be -1 (inferred).

    JAX's rules: more than one -1 raises, a world not divisible by the
    known sizes raises, a mesh larger than the world raises, and a
    smaller fully specified mesh takes the first ``need`` ranks. With a
    process group every rank of the world must call this in the same
    order (it creates the subgroups); the device is the one
    :func:`init_process_group` resolved (else ``cuda:<current>`` on
    ``nccl``, the CPU on ``gloo``) unless ``device`` names one, and the
    groups time out as the world does. Without a group the device is
    ``resolve_device(device)``: the card unless the caller asks for the
    CPU."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    ranks = list(devices if devices is not None else range(world))
    n = len(ranks)
    sizes = dict(axes)
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis size may be -1")
    known = math.prod(v for v in sizes.values() if v != -1)
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    need = math.prod(sizes.values())
    if need > n:
        raise ValueError(f"mesh {sizes} needs {need} devices, have {n}")
    # a fully-specified smaller mesh uses the first `need` ranks
    grid = np.array(ranks[:need], dtype=np.int64).reshape(
        *sizes.values())
    names = tuple(sizes.keys())
    rank = dist.get_rank() if initialized else 0
    if rank not in grid:
        rank = None
    if device is not None:
        dev = resolve_device(device)
    elif initialized and _world_device is not None:
        dev = _world_device
    elif initialized:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
    else:
        dev = resolve_device(None)
    groups = {}
    control = backend = None
    if initialized:
        backend = dist.get_backend()
        # every rank creates every line's group, in one order
        for ai, name in enumerate(names):
            others = [range(s) for i, s in enumerate(grid.shape) if i != ai]
            for rest in itertools.product(*others):
                index = list(rest)
                index.insert(ai, slice(None))
                line = [int(r) for r in grid[tuple(index)]]
                group = dist.new_group(ranks=line, timeout=_world_timeout)
                if rank in line:
                    groups[name] = group
        # host messages: a gloo group over the grid
        control = dist.new_group(ranks=[int(r) for r in grid.flat],
                                 backend="gloo", timeout=_world_timeout)
        if rank is None:
            control = None
    return Mesh(grid, names, rank, dev, groups, control, backend)


def local_slice_size(mesh: Mesh, axis: str, dim: int) -> int:
    size = mesh_axes(mesh).get(axis, 1)
    if dim % size:
        raise ValueError(f"dim {dim} not divisible by {axis}={size}")
    return dim // size
