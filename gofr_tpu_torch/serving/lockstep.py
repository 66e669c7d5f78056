"""Tensor-parallel serving ranks in lockstep.

The JAX engine needs nothing like it: one controller drives every device
of its mesh, and XLA runs each step on all of them. Here every rank of a
``tp`` mesh is a process holding its own shards (``llama_engine(mesh=)``),
so the ranks must run the same device operations in the same order.

Rank 0 of the mesh (its :attr:`~gofr_tpu_torch.parallel.mesh.Mesh.leader`)
runs the whole :class:`~gofr_tpu_torch.serving.engine.Engine`: the
scheduler, the prefix cache, admission and the sampling parameters. Every
other rank builds the same engine on its shards and runs :func:`follow`.
Before each device operation the leader broadcasts its op code and its
host arguments over the mesh's ``gloo`` control group
(:attr:`Mesh.control`); a follower runs the engine's ``_op_<code>`` method
with them, on its shards, and the tp collectives inside the model steps
(``parallel.comm.TensorParallel``) pair up. The inputs of every
operation are the host arrays the leader uploads from (tokens, lengths,
tables, sampling parameters), so they travel with the op code; no device
tensor is an input. The operations are the engine's device touch points:
``warmup``, ``prefill`` (the group prefill, its first tokens' sampling and
the prompt's K/V write), ``chunk`` (one chunk call of a walk: the dense
rows, the chunk step, the write-back, the sampling), ``verify`` (a tree
verify, its resolution and the compaction), ``upload`` (the decode
state and tables), ``launch`` and ``collect`` (a decode dispatch), and
``stop``, which releases the followers. Every sampling call runs on
every rank on the same whole logits with a generator seeded alike, so
the generators advance the same way and a replayed decode pass feeds
every rank the same tokens.

Checks: at each ``collect`` and ``verify`` every rank all-reduces a digest
of (operations run, the tokens it read) over the control group; a rank
that skipped or repeated an operation, or drew other tokens, makes
every rank raise :class:`LockstepError`. A follower that dies breaks the
control group's connections, and a collective waiting on a rank that
does not come raises after the process group's timeout
(``init_process_group(timeout_s=)``): either way the leader's engine loop
crashes (no restart on a mesh: a rank's state cannot be rebuilt alone)
and every request fails, within that timeout.
"""

from __future__ import annotations

import pickle
import zlib
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

#: the op codes a follower runs (each an ``Engine._op_<code>`` method)
OPS = ("warmup", "prefill", "chunk", "verify", "upload", "launch",
       "collect")
#: the codes that end a follower's loop
ENDS = ("stop", "abort")
_CODES = OPS + ENDS
#: how long the leader waits for an abort to leave (the followers may
#: be gone, or stuck in a collective the failure left unpaired)
ABORT_WAIT_S = 2.0


class LockstepError(RuntimeError):
    """The ranks of a tp mesh no longer run the same operations."""


class Lockstep:
    """The leader's and the followers' end of one mesh's op stream."""

    def __init__(self, mesh: Any) -> None:
        if mesh.control is None:
            raise ValueError("lockstep needs a mesh over a process group, "
                             "this rank inside it")
        self.group = mesh.control
        self.src = mesh.leader
        self.leader = mesh.rank == mesh.leader
        #: operations sent (the leader) or run (a follower)
        self.ops = 0
        self.released = False

    def send(self, op: str, args: tuple) -> None:
        """The leader: broadcast the next operation to the followers: a
        header (sequence number, op code, payload bytes), then the
        pickled host arguments."""
        if self.released:
            raise LockstepError("the followers were released")
        self.ops += 1
        payload = pickle.dumps(args, protocol=pickle.HIGHEST_PROTOCOL)
        dist.broadcast(torch.tensor([self.ops, _CODES.index(op),
                                     len(payload)], dtype=torch.int64),
                       src=self.src, group=self.group)
        dist.broadcast(torch.frombuffer(bytearray(payload),
                                        dtype=torch.uint8),
                       src=self.src, group=self.group)

    def recv(self) -> tuple:
        """A follower: (sequence number, op code, host arguments)."""
        header = torch.empty(3, dtype=torch.int64)
        dist.broadcast(header, src=self.src, group=self.group)
        seq, code, size = (int(v) for v in header)
        if _CODES[code] in ENDS:
            return seq, _CODES[code], ()
        payload = torch.empty(size, dtype=torch.uint8)
        dist.broadcast(payload, src=self.src, group=self.group)
        return seq, _CODES[code], pickle.loads(payload.numpy().tobytes())

    def check(self, tokens: np.ndarray) -> None:
        """Every rank: the digest of (operations run, ``tokens``) must be
        the same on every rank of the mesh, or every rank raises."""
        digest = zlib.crc32(np.ascontiguousarray(tokens).tobytes(),
                            self.ops & 0xFFFFFFFF)
        both = torch.tensor([digest, -digest], dtype=torch.int64)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        if int(both[0]) != -int(both[1]):
            raise LockstepError(
                f"ranks diverged by operation {self.ops}: their digests "
                f"of the operations run and the tokens drawn differ")

    def release(self, code: str = "stop") -> None:
        """The leader: end every follower's :func:`follow` (``"stop"``
        returns there, ``"abort"`` raises). Once only. An abort waits at
        most ``ABORT_WAIT_S`` for the header to leave, and a broken
        control group is left as it is: a follower that is gone, or
        stuck in a collective the failure left unpaired, ends on its
        own error or timeout."""
        if self.released or not self.leader:
            return
        self.released = True
        header = torch.tensor([self.ops + 1, _CODES.index(code), 0],
                              dtype=torch.int64)
        try:
            work = dist.broadcast(header, src=self.src, group=self.group,
                                  async_op=True)
            if code == "abort":
                work.wait(timeout=timedelta(seconds=ABORT_WAIT_S))
            else:
                work.wait()
        except Exception:  # noqa: BLE001 — the followers are gone already
            pass


def follow(engine: Any) -> int:
    """Run a follower rank: every operation the leader broadcasts, on
    this rank's engine, until the leader stops (returns the operations
    run). Raises :class:`LockstepError` when the leader aborts or the
    ranks diverge; a collective error propagates as it is."""
    lockstep = engine._lockstep
    if lockstep is None or lockstep.leader:
        raise ValueError("follow() runs on a follower rank of a mesh engine")
    with torch.no_grad():
        while True:
            _, op, args = lockstep.recv()
            if op == "stop":
                return lockstep.ops
            if op == "abort":
                raise LockstepError("the leader's engine crashed")
            if op not in OPS:
                raise LockstepError(f"unknown operation {op!r}")
            lockstep.ops += 1
            getattr(engine, f"_op_{op}")(*args)
