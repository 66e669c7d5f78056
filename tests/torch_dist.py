"""Rank workers for the port's multi-rank CPU tests (``gloo``).

A test computes its JAX references in its own process and hands them
to :func:`run_ranks` as numpy. The ranks are spawned processes that
import torch, numpy and the port only: ``tests/conftest.py`` sets the
8-device ``XLA_FLAGS`` for JAX, and a child must not import JAX. The
rendezvous is a file under the test's ``tmp_path`` (no TCP port, so
parallel test workers never collide). Every rank runs the same list of
jobs in order, each on a mesh of its own over one world; a rank pickles
its results, or its traceback, into ``tmp_path``. The parent joins the
ranks against one deadline: a rank that fails or outlives it fails the
call, and every rank still alive is killed.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch


def run_ranks(jobs: list, world: int, tmp_path, payload: dict,
              deadline_s: float = 240.0) -> list:
    """Run ``jobs`` (names of this module's ``job_*`` functions) on
    ``world`` ranks; returns per rank ``{job: result}``."""
    tmp = Path(tmp_path)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(list(jobs), rank, world, str(tmp), payload))
             for rank in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errors = {r: (tmp / f"error_{r}.txt").read_text()
              for r in range(world) if (tmp / f"error_{r}.txt").exists()}
    if errors:
        raise AssertionError("rank failed:\n" + "\n".join(
            f"--- rank {r}\n{e}" for r, e in sorted(errors.items())))
    if hung:
        raise AssertionError(f"ranks {hung} still running after "
                             f"{deadline_s} s")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} exited "
                             f"{[procs[r].exitcode for r in bad]}")
    return [pickle.loads((tmp / f"result_{r}.pkl").read_bytes())
            for r in range(world)]


def _worker(jobs, rank, world, tmp, payload):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from gofr_tpu_torch.parallel.mesh import init_process_group
        init_process_group("cpu", f"file://{tmp}/rendezvous", rank=rank,
                           world_size=world, timeout_s=120)
        out = {job: globals()[f"job_{job}"](payload[job]) for job in jobs}
        Path(tmp, f"result_{rank}.pkl").write_bytes(pickle.dumps(out))
        dist.destroy_process_group()
    except BaseException:
        Path(tmp, f"error_{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)


# ------------------------------------------------------------------ jobs

def _llama_config(kw: dict):
    from gofr_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(**kw, dtype=torch.float32)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _state_for(payload: dict, mesh, config, specs_fn=None):
    from gofr_tpu_torch.models.convert import params_from_jax
    from gofr_tpu_torch.parallel.train import make_train_state
    kw = {"specs_fn": specs_fn} if specs_fn is not None else {}
    return make_train_state(
        torch.Generator(), config, mesh,
        init_fn=lambda c, g, d: params_from_jax(payload["params"], c, d),
        **kw)[0]


def job_forward(p: dict):
    """The sharded forward at ``p["axes"]``: this rank's logits rows."""
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import Sharding
    from gofr_tpu_torch.parallel.train import _rows, sharded_forward
    c = _llama_config(p["config"])
    mesh = create_mesh(p["axes"])
    state = _state_for(p, mesh, c)
    tokens = torch.from_numpy(p["tokens"])
    with torch.no_grad():
        logits = sharded_forward(state.params, _rows(tokens, mesh), c, mesh)
    rows = Sharding(mesh, ("dp",)).index(tokens.shape)[0]
    return {"rows": (rows.start, rows.stop), "logits": logits.numpy(),
            "embed_shape": tuple(state.params["embed"].shape),
            "wq_shape": tuple(state.params["layers"]["wq"].shape)}


def job_dense(p: dict):
    """``p["steps"]`` dense steps at ``p["axes"]``: the losses and this
    rank's final shards (with the spec tree to place them)."""
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import (Sharding, _match_specs,
                                                  llama_param_specs)
    from gofr_tpu_torch.parallel.train import make_train_step
    c = _llama_config(p["config"])
    mesh = create_mesh(p["axes"])
    state = _state_for(p, mesh, c)
    step = make_train_step(c, mesh, donate=False)
    batch = [torch.from_numpy(p[k]) for k in ("tokens", "targets", "mask")]
    losses = []
    for _ in range(p["steps"]):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    specs = _match_specs(state.params, llama_param_specs(mesh))

    def index(tree, spec):
        if isinstance(tree, dict):
            return {k: index(v, spec[k]) for k, v in tree.items()}
        return [(s.start, s.stop) for s in
                Sharding(mesh, spec).index(tree.shape)]

    return {"losses": losses, "params": _numpy_tree(state.params),
            "step": int(state.step),
            "index": index(_full_shapes(p["params"]), specs)}


def _full_shapes(np_params):
    """Zero tensors of the global shapes (for the blocks' indices)."""
    if isinstance(np_params, dict):
        return {k: _full_shapes(v) for k, v in np_params.items()}
    return torch.empty(np.asarray(np_params).shape)


def job_pipeline(p: dict):
    """GPipe steps at ``p["axes"]`` with M = ``p["micro"]``: losses."""
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.pipeline import make_pipeline_train_step
    c = _llama_config(p["config"])
    mesh = create_mesh(p["axes"])
    state = _state_for(p, mesh, c)
    step = make_pipeline_train_step(c, mesh, num_microbatches=p["micro"],
                                    donate=False)
    batch = [torch.from_numpy(p[k]) for k in ("tokens", "targets", "mask")]
    losses = []
    for _ in range(p["steps"]):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return {"losses": losses,
            "layers": tuple(state.params["layers"]["wq"].shape)}


def job_moe(p: dict):
    """Expert-parallel steps at ``p["axes"]``: losses, local expert
    shapes."""
    from gofr_tpu_torch.models.moe import MoEConfig, moe_prefill
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import moe_param_specs
    from gofr_tpu_torch.parallel.train import make_train_step
    c = MoEConfig(**p["config"], dtype=torch.float32)
    mesh = create_mesh(p["axes"])
    state = _state_for(p, mesh, c, specs_fn=moe_param_specs)

    def fwd(params, tokens):
        return moe_prefill(params, tokens, c, implementation="plain",
                           mesh=mesh)[0]

    step = make_train_step(c, mesh, forward_fn=fwd, donate=False)
    batch = [torch.from_numpy(p[k]) for k in ("tokens", "targets", "mask")]
    losses = []
    for _ in range(p["steps"]):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return {"losses": losses,
            "w1": tuple(state.params["layers"]["w1"].shape)}


def job_ring(p: dict):
    """Ring attention at ``p["axes"]``: the output of ``p["q"]`` etc.
    and the gradients of ``(out ** 2).sum()`` for q, k and v."""
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.ring_attention import make_ring_attention
    mesh = create_mesh(p["axes"])
    ring = make_ring_attention(mesh, "sp")
    q, k, v = (torch.from_numpy(p[n]).requires_grad_() for n in "qkv")
    out = ring(q, k, v)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}
