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


def _optimizer(p: dict):
    """The job's optimizer: the default, or with ``p["sgd_clip_lr"]``
    the global-norm clip at 1.0 then plain SGD at that rate."""
    from gofr_tpu_torch.parallel.train import (chain, clip_by_global_norm,
                                               scale_by_learning_rate)
    if "sgd_clip_lr" not in p:
        return None
    return chain(clip_by_global_norm(1.0),
                 scale_by_learning_rate(p["sgd_clip_lr"]))


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
    step = make_train_step(c, mesh, donate=False, optimizer=_optimizer(p))
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
                                    donate=False, optimizer=_optimizer(p))
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


# ------------------------------------------------- tensor-parallel serving

def _tiny_params(payload: dict):
    from gofr_tpu_torch.models.convert import params_from_jax
    from gofr_tpu_torch.models.llama import LlamaConfig
    c = LlamaConfig.tiny()
    return c, params_from_jax(payload["params"], c, "cpu")


def job_tp_steps(p: dict):
    """The tp forms of ``llama_prefill_last``, ``llama_decode_step`` and
    ``llama_prefill_chunk`` (plain and tree mode) on this rank's shards
    at ``{tp: 2}``: logits, and this rank's KV head count."""
    from gofr_tpu_torch.models.llama import (llama_decode_step,
                                             llama_prefill_chunk,
                                             llama_prefill_last)
    from gofr_tpu_torch.parallel.comm import TensorParallel
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import (llama_param_specs,
                                                  shard_params)
    mesh = create_mesh({"tp": 2})
    if mesh.rank is None:
        return None
    c, full = _tiny_params(p)
    params = shard_params(full, mesh, llama_param_specs(mesh))
    tp = TensorParallel(mesh)
    t = {k: torch.from_numpy(v) for k, v in p["inputs"].items()}
    with torch.no_grad():
        logits, (k, v) = llama_prefill_last(params, t["tokens"], c,
                                            kv_lengths=t["kv_len"], tp=tp)
        shape = (c.n_layers, k.shape[1], p["max_seq"], k.shape[3],
                 c.head_dim)
        kc, vc = torch.zeros(shape), torch.zeros(shape)
        kc[:, :, :k.shape[2]], vc[:, :, :k.shape[2]] = k, v
        decode, kc, vc = llama_decode_step(params, t["next"], kc, vc,
                                           t["kv_len"], c, tp=tp)
        chunk, kc, vc = llama_prefill_chunk(
            params, t["chunk"], kc, vc, t["kv_len"] + 1, t["chunk_len"], c,
            tp=tp)
        tree, _, _ = llama_prefill_chunk(
            params, t["tree"], kc, vc, t["tree_off"], t["tree_len"], c,
            return_all_logits=True, tree_depths=t["depths"],
            tree_masks=t["masks"], tp=tp)
    return {"prefill": logits.numpy(), "decode": decode.numpy(),
            "chunk": chunk.numpy(), "tree": tree.numpy(),
            "kv_heads": int(k.shape[3])}


def job_tp_shards(p: dict):
    """Shard shapes of a tp-2 engine's params and caches (bf16 tree,
    int8, int4), and the refusal of an int4 split inside a byte."""
    from gofr_tpu_torch.ops.quant import quantize_int4
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import P, shard_params
    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.glue import llama_engine
    mesh = create_mesh({"tp": 2})
    if mesh.rank is None:
        return None
    c, full = _tiny_params(p)
    out = {}
    for layout in ("slot", "paged"):
        eng = llama_engine(full, c, EngineConfig(
            max_batch=2, max_seq=64, page_size=16, kv_layout=layout),
            mesh=mesh)
        out[layout] = {"wq": tuple(eng.params["layers"]["wq"].shape),
                       "wo": tuple(eng.params["layers"]["wo"].shape),
                       "embed": tuple(eng.params["embed"].shape),
                       "lm_head": tuple(eng.params["lm_head"].shape),
                       "k_cache": tuple(eng.k_cache.shape)}
    for form in ("int8", "int4"):
        eng = llama_engine(full, c, EngineConfig(max_batch=2, max_seq=64,
                                                 kv_layout="slot"),
                           mesh=mesh, quantize=form)
        layers = eng.params["layers"]
        out[form] = {name: (tuple(layers[name]["q"].shape),
                            tuple(layers[name]["s"].shape))
                     for name in ("wq", "wo", "w2")}
    odd = quantize_int4(torch.ones(4, 6))          # 3 bytes along K
    try:
        shard_params({"w": odd}, mesh, {"w": P(None, "tp")})
        out["int4_odd"] = None
    except ValueError as exc:
        out["int4_odd"] = str(exc)
    return out


def _serve_tp(engine, waves: list, n_new, sequential: bool) -> dict:
    """The leader: serve every prompt of ``waves`` greedily, all at once
    or, ``sequential``, one after another; ``n_new`` is one budget or
    one a prompt. Tokens, digests and counters."""
    from gofr_tpu_torch.serving.engine import SamplingParams
    prompts = [p for wave in waves for p in wave]
    budgets = n_new if isinstance(n_new, list) else [n_new] * len(prompts)
    groups = ([[i] for i in range(len(prompts))] if sequential
              else [list(range(len(prompts)))])
    reqs = [None] * len(prompts)
    engine.start()
    try:
        for group in groups:
            for i in group:
                reqs[i] = engine.submit(list(prompts[i]), SamplingParams(
                    temperature=0.0, max_new_tokens=budgets[i]))
            end = time.time() + 120
            while time.time() < end and any(
                    reqs[i].finished_at is None and reqs[i].error is None
                    for i in group):
                time.sleep(0.005)
    finally:
        engine.stop()
    return {"generated": [list(r.generated) for r in reqs],
            "errors": [r.error for r in reqs],
            "digests": [r.digest for r in reqs],
            "prompts": [list(r.prompt_tokens) for r in reqs],
            "stats": {k: engine.stats[k] for k in (
                "prefix_hits", "spec_passes", "graph_captures",
                "prefill_calls", "decode_passes")}}


def job_tp_engines(p: dict):
    """``llama_engine(mesh=)`` at ``p["axes"]`` on every case of
    ``p["cases"]``: the leader's results (None on a follower, with the
    operations it ran)."""
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.lockstep import follow
    c, full = _tiny_params(p)
    out = {}
    for name, case in p["cases"].items():
        mesh = create_mesh(p["axes"])
        if mesh.rank is None:
            out[name] = None
            continue
        eng = llama_engine(full, c, EngineConfig(**case["config"]),
                           mesh=mesh, quantize=case.get("quantize"))
        if mesh.rank == mesh.leader:
            out[name] = _serve_tp(eng, case["waves"], case["n_new"],
                                  case.get("sequential", False))
        else:
            out[name] = {"follower_ops": follow(eng)}
    return out


def _mesh_timing_out(timeout_s: float):
    """A ``{tp: 2}`` mesh whose tp and control groups time out after
    ``timeout_s`` (the world's groups wait longer; every rank of the
    world makes the groups, in one order)."""
    from datetime import timedelta

    import torch.distributed as dist

    from gofr_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh({"tp": 2})
    limit = timedelta(seconds=timeout_s)
    line = [int(r) for r in mesh.ranks.flat]
    tp = dist.new_group(ranks=line, timeout=limit)
    control = dist.new_group(ranks=line, backend="gloo", timeout=limit)
    if mesh.rank is not None:
        mesh.groups["tp"], mesh.control = tp, control
    return mesh


def job_tp_faults(p: dict):
    """Planted faults at ``{tp: 2}`` (collectives time out after
    ``p["timeout_s"]``): the follower drops operation ``p["skip_op"]``
    it receives, or skips the ``w2`` all-reduce. Per fault: the
    leader's request errors, or what the follower raised."""
    from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.lockstep import follow
    c, full = _tiny_params(p)
    out = {}
    for fault in ("skip", "drop_w2"):
        mesh = _mesh_timing_out(p["timeout_s"])
        if mesh.rank is None:
            out[fault] = None
            continue
        eng = llama_engine(full, c, EngineConfig(
            max_batch=2, max_seq=64, seed=11, kv_layout="slot",
            decode_steps_per_pass=2), mesh=mesh)
        t0 = time.monotonic()
        if mesh.rank == mesh.leader:
            eng.start()
            try:
                req = eng.submit([3, 1, 4, 1, 5], SamplingParams(
                    temperature=0.0, max_new_tokens=8))
                end = time.time() + 4 * p["timeout_s"]
                while time.time() < end and req.finished_at is None:
                    time.sleep(0.005)
            finally:
                eng.stop()
            out[fault] = {"error": req.error, "generated": req.generated,
                          "seconds": time.monotonic() - t0}
        else:
            if fault == "skip":
                recv = eng._lockstep.recv

                def recv_dropping_one(recv=recv, skip=p["skip_op"]):
                    seq, op, args = recv()
                    return recv() if seq == skip else (seq, op, args)

                eng._lockstep.recv = recv_dropping_one
            else:
                reduce = eng.tp.reduce
                eng.tp.reduce = lambda x, name, reduce=reduce: \
                    x if name == "w2" else reduce(x, name)
            try:
                follow(eng)
                out[fault] = {"raised": None}
            except Exception as exc:  # noqa: BLE001 — the fault's report
                out[fault] = {"raised": f"{type(exc).__name__}: {exc}"}
    return out


#: the engine cases again, at a mesh with dp replicas
job_tp_engines_dp = job_tp_engines
#: the dense and GPipe steps again, under the global-norm clip and SGD
job_dense_clip = job_dense
job_pipeline_clip = job_pipeline


def _boot_app(app):
    """Start ``app`` on an event loop in a thread -> (loop, thread)."""
    import asyncio
    import threading
    loop = asyncio.new_event_loop()
    booted = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def main():
            try:
                await app.start()
            finally:
                booted.set()
            await app._stop_event.wait()

        loop.run_until_complete(main())

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    if not booted.wait(30):
        raise TimeoutError("the app did not boot")
    return loop, thread


def job_tp_app(p: dict):
    """``App.serve_model`` of a tp-2 engine on the leader: ``POST /chat``
    greedy, the health route's devices; the unsharded engine's tokens on
    the same prompt. A follower's ``serve_model`` must refuse."""
    import asyncio
    import json
    import urllib.request
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config.env import DictConfig
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.lockstep import follow
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
    c = LlamaConfig.tiny().scaled(vocab_size=260)
    params = llama_init(c, torch.Generator().manual_seed(0), "cpu")
    config = EngineConfig(max_batch=2, max_seq=128, page_size=16, seed=0)
    mesh = create_mesh({"tp": 2})
    if mesh.rank is None:
        return None
    engine = llama_engine(params, c, config, mesh=mesh)
    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                                 "HTTP_HOST": "127.0.0.1"}))
    if mesh.rank != mesh.leader:
        try:
            app.serve_model("llama", engine, ByteTokenizer())
            refused = None
        except ValueError as exc:
            refused = str(exc)
        return {"refused": refused, "follower_ops": follow(engine)}
    app.serve_model("llama", engine, ByteTokenizer())
    loop, thread = _boot_app(app)
    try:
        port = app.http_server.bound_port
        body = json.dumps({"prompt": p["prompt"], "max_tokens": p["n_new"],
                           "temperature": 0}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/chat", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, answer = resp.status, json.loads(resp.read())["data"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/.well-known/health",
                timeout=30) as resp:
            health = json.loads(resp.read())["data"]
    finally:
        asyncio.run_coroutine_threadsafe(app.stop(), loop).result(30)
        thread.join(30)
    single = llama_engine(params, c, config, device="cpu")
    single.start()
    try:
        ref = single.submit(ByteTokenizer().encode(p["prompt"]),
                            SamplingParams(temperature=0.0,
                                           max_new_tokens=p["n_new"]))
        end = time.time() + 60
        while time.time() < end and ref.finished_at is None:
            time.sleep(0.005)
    finally:
        single.stop()
    return {"status": status, "tokens": answer["tokens"],
            "want": list(ref.generated), "health": health}
