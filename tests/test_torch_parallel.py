"""The port's parallel layer (``gofr_tpu_torch/parallel/``) against the
JAX package's on the same mesh axes.

JAX runs on conftest's 8 virtual CPU devices in this process; the port
runs as four ``gloo`` ranks (``tests/torch_dist.py``), spawned once for
the whole file, each job on a mesh of its own: the sharded forward and
the dense step at ``{dp: 2, tp: 2}``, the GPipe step at ``{dp: 2, pp:
2}`` (M = 4), the expert-parallel MoE step at ``{dp: 2, ep: 2}`` and
ring attention at ``sp`` = 4. Every case is float32 at
``tests/test_parallel.py``'s sizes and starts from the same JAX
initialisation through ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JLlamaConfig
from gofr_tpu.models.llama import llama_init, llama_prefill
from gofr_tpu.models.moe import MoEConfig as JMoEConfig
from gofr_tpu.models.moe import moe_init, moe_prefill
from gofr_tpu.parallel import mesh as jmesh
from gofr_tpu.parallel.pipeline import make_pipeline_train_step as jpipe
from gofr_tpu.parallel.ring_attention import make_ring_attention as jring
from gofr_tpu.parallel.sharding import batch_spec as jbatch_spec
from gofr_tpu.parallel.sharding import (llama_param_specs as jspecs,
                                        moe_param_specs as jmoe_specs,
                                        shard_params as jshard)
from gofr_tpu.parallel.train import make_train_state as jstate
from gofr_tpu.parallel.train import make_train_step as jstep
from gofr_tpu_torch.parallel import mesh as tmesh
from gofr_tpu_torch.parallel import sharding as tsharding
from tests.torch_dist import run_ranks

torch.set_num_threads(2)

TINY = dict(vocab_size=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=4,
            ffn_dim=64, max_seq=64)
MOE = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=4,
           ffn_dim=48, max_seq=64, n_experts=4, top_k=2)
JTINY = JLlamaConfig(**TINY, dtype=jnp.float32)
JMOE = JMoEConfig(**MOE, dtype=jnp.float32)
DENSE_STEPS, PIPE_STEPS, MOE_STEPS = 5, 3, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(b=8, s=16, vocab=64):
    tokens = jax.random.randint(jax.random.key(1), (b, s + 1), 0, vocab)
    return (np.asarray(tokens[:, :-1]), np.asarray(tokens[:, 1:]),
            np.ones((b, s), np.int32))


def _losses(step, state, batch, n):
    out = []
    for _ in range(n):
        state, loss = step(state, *batch)
        out.append(float(loss))
    return state, out


@pytest.fixture(scope="module")
def refs():
    """JAX's numbers for every job, and the payloads the ranks get."""
    params = _np(llama_init(jax.random.key(0), JTINY))
    tokens, targets, mask = _batch()
    batch = {"tokens": tokens, "targets": targets, "mask": mask}
    out, payload = {}, {}

    # sharded forward at {dp: 2, tp: 2}
    mesh = jmesh.create_mesh({"dp": 2, "tp": 2})
    fwd_tokens = np.asarray(jax.random.randint(jax.random.key(1), (4, 16),
                                               0, 64))
    sharded = jshard(jax.tree.map(jnp.asarray, params), mesh, jspecs(mesh))
    out["forward"] = np.asarray(jax.jit(lambda p, t: llama_prefill(
        p, t, JTINY, implementation="xla")[0])(sharded, fwd_tokens))
    payload["forward"] = {"config": TINY, "axes": {"dp": 2, "tp": 2},
                          "params": params, "tokens": fwd_tokens}

    # dense step at {dp: 2, tp: 2}
    state, _ = jstate(jax.random.key(0), JTINY, mesh)
    state, losses = _losses(jstep(JTINY, mesh, donate=False), state,
                            (tokens, targets, mask), DENSE_STEPS)
    out["dense"] = {"losses": losses, "params": _np(state.params),
                    "step": int(state.step)}
    payload["dense"] = {"config": TINY, "axes": {"dp": 2, "tp": 2},
                        "params": params, "steps": DENSE_STEPS, **batch}

    # GPipe at {dp: 2, pp: 2}, M = 4
    pmesh = jmesh.create_mesh({"dp": 2, "pp": 2})
    micro = {k: v.reshape(4, 2, *v.shape[1:]) for k, v in batch.items()}
    state, _ = jstate(jax.random.key(0), JTINY, pmesh)
    _, out["pipeline"] = _losses(
        jpipe(JTINY, pmesh, num_microbatches=4, donate=False), state,
        tuple(micro[k] for k in ("tokens", "targets", "mask")), PIPE_STEPS)
    payload["pipeline"] = {"config": TINY, "axes": {"dp": 2, "pp": 2},
                           "params": params, "steps": PIPE_STEPS,
                           "micro": 4, **micro}

    # expert-parallel MoE at {dp: 2, ep: 2}
    emesh = jmesh.create_mesh({"dp": 2, "ep": 2})

    def moe_fwd(p, t):
        return moe_prefill(p, t, JMOE, implementation="xla")[0]

    state, _ = jstate(jax.random.key(0), JMOE, emesh, init_fn=moe_init,
                      specs_fn=jmoe_specs)
    _, out["moe"] = _losses(jstep(JMOE, emesh, forward_fn=moe_fwd,
                                  donate=False), state,
                            (tokens, targets, mask), MOE_STEPS)
    payload["moe"] = {"config": MOE, "axes": {"dp": 2, "ep": 2},
                      "params": _np(moe_init(jax.random.key(0), JMOE)),
                      "steps": MOE_STEPS, **batch}

    # ring attention at sp = 4
    rmesh = jmesh.create_mesh({"sp": 4})
    ring = jring(rmesh, "sp")
    q, k, v = (jax.random.normal(jax.random.key(i), (2, 32, 2, 8))
               for i in range(3))
    grads = jax.grad(lambda q, k, v: (ring(q, k, v) ** 2).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    out["ring"] = {"out": np.asarray(ring(q, k, v)),
                   "grads": [np.asarray(g) for g in grads]}
    payload["ring"] = {"axes": {"sp": 4}, "q": np.asarray(q),
                       "k": np.asarray(k), "v": np.asarray(v)}
    return out, payload


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    _, payload = refs
    return run_ranks(["forward", "dense", "pipeline", "moe", "ring"], 4,
                     tmp_path_factory.mktemp("ranks"), payload)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("axes", [
    {"dp": 2, "tp": 4}, {"dp": 2, "tp": -1}, {"dp": -1, "pp": 2, "tp": 2},
    {"tp": 4}, {"sp": 8}, {"dp": 1}, {"dp": 2, "ep": 2}])
def test_create_mesh_shapes_match_jax(axes):
    want = jmesh.mesh_axes(jmesh.create_mesh(axes))
    mesh = tmesh.create_mesh(axes, devices=list(range(8)), device="cpu")
    assert tmesh.mesh_axes(mesh) == want
    # JAX's grid of device ids is the port's grid of ranks
    grid = np.vectorize(lambda d: d.id)(jmesh.create_mesh(axes).devices)
    np.testing.assert_array_equal(mesh.ranks, grid)


@pytest.mark.parametrize("axes", [
    {"dp": 3, "tp": 4}, {"dp": -1, "tp": -1}, {"dp": 3, "tp": -1},
    {"dp": 4, "tp": 4}])
def test_create_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as jerr:
        jmesh.create_mesh(axes)
    with pytest.raises(ValueError) as terr:
        tmesh.create_mesh(axes, devices=list(range(8)), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_local_slice_size_matches_jax():
    jm = jmesh.create_mesh({"dp": 2, "tp": 4})
    tm = tmesh.create_mesh({"dp": 2, "tp": 4}, devices=list(range(8)),
                           device="cpu")
    for axis, dim in (("tp", 32), ("dp", 8), ("pp", 5)):
        assert tmesh.local_slice_size(tm, axis, dim) == \
            jmesh.local_slice_size(jm, axis, dim)
    for mod, m in ((jmesh, jm), (tmesh, tm)):
        with pytest.raises(ValueError):
            mod.local_slice_size(m, "tp", 30)


@pytest.mark.parametrize("axes", [
    {"dp": 2, "tp": 4}, {"dp": 2, "pp": 2, "tp": 2}, {"dp": 2, "ep": 4},
    {"sp": 8}, {"tp": 2, "ep": 2, "pp": 2}])
def test_param_specs_match_jax(axes):
    jm = jmesh.create_mesh(axes)
    tm = tmesh.create_mesh(axes, devices=list(range(8)), device="cpu")
    to_tuple = lambda tree: jax.tree.map(  # noqa: E731
        tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert to_tuple(jspecs(jm)) == jax.tree.map(
        tuple, tsharding.llama_param_specs(tm),
        is_leaf=lambda x: isinstance(x, tuple))
    assert to_tuple(jmoe_specs(jm)) == jax.tree.map(
        tuple, tsharding.moe_param_specs(tm),
        is_leaf=lambda x: isinstance(x, tuple))
    assert tuple(tsharding.batch_spec(tm)) == tuple(jbatch_spec(jm))


# ------------------------------------------------------- against the ranks

def test_sharded_forward_matches_jax(refs, ranks):
    want = refs[0]["forward"]
    for r in ranks:
        got = r["forward"]
        lo, hi = got["rows"]
        _close(got["logits"], want[lo:hi], 1e-4)
        # a rank holds only its shards: 1/tp of the vocabulary, the heads
        assert got["embed_shape"] == (TINY["vocab_size"] // 2, TINY["dim"])
        assert got["wq_shape"] == (TINY["n_layers"], TINY["dim"],
                                   TINY["dim"] // 2)


def test_dense_step_matches_jax(refs, ranks):
    want = refs[0]["dense"]
    for r in ranks:
        got = r["dense"]
        _close(got["losses"], want["losses"], 1e-4)
        assert got["losses"][-1] < got["losses"][0]
        assert got["step"] == want["step"] == DENSE_STEPS

        def check(g, w, idx):
            if isinstance(g, dict):
                for k in g:
                    check(g[k], w[k], idx[k])
                return
            block = tuple(slice(a, b) for a, b in idx)
            _close(g, np.asarray(w)[block], 1e-4)

        check(got["params"], want["params"], got["index"])


def test_pipeline_step_matches_jax(refs, ranks):
    want = refs[0]["pipeline"]
    for r in ranks:
        got = r["pipeline"]
        _close(got["losses"], want, 1e-4)
        assert got["losses"][-1] < got["losses"][0]
        assert got["layers"][0] == TINY["n_layers"] // 2   # this stage's


def test_moe_ep_step_matches_jax(refs, ranks):
    want = refs[0]["moe"]
    for r in ranks:
        got = r["moe"]
        _close(got["losses"], want, 1e-4)
        assert got["losses"][-1] < got["losses"][0]
        assert got["w1"][1] == MOE["n_experts"] // 2       # its experts


def test_ring_attention_matches_jax(refs, ranks):
    want = refs[0]["ring"]
    for r in ranks:
        got = r["ring"]
        _close(got["out"], want["out"], 1e-5)
        for name, g in zip(("dq", "dk", "dv"), want["grads"]):
            _close(got[name], g, 1e-4)


# ------------------------------------------------- the errors JAX raises

def test_pipeline_refuses_what_jax_refuses():
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from gofr_tpu_torch.parallel.train import make_train_step
    tc = LlamaConfig(**TINY, dtype=torch.float32)
    cases = [({"pp": 2, "tp": 2}, 2), ({"dp": 2, "pp": 4}, 2)]
    for axes, micro in cases:
        with pytest.raises(ValueError) as jerr:
            jpipe(JTINY, jmesh.create_mesh(axes), num_microbatches=micro)
        tm = tmesh.create_mesh(axes, devices=list(range(8)), device="cpu")
        with pytest.raises(ValueError) as terr:
            make_pipeline_train_step(tc, tm, num_microbatches=micro)
        assert str(terr.value) == str(jerr.value)
    jm = jmesh.create_mesh({"dp": 2, "pp": 4})
    tm = tmesh.create_mesh({"dp": 2, "pp": 4}, devices=list(range(8)),
                           device="cpu")
    with pytest.raises(ValueError) as jerr:
        jstep(JTINY, jm, forward_fn=lambda p, t: t)
    with pytest.raises(ValueError) as terr:
        make_train_step(tc, tm, forward_fn=lambda p, t: t)
    assert str(terr.value) == str(jerr.value)
