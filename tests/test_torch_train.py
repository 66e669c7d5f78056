"""The port's trainer at world size 1, in this process, against the JAX
package: the optimizer's arithmetic against optax, the one-rank step
against JAX's, train-state checkpoints both ways (a JAX-written step-2
state resumed by the port), the sharded restore, the model's
``constrain`` hook and the LM head's hand-written backward."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.checkpoint import Checkpointer as JCheckpointer
from gofr_tpu.models.llama import LlamaConfig as JLlamaConfig
from gofr_tpu.models.llama import llama_init, llama_prefill
from gofr_tpu.parallel.mesh import create_mesh as jcreate_mesh
from gofr_tpu.parallel.train import cross_entropy_loss as jce
from gofr_tpu.parallel.train import default_optimizer as jdefault_opt
from gofr_tpu.parallel.train import make_train_state as jstate
from gofr_tpu.parallel.train import make_train_step as jstep
from gofr_tpu_torch.checkpoint import Checkpointer, flatten
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.models.convert import (params_from_jax,
                                           train_state_from_jax)
from gofr_tpu_torch.ops.quant import HeadProduct, qmatmul_t
from gofr_tpu_torch.parallel import sharding as tsharding
from gofr_tpu_torch.parallel import train as ttrain
from gofr_tpu_torch.parallel.mesh import create_mesh

torch.set_num_threads(2)

#: tests/test_checkpoint.py's resume config: 38 leaves in a train state
CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           ffn_dim=64, max_seq=32)
JCFG = JLlamaConfig(**CFG, dtype=jnp.float32)
TCFG = tllama.LlamaConfig(**CFG, dtype=torch.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(i, b=2, s=16):
    toks = np.asarray(jax.random.randint(jax.random.key(i), (b, s + 1), 0,
                                         64))
    return toks[:, :-1], toks[:, 1:], np.ones((b, s), np.int32)


def _t(batch):
    return tuple(torch.from_numpy(np.array(x)) for x in batch)


def _mesh():
    return create_mesh({"dp": 1, "tp": 1}, device="cpu")


def _port_state(np_params):
    return ttrain.make_train_state(
        torch.Generator(), TCFG, _mesh(),
        init_fn=lambda c, g, d: params_from_jax(np_params, c, d))[0]


def _leaves(tree):
    return [leaf for _, leaf in flatten(tree)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's one-device run of 4 steps: its step-2 state saved by its
    Checkpointer, that state and the last as numpy, the 4 losses."""
    directory = tmp_path_factory.mktemp("jax_ckpt")
    mesh = jcreate_mesh({"dp": 1, "tp": 1}, jax.devices()[:1])
    step = jstep(JCFG, mesh, donate=False)
    state, _ = jstate(jax.random.key(0), JCFG, mesh)
    losses = []
    for i in range(4):
        state, loss = step(state, *_batch(i))
        losses.append(float(loss))
        if i == 1:
            JCheckpointer(directory).save(2, state)
            state2 = _np(state)
    return directory, state2, _np(state), losses


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("scale", [0.01, 10.0])   # below / above the clip
def test_default_optimizer_matches_optax(scale):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32),
              "n": {"b": rng.standard_normal((8,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                          .astype(np.float32), params) for _ in range(3)]
    jopt = jdefault_opt()
    jp, js = params, jopt.init(params)
    topt = ttrain.default_optimizer()
    tp = jax.tree.map(torch.from_numpy, params)
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        tp = ttrain.apply_updates(tp, tupd)
    for got, want in zip(_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    # optax's state tree, leaf for leaf (count int32, moments in the
    # parameters' dtype)
    got = _leaves(ts)
    want = jax.tree.leaves(js)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    for mask in (None, np.array([[1, 1, 0, 1, 0], [0, 0, 0, 0, 1]]),
                 np.zeros((2, 5), np.int32)):
        want = jce(jnp.asarray(logits), jnp.asarray(targets),
                   None if mask is None else jnp.asarray(mask))
        got = ttrain.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------ the step

def test_one_rank_step_matches_jax(jax_run):
    want = jax_run[3]
    state = _port_state(_np(llama_init(jax.random.key(0), JCFG)))
    step = ttrain.make_train_step(TCFG, _mesh(), donate=False)
    got = []
    for i in range(4):
        state, loss = step(state, *_t(_batch(i)))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert int(state.step) == 4


def test_resume_is_bit_for_bit(tmp_path):
    np_params = _np(llama_init(jax.random.key(0), JCFG))
    step = ttrain.make_train_step(TCFG, _mesh(), donate=False)
    ref = _port_state(np_params)
    for i in range(4):
        ref, ref_loss = step(ref, *_t(_batch(i)))

    state = _port_state(np_params)
    for i in range(2):
        state, _ = step(state, *_t(_batch(i)))
    ckpt = Checkpointer(tmp_path)
    ckpt.save(2, state)
    resumed = ckpt.restore(like=_port_state(np_params))
    assert isinstance(resumed, ttrain.TrainState)
    assert int(resumed.step) == 2
    for i in range(2, 4):
        resumed, loss = step(resumed, *_t(_batch(i)))
    assert float(loss) == float(ref_loss)
    for a, b in zip(_leaves(resumed), _leaves(ref)):
        assert torch.equal(a, b)


def test_jax_written_train_state_resumes_in_the_port(jax_run):
    """JAX saves its step-2 state; the port restores it (JAX's 38 leaves
    under JAX's keys) and runs steps 3-4 to JAX's numbers."""
    tmp_path, _, jax_state, jax_losses = jax_run
    template = _port_state(_np(llama_init(jax.random.key(0), JCFG)))
    ckpt = Checkpointer(tmp_path)
    flat = ckpt.restore(2)
    assert len(flat) == 38
    assert list(flat) == [k for k, _ in flatten(template)]
    assert "[<flat index 1>][1][0].count" in flat
    resumed = ckpt.restore(2, like=template)
    assert resumed.opt_state[1][0].count.dtype == torch.int32
    assert int(resumed.opt_state[1][0].count) == int(resumed.step) == 2
    step = ttrain.make_train_step(TCFG, _mesh(), donate=False)
    losses = []
    for i in range(2, 4):
        resumed, loss = step(resumed, *_t(_batch(i)))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_losses[2:], rtol=1e-5, atol=1e-5)
    for got, want in zip(_leaves(resumed), jax.tree.leaves(jax_state)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_train_state_from_jax_matches_the_checkpoint_path(jax_run):
    tmp_path, jax_state = jax_run[:2]
    template = _port_state(_np(llama_init(jax.random.key(0), JCFG)))
    restored = Checkpointer(tmp_path).restore(2, like=template)
    converted = train_state_from_jax(jax_state, TCFG, "cpu")
    assert isinstance(converted, ttrain.TrainState)
    assert [k for k, _ in flatten(converted)] == \
        [k for k, _ in flatten(template)]
    for a, b in zip(_leaves(converted), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_written_train_state_restores_in_jax(tmp_path):
    state = _port_state(_np(llama_init(jax.random.key(0), JCFG)))
    step = ttrain.make_train_step(TCFG, _mesh(), donate=False)
    state, _ = step(state, *_t(_batch(0)))
    Checkpointer(tmp_path).save(1, state)
    mesh = jcreate_mesh({"dp": 1, "tp": 1}, jax.devices()[:1])
    like, _ = jstate(jax.random.key(0), JCFG, mesh)
    restored = JCheckpointer(tmp_path).restore(1, like=like)
    for got, want in zip(jax.tree.leaves(restored), _leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_zero_d_leaves_stay_zero_d(tmp_path):
    """A step or optax's ``count`` is 0-d in both packages' trees; the
    restore keeps it 0-d, whoever wrote it."""
    Checkpointer(tmp_path / "port").save(1, {"step": torch.tensor(7),
                                             "w": torch.ones(2, 3)})
    JCheckpointer(tmp_path / "jax").save(1, {"step": jnp.int32(7),
                                             "w": jnp.ones((2, 3))})
    for who in ("port", "jax"):
        got = Checkpointer(tmp_path / who).restore(1)
        assert got["['step']"].shape == ()
        assert int(got["['step']"]) == 7
        assert got["['w']"].shape == (2, 3)


# ------------------------------------------------------ sharded restore

def test_restore_with_sharding_fn_gives_each_rank_its_slice(tmp_path):
    np_params = _np(llama_init(jax.random.key(0), JCFG))
    state = _port_state(np_params)
    Checkpointer(tmp_path).save(1, state)
    base = create_mesh({"tp": 2}, devices=[0, 1], device="cpu")
    specs = tsharding.llama_param_specs(base)
    for rank in (0, 1):
        mesh = create_mesh({"tp": 2}, devices=[0, 1], device="cpu")
        mesh.rank = rank

        def sharding_fn(key, mesh=mesh):
            path = [p.strip("'") for p in
                    key.replace("]", "").split("[")[1:]]
            if path[0] != "<flat index 0>":
                return None                        # moments, step: whole
            spec = specs
            for p in path[1:]:
                spec = spec[p]
            return tsharding.Sharding(mesh, spec)

        got = Checkpointer(tmp_path).restore(
            1, like=_port_state(np_params), sharding_fn=sharding_fn)
        want = tsharding.shard_params(state.params, mesh, specs)
        for (key, a), (_, b) in zip(flatten(got.params), flatten(want)):
            assert a.shape == b.shape and torch.equal(a, b), key
        wq = got.params["layers"]["wq"]
        assert wq.shape[-1] == state.params["layers"]["wq"].shape[-1] // 2
        assert torch.equal(got.opt_state[1][0].mu["embed"],
                           state.opt_state[1][0].mu["embed"])


def test_shard_params_keeps_one_tp_th_of_each_sharded_leaf():
    params = tllama.llama_init(TCFG, torch.Generator().manual_seed(0), "cpu")
    mesh = create_mesh({"tp": 2}, devices=[0, 1], device="cpu")
    mesh.rank = 1
    local = tsharding.shard_params(params, mesh,
                                   tsharding.llama_param_specs(mesh))
    assert torch.equal(local["embed"], params["embed"][32:])
    assert torch.equal(local["layers"]["wo"],
                       params["layers"]["wo"][:, 16:, :])
    assert torch.equal(local["layers"]["w1"],
                       params["layers"]["w1"][:, :, 32:])
    assert torch.equal(local["final_norm"], params["final_norm"])
    sharded = [k for k in params["layers"] if not k.endswith("norm")]
    for k in sharded:
        assert local["layers"][k].numel() * 2 == params["layers"][k].numel()


def test_match_specs_descends_into_quantized_leaves():
    from gofr_tpu_torch.ops.quant import quantize_llama_int8
    params = tllama.llama_init(TCFG, torch.Generator().manual_seed(0), "cpu")
    mesh = create_mesh({"pp": 2, "tp": 2}, devices=list(range(4)),
                       device="cpu")
    specs = tsharding._match_specs(quantize_llama_int8(params),
                                   tsharding.llama_param_specs(mesh))
    # [L, out, in] codes: wq column-parallel over out, wo row-parallel
    # over in; the scales' collapsed axis stays unsharded
    assert tuple(specs["layers"]["wq"]["q"]) == ("pp", "tp", None)
    assert tuple(specs["layers"]["wq"]["s"]) == ("pp", "tp", None)
    assert tuple(specs["layers"]["wo"]["q"]) == ("pp", None, "tp")
    assert tuple(specs["layers"]["wo"]["s"]) == ("pp", None, None)
    assert tuple(specs["embed"]["q"]) == ("tp", None)
    assert tuple(specs["embed"]["s"]) == ("tp", None)
    assert "lm_head" in specs


# --------------------------------------------- the model's constrain hook

def test_constrain_hook_matches_jax():
    np_params = _np(llama_init(jax.random.key(0), JCFG))
    tokens = np.array(_batch(3)[0])
    calls = []

    def jcon(x):
        calls.append("j")
        return x * 2.0

    def tcon(x):
        calls.append("t")
        return x * 2.0

    want, _ = llama_prefill(jax.tree.map(jnp.asarray, np_params),
                            jnp.asarray(tokens), JCFG,
                            implementation="xla", constrain=jcon)
    params = params_from_jax(np_params, TCFG, "cpu")
    got, _ = tllama.llama_prefill(params, torch.from_numpy(tokens), TCFG,
                                  implementation="plain", constrain=tcon)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # after the embedding and after each block (JAX traces its scanned
    # block once, so its Python count is 2; the logits carry the 2^(L+1))
    assert calls.count("t") == CFG["n_layers"] + 1
    # no hook: the serving forward's bits do not move
    plain, _ = tllama.llama_prefill(params, torch.from_numpy(tokens), TCFG)
    ident, _ = tllama.llama_prefill(params, torch.from_numpy(tokens), TCFG,
                                    constrain=lambda x: x)
    assert torch.equal(plain, ident)
    lens = torch.tensor([16, 9])
    last, _ = tllama.llama_prefill_last(params, torch.from_numpy(tokens),
                                        TCFG, kv_lengths=lens,
                                        constrain=lambda x: x)
    last_ref, _ = tllama.llama_prefill_last(params, torch.from_numpy(tokens),
                                            TCFG, kv_lengths=lens)
    assert torch.equal(last, last_ref)


# ------------------------------------------------------------ the head

def test_head_product_backward_matches_the_plain_product():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 32, generator=g).bfloat16().requires_grad_()
    w = (0.1 * torch.randn(48, 32, generator=g)).bfloat16().requires_grad_()
    dy = torch.randn(6, 48, generator=g)
    out = qmatmul_t(x, w, out_dtype=torch.float32)    # the tied head
    assert out.dtype == torch.float32
    out.backward(dy)
    xf = x.detach().float().requires_grad_()
    wf = w.detach().float().requires_grad_()
    ref = xf @ wf.t()
    assert torch.equal(out.detach(), ref.detach())    # forward unchanged
    ref.backward(dy)
    assert x.grad.dtype == x.dtype and w.grad.dtype == w.dtype
    for got, want in ((x.grad, xf.grad), (w.grad, wf.grad)):
        # bf16 products of the rounded gradient: within bf16 rounding
        tol = 2 ** -7 * want.abs().max() * 4
        assert (got.float() - want).abs().max() <= tol
    # the Function alone, both operands
    a = torch.randn(3, 5, generator=g).bfloat16().requires_grad_()
    b = torch.randn(5, 4, generator=g).bfloat16().requires_grad_()
    HeadProduct.apply(a, b).sum().backward()
    np.testing.assert_allclose(
        a.grad.float().numpy(),
        np.broadcast_to(b.detach().float().sum(1).numpy(), (3, 5)),
        rtol=2 ** -7, atol=2 ** -7)
