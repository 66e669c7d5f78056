"""``chip_smoke.py``'s ``train_mesh`` phase on the CPU at a small size:
four ``gloo`` ranks (spawned by ``chip_smoke._run_ranks``, as on the
card) run the phase's jobs against the port's one-rank step, with the
phase's own comparison helpers (``chip_smoke._mesh_checks``), in bf16
and in float32:

- (a) the dense step at ``{dp: 2, tp: 2}``, (b) GPipe at ``{dp: 2, pp:
  2}`` with M = 4, (c) the expert-parallel MoE step at ``{dp: 2, ep:
  2}``, (d) ring attention at sp = 4 and (e) the sharded checkpoint's
  bit-for-bit resume, each against the one-rank reference;
- every planted fault of the phase must be rejected by its checks.

The sizes: ``LlamaConfig.tiny()`` with a tied embedding (2 layers: one
a GPipe stage), ``MoEConfig.tiny()`` at 1 layer (4 experts: 2 a rank),
4 x 16 tokens (MoE 4 x 8), ring q / k / v ``[1, 64, 4, 8]``.

The collectives ``comm.py`` now stages through the host on a ``gloo``
group (``_exchange`` under ``ppermute``, ``send`` / ``recv``) fail only
with CUDA tensors, whose device address ``gloo`` hands to its TCP
transport ("Bad address"): the CPU cannot show that fault, and the
card's ``train_mesh`` (b) and (d) stand in for a test of it. The
clip's global norm over a rank's shards, which the CPU does show, is
held against JAX in ``tests/test_torch_parallel.py``. The memory that
the card's MoE job ran out of — a gradient tree kept alive by a
reference cycle until the collector ran, and by the step through the
whole update — is held here by weak references, with the collector off.
"""

import gc
import sys
import weakref
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from gofr_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from gofr_tpu_torch.models.moe import MoEConfig  # noqa: E402

JOBS = ["a", "b", "c", "d", "e"]
PLANTED = ["a_wo_swapped", "a_dp_sum_skipped", "b_previous_activation",
           "c_first_expert_off", "d_diagonal_full", "d_hop_reversed",
           "e_wrong_moment"]


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def mesh_run(request):
    dtype = getattr(torch, request.param)
    cfg = LlamaConfig.tiny().scaled(dtype=dtype, tie_embeddings=True)
    moe = MoEConfig.tiny().scaled(n_layers=1, dtype=dtype)
    return cs.train_mesh_run(torch.device("cpu"), "", cfg=cfg, moe_cfg=moe,
                             ring_shape=(1, 64, 4, 8), batch_shape=(4, 16),
                             moe_shape=(4, 8), deadline_s=400.0)


@pytest.mark.parametrize("job", JOBS)
def test_each_mesh_job_matches_the_one_rank_step(mesh_run, job):
    assert mesh_run["failed_checks"][job] == []


@pytest.mark.parametrize("plant", PLANTED)
def test_each_planted_fault_is_rejected(mesh_run, plant):
    assert mesh_run["planted"][plant], plant


def test_the_phase_runs_every_job_and_plant(mesh_run):
    assert sorted(mesh_run["failed_checks"]) == sorted(JOBS)
    assert sorted(mesh_run["planted"]) == sorted(PLANTED)
    assert mesh_run["devices"] == ["cpu"] * cs.MESH_WORLD
    assert mesh_run["backend"] == "gloo"


def test_the_losses_fall_and_follow_the_reference(mesh_run):
    a = mesh_run["figures"]["a"]
    assert a["losses"][-1] < a["losses"][0] - cs.TRAIN_FALL
    for got, want in zip(a["grad_norms"], a["one_rank_grad_norms"]):
        assert abs(got - want) <= cs.MESH_NORM_RTOL * want
    assert len(a["step_ms"]) == cs.MESH_STEPS
    assert len(mesh_run["figures"]["b"]["losses"]) == cs.MESH_PIPE_STEPS
    assert len(mesh_run["figures"]["c"]["losses"]) == cs.MESH_MOE_STEPS


def test_leaf_specs_follow_the_parameters():
    """A train state's moments take their parameter's spec, the count
    and the step none."""
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.sharding import llama_param_specs
    from gofr_tpu_torch.parallel.train import make_train_state
    cfg = LlamaConfig.tiny().scaled(tie_embeddings=True)
    mesh = create_mesh({"dp": 2, "tp": 2}, devices=list(range(4)),
                       device="cpu")
    state, _ = make_train_state(torch.Generator().manual_seed(0), cfg, mesh)
    specs = cs._leaf_specs(state, llama_param_specs(mesh))
    assert specs["[<flat index 0>]['layers']['wq']"] == (None, None, "tp")
    assert specs["[<flat index 1>][1][0].mu['layers']['wo']"] == \
        (None, "tp", None)
    assert specs["[<flat index 1>][1][0].nu['embed']"] == ("tp", None)
    assert specs["[<flat index 1>][1][0].count"] == ()
    assert specs["[<flat index 2>]"] == ()
    assert "['lm_head']" not in " ".join(specs)


def _tiny_step(optimizer=None):
    from gofr_tpu_torch.parallel.mesh import create_mesh
    from gofr_tpu_torch.parallel.train import make_train_state, make_train_step
    cfg = LlamaConfig.tiny()
    mesh = create_mesh({"dp": 1}, device="cpu")
    state, optimizer = make_train_state(torch.Generator().manual_seed(0),
                                        cfg, mesh, optimizer=optimizer)
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = (toks[:, :-1], toks[:, 1:], torch.ones(2, 16, dtype=torch.int32))
    return make_train_step(cfg, mesh, optimizer=optimizer, donate=False), \
        state, batch


class _NoCollector:
    def __enter__(self):
        self.enabled = gc.isenabled()
        gc.disable()

    def __exit__(self, *exc):
        if self.enabled:
            gc.enable()


def test_a_steps_gradients_die_with_their_last_reference():
    from gofr_tpu_torch.parallel.train import _leaves
    step, state, batch = _tiny_step()
    with _NoCollector():
        _, grads = step.loss_and_grads(state.params, *batch)
        refs = [weakref.ref(g) for g in _leaves(grads)]
        del grads
        alive = sum(r() is not None for r in refs)
    assert alive == 0, f"{alive} of {len(refs)} gradient leaves outlive the tree"


def test_the_update_frees_the_gradients_once_the_clip_has_read_them():
    """Neither the step nor the chain keeps the gradient tree while the
    transforms after the clip run: at the update's peak every tree of
    the model's size counts."""
    from gofr_tpu_torch.parallel.train import (EmptyState,
                                               GradientTransformation, _leaves,
                                               chain, clip_by_global_norm,
                                               scale_by_learning_rate)
    seen: dict = {}

    def watch(first: bool):
        def update(updates, state, params=None, **extra):
            if first:
                seen["refs"] = [weakref.ref(g) for g in _leaves(updates)]
            else:
                seen["alive"] = sum(r() is not None for r in seen["refs"])
            return updates, state
        return GradientTransformation(lambda params: EmptyState(), update)

    step, state, batch = _tiny_step(chain(
        watch(True), clip_by_global_norm(1.0), watch(False),
        scale_by_learning_rate(1e-3)))
    with _NoCollector():
        step(state, *batch)
    assert seen["alive"] == 0, \
        f"{seen['alive']} gradient leaves alive after the clip"

