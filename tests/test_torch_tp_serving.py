"""The port's tensor-parallel serving (``llama_engine(mesh=)``, the tp
forms of the serving steps, ``serving/lockstep.py``) against the JAX
package's single-device and mesh serving, on the CPU.

The port runs as four ``gloo`` ranks (``tests/torch_dist.py``), spawned
once for the whole file, while JAX computes its references in this
process on conftest's 8 virtual devices: the tp steps against JAX's
unsharded ``llama_prefill_last`` / ``llama_decode_step`` /
``llama_prefill_chunk`` (tree mode too) on the same weights, within
1e-5; the shards' shapes; the tp-2 engine's greedy tokens and
``request_digest`` against JAX's single-device engine on the configs of
``tests/test_sharded_serving.py`` (the default, the chunk walk, int8
weights, the modern paged one with prefix hits and speculative passes)
and at ``{tp: 2, dp: 2}``, and once against JAX's own ``llama_engine(
mesh=create_mesh({"tp": 2}))``; a follower that skips an operation or
drops the ``w2`` all-reduce is caught; ``App.serve_model`` serves the
tp engine on the leader rank and refuses a follower's. Everything is
``LlamaConfig.tiny()`` (2 KV heads, float32; vocabulary 260 for the
app's byte tokenizer).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jllama
from gofr_tpu.models.llama import LlamaConfig as JLlamaConfig
from gofr_tpu.parallel.mesh import create_mesh as jcreate_mesh
from gofr_tpu.serving.engine import EngineConfig as JEngineConfig
from gofr_tpu.serving.engine import SamplingParams as JSamplingParams
from gofr_tpu.serving.glue import llama_engine as jllama_engine
from gofr_tpu.serving.integrity import request_digest
from gofr_tpu_torch.serving.spec import build_draft_tree
from tests.torch_dist import run_ranks
from tests.torch_parity import root_trees_at_the_current_token

torch.set_num_threads(2)

JTINY = JLlamaConfig.tiny()
STEP_TOL = 1e-5
MAX_SEQ = 32
FAULT_TIMEOUT_S = 4.0

# the engine cases of tests/test_sharded_serving.py (its default config
# is the JAX engine's slot layout, which the port names explicitly)
DEFAULT = dict(config=dict(max_batch=4, max_seq=128, seed=11),
               waves=[[[3 + i, 1, 4, 1, 5] for i in range(6)]], n_new=8)
WALK = dict(config=dict(max_batch=2, max_seq=128, prefill_buckets=(8,),
                        seed=11),
            waves=[[np.random.RandomState(9).randint(3, 200,
                                                     size=40).tolist()]],
            n_new=6)
INT8 = dict(config=dict(max_batch=4, max_seq=128, seed=11),
            waves=[[[3 + i, 1, 4, 1, 5] for i in range(4)]], n_new=8,
            quantize="int8")
SYSTEM = list(range(40, 72))
MODERN = dict(config=dict(max_batch=4, max_seq=128, prefill_buckets=(16, 32),
                          seed=11, kv_layout="paged", page_size=16,
                          prefix_cache=True, speculative=True, spec_draft=3,
                          spec_ngram=1, decode_steps_per_pass=2,
                          pipeline_depth=1),
              waves=[[list(range(3, 51)), SYSTEM + [7, 8, 9],
                      SYSTEM + [9, 8, 7]], [[5, 6] * 5]],
              n_new=[10, 10, 10, 24], sequential=True)


def _jax_serve(jparams, case, mesh=None, repaired=True):
    """The JAX engine on ``case``: per request (prompt, tokens, digest)
    and its counters. Its draft trees are rooted at the current token
    (``torch_parity.root_trees_at_the_current_token``: with a decode
    dispatch in flight while it drafts, as in the modern case, the JAX
    engine's own root is stale and its tokens depend on timing) unless
    ``repaired`` is False."""
    cfg = dict(case["config"], compile_cache_dir=None)
    eng = jllama_engine(jparams, JTINY, JEngineConfig(**cfg), mesh=mesh,
                        implementation="xla", quantize=case.get("quantize"))
    if repaired:
        root_trees_at_the_current_token(eng)
    prompts = [p for wave in case["waves"] for p in wave]
    n_new = case["n_new"]
    n_new = n_new if isinstance(n_new, list) else [n_new] * len(prompts)
    groups = ([[i] for i in range(len(prompts))] if case.get("sequential")
              else [list(range(len(prompts)))])
    reqs = [None] * len(prompts)
    eng.start()
    try:
        for group in groups:
            for i in group:
                reqs[i] = eng.submit(prompts[i], JSamplingParams(
                    temperature=0.0, max_new_tokens=n_new[i]))
            end = time.time() + 120
            while time.time() < end and any(
                    reqs[i].finished_at is None and reqs[i].error is None
                    for i in group):
                time.sleep(0.005)
    finally:
        eng.stop()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return {"generated": [list(r.generated) for r in reqs],
            "digests": [r.digest for r in reqs],
            "stats": dict(eng.stats)}


def _port_case(case):
    """The payload form of ``case``: the port's config, with the slot
    layout named where JAX's default config is meant."""
    config = dict(case["config"])
    config.setdefault("kv_layout", "slot")
    return {"config": config, "quantize": case.get("quantize"),
            "sequential": case.get("sequential", False),
            "waves": case["waves"], "n_new": case["n_new"]}


def _port_serve(np_params, case):
    """The port's unsharded engine on ``case``, on the CPU."""
    from gofr_tpu_torch.models.convert import params_from_jax
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.glue import llama_engine
    from tests.torch_dist import _serve_tp
    c = LlamaConfig.tiny()
    port = _port_case(case)
    engine = llama_engine(params_from_jax(np_params, c, "cpu"), c,
                          EngineConfig(**port["config"]), device="cpu")
    return _serve_tp(engine, port["waves"], port["n_new"],
                     port["sequential"])


def _step_inputs(rng):
    b, s = 2, 8
    trees = [build_draft_tree(5, [[1, 2, 3], [1, 7, 8]]),
             build_draft_tree(6, [[4, 4, 4]])]
    w = 8
    tree = np.zeros((b, w), np.int64)
    depths = np.zeros((b, w), np.int32)
    masks = np.ones((b, w), np.int32)
    for i, t in enumerate(trees):
        tree[i, :t.n_nodes] = t.tokens
        depths[i, :t.n_nodes] = t.depths
        masks[i, :t.n_nodes] = t.masks
    kv_len = np.array([8, 5], np.int32)
    chunk_len = np.array([4, 3], np.int32)
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int64),
            "kv_len": kv_len,
            "next": rng.integers(0, 256, (b,)).astype(np.int64),
            "chunk": rng.integers(0, 256, (b, 4)).astype(np.int64),
            "chunk_len": chunk_len, "tree": tree,
            "tree_off": kv_len + 1 + chunk_len,
            "tree_len": np.array([t.n_nodes for t in trees], np.int32),
            "depths": depths, "masks": masks}


def _jax_steps(jparams, t):
    j = {k: jnp.asarray(v) for k, v in t.items()}
    tokens = j["tokens"].astype(jnp.int32)
    logits, (k, v) = jllama.llama_prefill_last(
        jparams, tokens, JTINY, kv_lengths=j["kv_len"], implementation="xla")
    kc, vc = jllama.make_empty_cache(JTINY, tokens.shape[0], max_seq=MAX_SEQ)
    kc = kc.at[:, :, :tokens.shape[1]].set(k)
    vc = vc.at[:, :, :tokens.shape[1]].set(v)
    decode, kc, vc = jllama.llama_decode_step(
        jparams, j["next"].astype(jnp.int32), kc, vc, j["kv_len"], JTINY)
    chunk, kc, vc = jllama.llama_prefill_chunk(
        jparams, j["chunk"].astype(jnp.int32), kc, vc, j["kv_len"] + 1,
        j["chunk_len"], JTINY, implementation="xla")
    tree, _, _ = jllama.llama_prefill_chunk(
        jparams, j["tree"].astype(jnp.int32), kc, vc, j["tree_off"],
        j["tree_len"], JTINY, implementation="xla", return_all_logits=True,
        tree_depths=j["depths"], tree_masks=j["masks"])
    return {name: np.asarray(x) for name, x in (
        ("prefill", logits), ("decode", decode), ("chunk", chunk),
        ("tree", tree))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results (spawned in a thread) and JAX's references
    (computed here meanwhile)."""
    jparams = jllama.llama_init(jax.random.key(0), JTINY)
    np_params = jax.tree.map(np.asarray, jparams)
    inputs = _step_inputs(np.random.default_rng(5))
    cases = {"default": DEFAULT, "walk": WALK, "int8": INT8,
             "modern": MODERN}
    payload = {
        "tp_steps": {"params": np_params, "inputs": inputs,
                     "max_seq": MAX_SEQ},
        "tp_shards": {"params": np_params},
        "tp_engines": {"params": np_params, "axes": {"tp": 2},
                       "cases": {n: _port_case(c) for n, c in cases.items()}},
        "tp_engines_dp": {"params": np_params, "axes": {"tp": 2, "dp": 2},
                          "cases": {"default": _port_case(DEFAULT)}},
        "tp_faults": {"params": np_params, "timeout_s": FAULT_TIMEOUT_S,
                      # operation 1 is the prefill, 2 the first upload of
                      # the decode state: a follower that misses it runs
                      # one operation fewer and diverges at the collect
                      "skip_op": 2},
        "tp_app": {"prompt": "served on a tensor-parallel mesh", "n_new": 6},
    }
    box = {}

    def ranks():
        try:
            box["ranks"] = run_ranks(
                ["tp_steps", "tp_shards", "tp_engines", "tp_engines_dp",
                 "tp_app", "tp_faults"], 4, tmp_path_factory.mktemp("tp"), payload,
                deadline_s=240.0)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["error"] = exc

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        refs = {"steps": _jax_steps(jparams, inputs),
                "engines": {n: _jax_serve(jparams, c)
                            for n, c in cases.items()},
                "port_modern": _port_serve(np_params, MODERN),
                "plain_modern": _jax_serve(jparams, dict(
                    MODERN, config=dict(MODERN["config"],
                                        speculative=False)),
                    repaired=False),
                "jax_mesh": _jax_serve(
                    jparams, DEFAULT,
                    mesh=jcreate_mesh({"tp": 2}, jax.devices()[:2]))}
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], refs, cases


def _assert_requests(got, want, case):
    prompts = [p for wave in case["waves"] for p in wave]
    n_new = case["n_new"]
    n_new = n_new if isinstance(n_new, list) else [n_new] * len(prompts)
    assert got["errors"] == [None] * len(prompts), got["errors"]
    assert got["generated"] == want["generated"]
    for prompt, n, tokens, digest, jdigest in zip(
            prompts, n_new, got["generated"], got["digests"],
            want["digests"]):
        assert len(tokens) == n
        params = JSamplingParams(temperature=0.0, max_new_tokens=n)
        assert digest == jdigest == request_digest(prompt, params, tokens)


def test_tp_steps_match_jax_unsharded_steps(run):
    ranks, refs, _ = run
    for name, want in refs["steps"].items():
        for r in (0, 1):
            np.testing.assert_allclose(ranks[r]["tp_steps"][name], want,
                                       atol=STEP_TOL, rtol=0)
        # the logits come back whole and alike on every rank
        np.testing.assert_array_equal(ranks[0]["tp_steps"][name],
                                      ranks[1]["tp_steps"][name])
    assert ranks[0]["tp_steps"]["kv_heads"] == JTINY.n_kv_heads // 2
    assert ranks[2]["tp_steps"] is None          # outside the tp mesh


def test_sharded_params_actually_sharded(run):
    # counterpart of tests/test_sharded_serving.py's test of that name:
    # plain matrices [L, in, out], column-parallel wq split on out,
    # row-parallel wo on in; the vocabulary split in the embedding and
    # the head; the caches hold Hkv / 2 heads
    ranks, _, _ = run
    c, hd = JTINY, JTINY.head_dim
    for r in (0, 1):
        got = ranks[r]["tp_shards"]
        for layout in ("slot", "paged"):
            shapes = got[layout]
            assert shapes["wq"] == (c.n_layers, c.dim, c.n_heads * hd // 2)
            assert shapes["wo"] == (c.n_layers, c.n_heads * hd // 2, c.dim)
            assert shapes["embed"] == (c.vocab_size // 2, c.dim)
            assert shapes["lm_head"] == (c.dim, c.vocab_size // 2)
        assert got["slot"]["k_cache"] == (c.n_layers, 2, 64,
                                          c.n_kv_heads // 2, hd)
        # head-major pool [L, Hkv, Np, pg, hd]: 2 slots x 4 pages of 16
        assert got["paged"]["k_cache"] == (c.n_layers, c.n_kv_heads // 2,
                                           8, 16, hd)


def test_int8_sharded_params_actually_sharded(run):
    # the port stores quantized matrices output-major [L, out, in]:
    # JAX's [L, in, out/2] codes and [L, 1, out/2] scales transposed; int4
    # codes are packed two a byte along in, which wo's split cuts
    ranks, _, _ = run
    c = JTINY
    out_dim = c.n_heads * c.head_dim
    for r in (0, 1):
        got = ranks[r]["tp_shards"]
        assert got["int8"]["wq"] == ((c.n_layers, out_dim // 2, c.dim),
                                     (c.n_layers, out_dim // 2, 1))
        assert got["int8"]["wo"] == ((c.n_layers, c.dim, out_dim // 2),
                                     (c.n_layers, c.dim, 1))
        assert got["int4"]["wo"] == ((c.n_layers, c.dim, out_dim // 4),
                                     (c.n_layers, c.dim, 1))
        assert got["int4"]["w2"] == ((c.n_layers, c.dim, c.ffn_dim // 4),
                                     (c.n_layers, c.dim, 1))
        assert "packed two per byte" in got["int4_odd"]


@pytest.mark.parametrize("name", ["default", "walk", "int8", "modern"])
def test_tp2_engine_matches_jax_single_device(run, name):
    ranks, refs, cases = run
    got = ranks[0]["tp_engines"][name]
    _assert_requests(got, refs["engines"][name], cases[name])
    assert ranks[1]["tp_engines"][name]["follower_ops"] > 0
    if name == "modern":
        assert got["stats"]["prefix_hits"] >= 1, got["stats"]
        assert got["stats"]["spec_passes"] >= 1, got["stats"]
        jstats = refs["engines"][name]["stats"]
        assert jstats["prefix_hits"] >= 1 and jstats["spec_passes"] >= 1
        # greedy speculation reproduces plain greedy decoding: the
        # repaired reference's tokens are the unwrapped JAX engine's
        # without speculation
        assert refs["engines"][name]["generated"] == \
            refs["plain_modern"]["generated"]
        assert refs["plain_modern"]["stats"]["spec_passes"] == 0
    if name == "walk":
        assert got["prompts"][0] == cases["walk"]["waves"][0][0]
        assert got["stats"]["prefill_calls"] >= 5     # 40 tokens, 8 a chunk


def test_port_engine_roots_spec_trees_at_the_current_token(run):
    # the unsharded port engine on the modern config (a decode dispatch
    # in flight while the next pass drafts) gives JAX's greedy tokens
    _, refs, cases = run
    got = refs["port_modern"]
    _assert_requests(got, refs["engines"]["modern"], cases["modern"])
    assert got["stats"]["spec_passes"] >= 1, got["stats"]


def test_tp2_dp2_engine_matches_jax_single_device(run):
    ranks, refs, _ = run
    got = ranks[0]["tp_engines_dp"]["default"]
    _assert_requests(got, refs["engines"]["default"], DEFAULT)
    # the dp replica of the leader and both ranks of the other tp line
    # ran the same operations
    ops = [ranks[r]["tp_engines_dp"]["default"]["follower_ops"]
           for r in (1, 2, 3)]
    assert len(set(ops)) == 1 and ops[0] > 0


def test_tp2_engine_matches_jax_mesh_engine(run):
    ranks, refs, _ = run
    _assert_requests(ranks[0]["tp_engines"]["default"], refs["jax_mesh"],
                     DEFAULT)
    assert refs["jax_mesh"]["generated"] == \
        refs["engines"]["default"]["generated"]


@pytest.mark.parametrize("fault", ["skip", "drop_w2"])
def test_a_follower_out_of_step_is_caught(run, fault):
    ranks, _, _ = run
    leader, follower = ranks[0]["tp_faults"][fault], \
        ranks[1]["tp_faults"][fault]
    # the leader's request fails within the collectives' timeout (plus
    # the request's own passes), and the follower raised
    assert leader["error"] is not None, leader
    assert leader["seconds"] < 2 * FAULT_TIMEOUT_S + 10, leader
    assert follower["raised"] is not None, follower
    if fault == "skip":
        assert "diverged" in leader["error"], leader
        assert "diverged" in follower["raised"], follower


def test_app_serves_the_tp_engine_on_the_leader_rank(run):
    ranks, _, _ = run
    got, follower = ranks[0]["tp_app"], ranks[1]["tp_app"]
    assert got["status"] == 201
    assert got["tokens"] == got["want"] and len(got["want"]) == 6
    # the registry lists the leader rank's own device
    devices = got["health"]["checks"]["tpu"]["details"]["devices"]
    assert [d["process_index"] for d in devices] == [0]
    assert "serves no HTTP" in follower["refused"]
    assert follower["follower_ops"] > 0


@pytest.mark.parametrize("axis", ["pp", "sp"])
def test_serving_refuses_pipeline_and_sequence_axes(axis):
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.parallel.mesh import Mesh
    from gofr_tpu_torch.serving.glue import llama_engine
    mesh = Mesh(np.arange(2).reshape(1, 2), ("tp", axis), 0,
                torch.device("cpu"))
    with pytest.raises(ValueError, match=f"{axis} = 2 is not served"):
        llama_engine({}, LlamaConfig.tiny(), mesh=mesh)


def test_device_registry_lists_the_ranks_own_device():
    from gofr_tpu_torch.device import DeviceRegistry
    assert [d["process_index"] for d in DeviceRegistry(
        device="cpu", rank=3).devices()] == [3]
    assert [d["process_index"] for d in DeviceRegistry(
        device="cpu").devices()] == [0]
