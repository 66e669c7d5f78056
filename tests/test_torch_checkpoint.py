"""The port's checkpoint/resume (``gofr_tpu_torch/checkpoint.py``) against
the JAX package's (``gofr_tpu/checkpoint.py``): one on-disk format, so a
checkpoint written by either package restores in the other, flat and
with ``like=``, every leaf bit-equal (bf16 included); the leaf order and
keys are JAX's; atomic publish, GC, a repeated step, no checkpoint;
quantized trees round-trip within the port; the port's ``restore_engine``
serves the in-memory engine's tokens (from its own checkpoint and from
one the JAX package wrote), and the JAX package's hook, which hands its
engine the flat dict, fails the first request with ``'embed'``; JAX's
call ``warm_start(app, name, directory, build_engine)`` runs against the
port's ``App`` as an on-start hook and serves the in-memory engine's
tokens, and with no checkpoint the app's start fails naming the model.
"""

from __future__ import annotations

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.checkpoint import Checkpointer as JaxCheckpointer
from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu_torch.checkpoint import (ARRAYS, MANIFEST, CheckpointError,
                                       Checkpointer, flatten, nest,
                                       restore_engine, warm_start)
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.ops.quant import quantize_llama_int4, quantize_llama_int8
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine

torch.set_num_threads(2)

ENGINE = dict(max_batch=2, max_seq=64, page_size=16, prefill_buckets=(16,),
              seed=0, prefix_cache=False)
GREEDY = dict(temperature=0.0, max_new_tokens=5)
PROMPT = [1, 2, 3, 4, 5, 6, 7]


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as an array (bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16).view(np.int16) if a.dtype.name == "bfloat16" \
        else a


def _jax_tree():
    """A JAX tree of every leaf kind a checkpoint holds: bf16, float32,
    int32, a list, a nested dict, keys out of sorted order."""
    rng = np.random.default_rng(0)
    return {
        "zeta": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
        "alpha": {"w": jnp.asarray(rng.standard_normal((4,)), jnp.float32),
                  "b": jnp.arange(6, dtype=jnp.int32).reshape(2, 3)},
        "layers": [jnp.asarray(rng.standard_normal((2, 2)), jnp.bfloat16),
                   jnp.asarray([7], jnp.int8)],
    }


def _port_of(tree):
    """The same tree as torch tensors (bf16 through its bits)."""
    if isinstance(tree, dict):
        return {k: _port_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_of(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_flatten_order_and_keys_are_jaxs():
    tree = _jax_tree()
    want = [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = flatten(_port_of(tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(_bits(a), _bits(b))
    # nest inverts the flat keystr dict, lists included
    back = nest(dict(got))
    assert list(back) == sorted(tree) and isinstance(back["layers"], list)
    assert [k for k, _ in flatten(back)] == [k for k, _ in got]


def test_jax_written_restores_in_the_port(tmp_path):
    tree = _jax_tree()
    JaxCheckpointer(tmp_path).save(3, tree, metadata={"by": "jax"})
    port = Checkpointer(tmp_path)
    flat = port.restore()
    want = {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert list(flat) == list(want)
    for key, leaf in want.items():
        assert np.array_equal(_bits(flat[key]), _bits(leaf)), key
    assert flat["['zeta']"].dtype == torch.bfloat16
    like = port.restore(like=_port_of(tree))
    assert list(like) == list(tree) and isinstance(like["layers"], list)
    for (_, a), (_, b) in zip(flatten(like), want.items()):
        assert np.array_equal(_bits(a), _bits(b))
    assert port.restore_metadata() == {"by": "jax"}


def test_port_written_restores_in_jax(tmp_path):
    tree = _jax_tree()
    Checkpointer(tmp_path).save(4, _port_of(tree), metadata={"by": "port"})
    jck = JaxCheckpointer(tmp_path)
    flat = jck.restore()
    want = {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert list(flat) == list(want)
    for key, leaf in want.items():
        assert flat[key].dtype == leaf.dtype, key
        assert np.array_equal(_bits(flat[key]), _bits(leaf)), key
    like = jck.restore(like=tree)
    for a, b in zip(jax.tree.leaves(like), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    assert jck.restore_metadata() == {"by": "port"}
    # the manifest's leaves hold what JAX's save writes
    manifest = json.loads((tmp_path / "step_4" / MANIFEST).read_text())
    assert [e["dtype"] for e in manifest["leaves"]] == [
        "int32", "float32", "bfloat16", "int8", "bfloat16"]
    with np.load(tmp_path / "step_4" / ARRAYS) as data:
        assert data["leaf_4"].dtype == np.uint16      # bf16 as its bits


def test_llama_trees_both_ways_bit_equal(tmp_path):
    cfg = JaxLlamaConfig.tiny()
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                           jax_llama_init(jax.random.key(3), cfg))
    JaxCheckpointer(tmp_path / "jax").save(1, jparams)
    restored = nest(Checkpointer(tmp_path / "jax").restore())
    Checkpointer(tmp_path / "port").save(1, restored)
    back = JaxCheckpointer(tmp_path / "port").restore(like=jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("form", ["int8", "int4"])
def test_quantized_trees_round_trip_in_the_port(tmp_path, form):
    cfg = LlamaConfig.tiny()
    params = llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
    quantized = (quantize_llama_int8 if form == "int8"
                 else quantize_llama_int4)(params)
    ck = Checkpointer(tmp_path)
    ck.save(1, quantized)
    back = ck.restore(like=quantized)
    got, want = flatten(back), flatten(quantized)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert torch.equal(nest(ck.restore())["layers"]["wq"]["q"],
                       quantized["layers"]["wq"]["q"])


class TestVersioning:
    def test_latest_explicit_and_keep(self, tmp_path):
        ck = Checkpointer(tmp_path, keep=2)
        for step in (10, 20, 30):
            ck.save(step, {"v": torch.tensor([step])})
        assert ck.steps() == [20, 30] and ck.latest_step() == 30
        assert int(ck.restore(step=20)["['v']"][0]) == 20
        assert int(ck.restore()["['v']"][0]) == 30
        assert JaxCheckpointer(tmp_path, keep=2).steps() == [20, 30]

    def test_repeated_step_and_no_checkpoint_raise(self, tmp_path):
        with pytest.raises(CheckpointError, match="no checkpoints"):
            Checkpointer(tmp_path).restore()
        with pytest.raises(CheckpointError, match="no checkpoints"):
            Checkpointer(tmp_path).restore_metadata()
        ck = Checkpointer(tmp_path)
        ck.save(1, {"v": torch.ones(1)})
        with pytest.raises(CheckpointError, match="already saved"):
            ck.save(1, {"v": torch.ones(1)})
        with pytest.raises(CheckpointError, match="missing checkpoint"):
            ck.restore(step=2)

    def test_half_written_saves_are_invisible(self, tmp_path):
        ck = Checkpointer(tmp_path)
        ck.save(1, {"v": torch.ones(1)})
        (tmp_path / ".tmp_save_dead").mkdir()
        (tmp_path / "step_9").mkdir()          # no manifest: unfinished
        assert ck.steps() == [1] == JaxCheckpointer(tmp_path).steps()

    def test_a_failed_save_publishes_nothing(self, tmp_path, monkeypatch):
        ck = Checkpointer(tmp_path)

        def broken(*args, **kw):
            raise OSError("disk full")
        monkeypatch.setattr(np, "savez", broken)
        with pytest.raises(OSError, match="disk full"):
            ck.save(5, {"v": torch.ones(1)})
        assert ck.steps() == [] and list(tmp_path.iterdir()) == []

    def test_structure_mismatch_raises(self, tmp_path):
        ck = Checkpointer(tmp_path)
        ck.save(1, {"a": torch.ones(2)})
        with pytest.raises(CheckpointError, match="structure mismatch"):
            ck.restore(like={"a": torch.ones(2), "b": torch.ones(2)})

    def test_restore_places_on_the_device(self, tmp_path):
        ck = Checkpointer(tmp_path)
        ck.save(1, {"a": torch.ones(2, dtype=torch.bfloat16)})
        leaf = ck.restore(device="meta")["['a']"]
        assert leaf.device.type == "meta" and leaf.dtype == torch.bfloat16


# ------------------------------------------------------------- warm start
def _tokens_in_memory(params, cfg) -> list:
    eng = llama_engine(params, cfg, EngineConfig(**ENGINE), device="cpu")
    eng.start()
    try:
        req = eng.submit_sync(PROMPT, SamplingParams(**GREEDY), 120)
    finally:
        eng.stop()
    assert req.error is None
    return list(req.generated)


def _chat(server) -> dict:
    body = json.dumps({"prompt": "warm", "max_tokens": 5,
                       "temperature": 0}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/chat", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["data"]


def test_warm_start_serves_the_in_memory_engines_tokens(tmp_path):
    import threading
    cfg = LlamaConfig.tiny().scaled(vocab_size=260)
    params = llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
    Checkpointer(tmp_path).save(1, {"stale": torch.zeros(1)})
    Checkpointer(tmp_path).save(2, params)        # the latest is served
    built = []

    def build(tree):
        built.append(tree)
        return llama_engine(tree, cfg, EngineConfig(**ENGINE), device="cpu")

    engine = restore_engine("llama", tmp_path, build, device="cpu")
    try:
        assert engine._running
        assert set(built[0]) == {"embed", "layers", "final_norm", "lm_head"}
        req = engine.submit_sync(PROMPT, SamplingParams(**GREEDY), 120)
        server = build_server(engine, port=0)
        thread = threading.Thread(target=server.serve_forever,
                                  args=(0.05,), daemon=True)
        thread.start()
        try:
            served = _chat(server)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(10)
    finally:
        engine.stop()
    assert list(req.generated) == _tokens_in_memory(params, cfg)
    twin = llama_engine(params, cfg, EngineConfig(**ENGINE), device="cpu")
    twin.start()
    try:
        want = twin.submit_sync([257] + list(b"warm"),
                                SamplingParams(**GREEDY), 120)
    finally:
        twin.stop()
    assert served["tokens"] == list(want.generated)


def test_warm_start_without_a_checkpoint_names_the_model(tmp_path):
    with pytest.raises(CheckpointError, match="'llama'.*no checkpoint"):
        restore_engine("llama", tmp_path, lambda p: None, device="cpu")


def test_port_warm_starts_from_jax_and_jax_hook_fails_on_embed(tmp_path):
    """One JAX-written checkpoint: the port's ``restore_engine`` serves the
    JAX engine's greedy tokens (the engine built with ``like=``); the JAX
    package's own hook hands ``build_engine`` the flat dict, and that
    engine's first request fails with ``'embed'``, generating nothing."""
    from gofr_tpu.app import App
    from gofr_tpu.checkpoint import warm_start as jax_warm_start
    from gofr_tpu.config.env import DictConfig
    from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
    from gofr_tpu.serving.engine import SamplingParams as JaxSamplingParams
    from gofr_tpu.serving.glue import llama_engine as jax_llama_engine

    from .apputil import AppRunner

    jcfg = JaxLlamaConfig.tiny()
    jparams = jax_llama_init(jax.random.key(3), jcfg)
    JaxCheckpointer(tmp_path).save(7, jparams)

    def jax_engine(params):
        # the hook's failing request burns the SLO budget, which would arm
        # JAX's autoprofiler: a capture that outlives this test refuses
        # every later jax.profiler start in the process
        return jax_llama_engine(
            params, jcfg,
            JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                            compile_cache_dir=None, autoprof=False,
                            **ENGINE),
            implementation="xla")

    good = jax_engine(JaxCheckpointer(tmp_path).restore(like=jparams))
    good.start()
    try:
        want = good.submit_sync(PROMPT, JaxSamplingParams(**GREEDY))
    finally:
        good.stop()
    assert want.error is None and len(want.generated) == 5

    cfg = LlamaConfig.tiny()
    engine = restore_engine(
        "llama", tmp_path,
        lambda p: llama_engine(p, cfg, EngineConfig(**ENGINE), device="cpu"),
        device="cpu")
    try:
        got = engine.submit_sync(PROMPT, SamplingParams(**GREEDY), 120)
    finally:
        engine.stop()
    assert list(got.generated) == list(want.generated)
    # the same weights through params_from_jax serve the same tokens
    assert _tokens_in_memory(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"), cfg) \
        == list(want.generated)

    built = {}

    def build(params):
        built["keys"] = sorted(params)
        built["engine"] = jax_engine(params)
        return built["engine"]

    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
    jax_warm_start(app, "llama", tmp_path, build)
    with AppRunner(app=app):
        bad = built["engine"].submit_sync(PROMPT, JaxSamplingParams(**GREEDY))
    assert built["keys"][0] == "['embed']"        # the flat keystr dict
    assert bad.error == "'embed'" and bad.generated == []


def _app_chat(runner) -> dict:
    status, _, data = runner.request(
        "POST", "/chat", {"prompt": "warm", "max_tokens": 5,
                          "temperature": 0})
    assert status == 201, data             # a POST answers 201, as in JAX
    return json.loads(data)["data"]


def test_jax_warm_start_call_serves_through_the_ports_app(tmp_path):
    """JAX's text, ``warm_start(app, name, directory, build_engine)``
    with ``build`` calling ``llama_engine(..., metrics=, logger=,
    tracer=)`` on the app's planes, run against the port's ``App`` (the
    CPU asked for): the on-start hook restores the latest step, builds
    the engine from the nested tree, serves it as ``/chat`` and starts
    it; its greedy tokens are an in-memory engine's on the same tree."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig

    from .torch_apputil import AppRunner

    cfg = LlamaConfig.tiny().scaled(vocab_size=260)
    params = llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
    Checkpointer(tmp_path).save(1, {"stale": torch.zeros(1)})
    Checkpointer(tmp_path).save(2, params)
    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
    built = []

    def build(params):
        built.append(llama_engine(
            params, cfg, EngineConfig(**ENGINE), device="cpu",
            metrics=app.container.metrics, logger=app.logger,
            tracer=app.container.tracer))
        return built[-1]

    assert warm_start(app, "llama", tmp_path, build, device="cpu") is None
    assert built == []                     # nothing runs before start
    with AppRunner(app=app) as runner:
        engine = built[0]
        assert engine._running and app.container.models["llama"] is engine
        assert engine.metrics is app.container.metrics
        served = _app_chat(runner)
    twin = llama_engine(params, cfg, EngineConfig(**ENGINE), device="cpu")
    twin.start()
    try:
        want = twin.submit_sync([257] + list(b"warm"),
                                SamplingParams(**GREEDY), 120)
    finally:
        twin.stop()
    assert served["tokens"] == list(want.generated)
    assert not engine._running             # stopped with the app


def test_jax_warm_start_without_a_checkpoint_fails_the_apps_start(tmp_path):
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig

    from .torch_apputil import AppRunner

    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
    warm_start(app, "llama", tmp_path, lambda p: pytest.fail("built"),
               device="cpu")
    with pytest.raises(RuntimeError, match="on_start hook failed") as info:
        with AppRunner(app=app):
            pytest.fail("the app started")
    assert isinstance(info.value.__cause__, CheckpointError)
    assert "'llama'" in str(info.value.__cause__)
    assert app.http_server is None
