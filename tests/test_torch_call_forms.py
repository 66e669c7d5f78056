"""JAX's call forms on the port: calls written for the JAX package, by
keyword and with JAX's parameter names, run against the port's
counterparts and give JAX's results. ``llama_engine`` / ``moe_engine``
take ``metrics=``, ``logger=`` and ``tracer=``; ``Histogram.get_sum``;
``RPCContext.path_param``; the ``Tokenizer`` protocol;
``install_openai_routes(app=)``, ``FleetRouter.install(app=)``,
``ControlPlaneLeader.install(app=)``, ``Checkpointer.save(pytree=)`` and
``dequantize_rows(q=, s=)``; ``make_empty_cache`` on the card unless the
CPU is asked for. (``warm_start(app, ...)`` is in
``tests/test_torch_checkpoint.py``, the breaker's probe in
``tests/test_torch_service_client.py``.)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.grpc.server import GRPCRequest
from gofr_tpu.metrics.registry import Histogram as JaxHistogram
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.ops import paged_kv as jax_paged_kv
from gofr_tpu.serving import tokenizer as jax_tokenizer
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import DictConfig
from gofr_tpu_torch.grpc.server import RPCContext
from gofr_tpu_torch.logging import new_logger
from gofr_tpu_torch.metrics import Histogram, Manager
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init, \
    make_empty_cache
from gofr_tpu_torch.models.moe import MoEConfig, moe_init
from gofr_tpu_torch.ops import paged_kv
from gofr_tpu_torch.serving import tokenizer
from gofr_tpu_torch.serving.engine import EngineConfig, SamplingParams
from gofr_tpu_torch.serving.glue import llama_engine, moe_engine
from gofr_tpu_torch.tracing.tracer import Tracer

torch.set_num_threads(2)

ENGINE = dict(max_batch=2, max_seq=64, page_size=16, prefill_buckets=(16,),
              seed=0, prefix_cache=False)


def _app() -> App:
    return App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))


# ------------------------------------------------- C25: the engines' wiring
@pytest.mark.parametrize("family", ["llama", "moe"])
def test_engines_take_metrics_logger_and_tracer_by_keyword(family):
    """JAX's ``llama_engine(params, cfg, econf, metrics=, logger=,
    tracer=)`` (and ``moe_engine``'s): the planes are set on the engine,
    its series are registered on the given manager and a request's
    latency lands there; ``serve_model`` then adopts them."""
    metrics, logger, tracer = Manager(), new_logger(), Tracer("test")
    gen = torch.Generator().manual_seed(0)
    if family == "llama":
        cfg = LlamaConfig.tiny()
        engine = llama_engine(llama_init(cfg, gen, "cpu"), cfg,
                              EngineConfig(**ENGINE), device="cpu",
                              metrics=metrics, logger=logger, tracer=tracer)
    else:
        cfg = MoEConfig.tiny()
        engine = moe_engine(moe_init(cfg, gen, "cpu"), cfg,
                            EngineConfig(kv_layout="slot", **ENGINE),
                            device="cpu", metrics=metrics, logger=logger,
                            tracer=tracer)
    assert (engine.metrics, engine.logger, engine.tracer) == (
        metrics, logger, tracer)
    assert metrics.get("app_engine_active_slots") is not None
    engine.start()
    try:
        req = engine.submit_sync([1, 2, 3], SamplingParams(
            temperature=0.0, max_new_tokens=3), 120)
    finally:
        engine.stop()
    assert req.error is None and len(req.generated) == 3
    e2e = metrics.get("app_chat_e2e_seconds")
    assert e2e.get_count() == 1 and e2e.get_sum() > 0
    app = _app()
    app.serve_model(family, engine)
    # the logger and tracer given stay; the manager is the app's now
    assert (engine.logger, engine.tracer) == (logger, tracer)
    assert engine.metrics is app.container.metrics


# ------------------------------------------------ C26: Histogram.get_sum
def test_histogram_get_sum_equals_jax():
    rng = np.random.default_rng(0)
    jax_h = JaxHistogram("h", "latency")
    port_h = Histogram("h", "latency")
    for value, route in zip(rng.exponential(0.3, 40),
                            rng.choice(["/a", "/b"], 40)):
        jax_h.record(float(value), {"route": str(route)})
        port_h.record(float(value), {"route": str(route)})
    for labels in ({"route": "/a"}, {"route": "/b"}, {"route": "/c"}, {}):
        assert port_h.get_sum(**labels) == jax_h.get_sum(**labels)
        assert port_h.get_count(**labels) == jax_h.get_count(**labels)
    assert port_h.get_sum(route="/a") > 0


# -------------------------------------------- C27: RPCContext.path_param
def test_rpc_context_path_param_is_empty_as_jax():
    metadata = {"x-id": "7", ":authority": "host:9000", "id": "9"}
    jax_req = GRPCRequest({"a": 1}, metadata, "/svc/M")
    port_ctx = RPCContext({"a": 1}, metadata, "/svc/M", container=None,
                          grpc_context=None)
    for key in ("id", "x-id", "missing"):
        assert port_ctx.path_param(key) == jax_req.path_param(key) == ""
        assert port_ctx.param(key) == jax_req.param(key)


# ---------------------------------------------- C28: the Tokenizer protocol
def test_tokenizer_protocol_is_jaxs_and_the_tokenizers_meet_it():
    port, jax = tokenizer.Tokenizer, jax_tokenizer.Tokenizer
    assert port._is_protocol and jax._is_protocol
    assert port.__annotations__.keys() == jax.__annotations__.keys()
    assert {n for n in vars(port) if not n.startswith("_")} \
        == {n for n in vars(jax) if not n.startswith("_")}
    for tok in (tokenizer.ByteTokenizer(), tokenizer.BPETokenizer(
            {bytes([b]): b for b in range(256)}, {})):
        for name in [*port.__annotations__, "encode", "decode"]:
            assert hasattr(tok, name), (type(tok).__name__, name)


# ------------------------------------------- C29: JAX's parameter names
def test_install_calls_take_app_by_keyword():
    """``install_openai_routes(app=)``, ``FleetRouter.install(app=)`` and
    ``ControlPlaneLeader.install(app=)`` register their routes on the
    port's ``App``."""
    from gofr_tpu_torch.serving.control_plane import ControlPlaneLeader
    from gofr_tpu_torch.serving.glue import demo_llama_engine
    from gofr_tpu_torch.serving.openai_compat import install_openai_routes
    from gofr_tpu_torch.serving.router import FleetRouter

    def routes(app):
        return {(r.method, r.pattern) for r in app.router.routes}

    app = _app()
    engine = demo_llama_engine(device="cpu")
    install_openai_routes(app=app, engine=engine,
                          tokenizer=tokenizer.ByteTokenizer(), model="m")
    assert {("POST", "/v1/chat/completions"), ("POST", "/v1/completions"),
            ("GET", "/v1/models")} <= routes(app)

    leader_app, leader = _app(), ControlPlaneLeader()
    leader.install(app=leader_app)
    try:
        assert ("POST", "/control/join") in routes(leader_app)
        assert leader_app.health_checks["control_plane"] is leader
        FleetRouter(leader).install(app=leader_app)
        assert ("POST", "/chat") in routes(leader_app)
    finally:
        leader.stop()


def test_checkpointer_save_takes_pytree_by_keyword(tmp_path):
    from gofr_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from gofr_tpu_torch.checkpoint import Checkpointer

    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.ones(2, np.int32)]}
    JaxCheckpointer(tmp_path / "jax").save(step=1, pytree=tree)
    Checkpointer(tmp_path / "port").save(step=1, pytree=tree)
    jax_back = JaxCheckpointer(tmp_path / "port").restore(1)
    port_back = Checkpointer(tmp_path / "jax").restore(1)
    assert jax_back.keys() == port_back.keys()
    for key, value in jax_back.items():
        np.testing.assert_array_equal(np.asarray(value),
                                      port_back[key].numpy())


def test_dequantize_rows_takes_q_and_s_by_keyword():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3, 4, 16)).astype(np.float32)
    q, s = paged_kv.quantize_rows(torch.from_numpy(rows))
    want = jax_paged_kv.dequantize_rows(q=jnp.asarray(q.numpy()),
                                        s=jnp.asarray(s.numpy()))
    got = paged_kv.dequantize_rows(q=q, s=s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------ C31: make_empty_cache on the card
def test_make_empty_cache_runs_on_the_card_unless_asked(monkeypatch):
    cfg = LlamaConfig.tiny()
    k, v = make_empty_cache(cfg, 2, 32, device="cpu")
    jk, jv = jax_llama.make_empty_cache(jax_llama.LlamaConfig.tiny(), 2,
                                        max_seq=32)
    assert k.shape == v.shape == tuple(jk.shape) == tuple(jv.shape)
    assert not k.any() and not v.any() and k.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_empty_cache(cfg, 2, 32)          # default device: cuda
