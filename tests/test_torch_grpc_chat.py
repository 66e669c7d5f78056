"""The port's gRPC chat service (``gofr_tpu_torch/serving/grpc_chat.py``)
against the JAX package's (``gofr_tpu/serving/grpc_chat.py``) on the same
``LlamaConfig.tiny()`` weights (vocabulary 260, for the byte tokenizer),
both served over real channels: greedy ``Stream`` and ``Complete`` give
the same tokens, text and usage counts; the request surface (messages,
defaults, errors) answers alike; a refused admission is
``RESOURCE_EXHAUSTED`` on both; a cancelled stream retires its engine
request within 2 x ``decode_steps_per_pass`` tokens of the engine seeing
the flag (counted in passes, not wall-clock); a failure mid-generation
ends the stream with ``generation failed`` after the last token.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from contextlib import contextmanager
from dataclasses import replace

import jax
import numpy as np
import pytest
import grpc
import torch

from gofr_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from gofr_tpu.models.llama import llama_init as jax_llama_init
from gofr_tpu.serving.engine import EngineConfig as JaxEngineConfig
from gofr_tpu.serving.glue import llama_engine as jax_llama_engine
from gofr_tpu.serving.grpc_chat import make_chat_service as jax_chat_service
from gofr_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving.app import build_server
from gofr_tpu_torch.serving.engine import EngineConfig, GenRequest
from gofr_tpu_torch.serving.glue import llama_engine
from gofr_tpu_torch.serving.grpc_chat import make_chat_service
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

from .apputil import AppRunner

torch.set_num_threads(2)

ENGINE = dict(max_batch=2, max_seq=256, page_size=16, seed=0,
              prefix_cache=False)


@pytest.fixture(scope="module")
def weights():
    cfg = replace(JaxLlamaConfig.tiny(), vocab_size=260)
    jparams = jax_llama_init(jax.random.key(0), cfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              LlamaConfig.tiny().scaled(vocab_size=260),
                              "cpu")
    return cfg, jparams, tparams


@contextmanager
def port_chat(tparams, tenant_of=None, **engine_kw):
    """The port's app over a tiny engine with the chat service on a free
    gRPC port; yields (server, engine, port)."""
    engine = llama_engine(tparams, LlamaConfig.tiny().scaled(vocab_size=260),
                          EngineConfig(**{**ENGINE, **engine_kw}),
                          device="cpu")
    server = build_server(engine, ByteTokenizer(),
                          tenant_of=tenant_of or (lambda md: "anonymous"),
                          env={"GRPC_PORT": "0"})
    server.register_grpc_service(make_chat_service(engine, ByteTokenizer()))
    server.start_grpc()
    thread = threading.Thread(target=server.serve_forever, args=(0.05,),
                              daemon=True)
    engine.start()
    thread.start()
    try:
        yield server, engine, server.grpc_server.bound_port
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(10)


@pytest.fixture(scope="module")
def servers(weights):
    """(JAX port, JAX engine, port port, port engine): both apps, on the
    same weights, up for the module."""
    cfg, jparams, tparams = weights
    jeng = jax_llama_engine(
        jparams, cfg,
        JaxEngineConfig(kv_layout="paged", paged_attention="xla",
                        compile_cache_dir=None, **ENGINE),
        implementation="xla")

    def build(app):
        jeng.start()
        app.register_grpc_service(jax_chat_service(jeng, JaxByteTokenizer()))

    with AppRunner(build=build, config={"GRPC_PORT": "0"}) as r, \
            port_chat(tparams) as (_, peng, pport):
        try:
            yield r.app.grpc_server.bound_port, jeng, pport, peng
        finally:
            jeng.stop()


@contextmanager
def channel(port):
    chan = grpc.insecure_channel(
        f"127.0.0.1:{port}", options=(("grpc.use_local_subchannel_pool", 1),))
    try:
        grpc.channel_ready_future(chan).result(timeout=20)
        yield chan
    finally:
        chan.close()


def _method(chan, kind, name):
    return getattr(chan, kind)(
        f"/gofr.serving.Chat/{name}",
        request_serializer=lambda o: json.dumps(o).encode(),
        response_deserializer=json.loads)


def stream(port, body):
    with channel(port) as chan:
        return list(_method(chan, "unary_stream", "Stream")(body, timeout=60))


def complete(port, body):
    with channel(port) as chan:
        return _method(chan, "unary_unary", "Complete")(body, timeout=60)


def _code(fn, *args):
    with pytest.raises(grpc.RpcError) as err:
        fn(*args)
    return err.value.code(), err.value.details()


GREEDY = [{"prompt": "stream me", "max_tokens": 6, "temperature": 0.0},
          {"prompt": "a longer prompt, to the same greedy engine",
           "max_new_tokens": 9, "temperature": 0.0},
          {"messages": [{"role": "user", "content": "first"},
                        {"role": "user", "content": "second"}],
           "max_tokens": 4, "temperature": 0.0}]


@pytest.mark.parametrize("body", GREEDY, ids=["prompt", "alias", "messages"])
def test_stream_equals_jax(servers, body):
    jport, _, pport, _ = servers
    want, got = stream(jport, body), stream(pport, body)
    n = body.get("max_tokens", body.get("max_new_tokens"))
    assert [e for e in got if "token" in e] \
        == [e for e in want if "token" in e]
    assert len([e for e in got if "token" in e]) == n
    assert got[-1]["done"] is True and want[-1]["done"] is True
    usage, jusage = got[-1]["usage"], want[-1]["usage"]
    assert set(usage) == set(jusage) == {
        "prompt_tokens", "completion_tokens", "ttft_ms", "tpot_ms",
        "tenant", "duration_ms"}
    for key in ("prompt_tokens", "completion_tokens", "tenant"):
        assert usage[key] == jusage[key], key
    assert usage["completion_tokens"] == n
    assert usage["ttft_ms"] > 0 and usage["tpot_ms"] > 0


@pytest.mark.parametrize("body", GREEDY, ids=["prompt", "alias", "messages"])
def test_complete_equals_jax_and_its_stream(servers, body):
    jport, _, pport, _ = servers
    want, got = complete(jport, body), complete(pport, body)
    assert got["tokens"] == want["tokens"]
    assert got["text"] == want["text"]
    assert set(got["usage"]) == set(want["usage"]) == {
        "prompt_tokens", "completion_tokens", "ttft_ms", "tenant"}
    for key in ("prompt_tokens", "completion_tokens", "tenant"):
        assert got["usage"][key] == want["usage"][key], key
    assert got["tokens"] == [e["token"] for e in stream(pport, body)
                             if "token" in e]


def test_one_token_has_no_tpot(servers):
    jport, _, pport, _ = servers
    body = {"prompt": "one", "max_tokens": 1, "temperature": 0.0}
    assert stream(pport, body)[-1]["usage"]["tpot_ms"] is None
    assert stream(jport, body)[-1]["usage"]["tpot_ms"] is None


@pytest.mark.parametrize("body", [{}, {"prompt": ""}, {"prompt": 3},
                                  {"prompt": "x", "max_tokens": 0},
                                  {"prompt": "x", "max_tokens": 4097}],
                         ids=["empty", "blank", "not_str", "zero", "over"])
@pytest.mark.parametrize("rpc", ["Stream", "Complete"])
def test_bad_requests_answer_alike(servers, body, rpc):
    jport, _, pport, _ = servers
    call = stream if rpc == "Stream" else complete
    want, got = _code(call, jport, body), _code(call, pport, body)
    assert got == want
    assert got[0] == grpc.StatusCode.INTERNAL


def test_refused_admission_is_resource_exhausted(servers):
    """A stopped engine refuses at submit: ``RESOURCE_EXHAUSTED`` on both
    RPCs of both packages, with the engine's reason."""
    jport, jeng, pport, peng = servers
    body = {"prompt": "refused", "max_tokens": 3, "temperature": 0.0}
    jeng.stop()
    peng.stop()
    try:
        for port in (jport, pport):
            for call in (stream, complete):
                code, details = _code(call, port, body)
                assert code == grpc.StatusCode.RESOURCE_EXHAUSTED
                assert details
    finally:
        for eng in (jeng, peng):
            eng.waiting.reopen()
            eng.start()
    assert complete(pport, body)["usage"]["completion_tokens"] == 3


def test_tenant_from_metadata_and_traceparent(weights):
    """The port's tenant is its ``tenant_of`` over the metadata; the
    ``traceparent`` metadata parents the engine's request."""
    _, _, tparams = weights
    seen = []
    with port_chat(tparams, tenant_of=lambda md: md.get("x-tenant")) \
            as (server, engine, port), channel(port) as chan:
        original = engine.submit

        def spy(*args, **kw):
            seen.append(kw)
            return original(*args, **kw)
        engine.submit = spy
        parent = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        reply = _method(chan, "unary_unary", "Complete")(
            {"prompt": "hi", "max_tokens": 2, "temperature": 0.0},
            metadata=(("x-tenant", "acme"), ("traceparent", parent)),
            timeout=60)
    assert reply["usage"]["tenant"] == "acme"
    assert seen[0]["tenant"] == "acme"
    assert seen[0]["traceparent"] == parent


def test_cancelled_stream_retires_its_request(weights):
    """A client that walks away mid-stream: the engine sees the flag, and
    the request retires within 2 x K tokens of that moment."""
    _, _, tparams = weights
    with port_chat(tparams, max_seq=4096, page_size=64,
                   decode_steps_per_pass=4) as (_, engine, port), \
            channel(port) as chan:
        call = _method(chan, "unary_stream", "Stream")(
            {"prompt": "abandon me", "max_tokens": 4096, "temperature": 0.0},
            timeout=120)
        got = 0
        for event in call:
            got += "token" in event
            if got >= 2:
                break
        abandoned = next(r for r in engine.active if r is not None)
        call.cancel()
        deadline = time.time() + 60
        while time.time() < deadline and not abandoned.cancelled:
            time.sleep(0.001)
        assert abandoned.cancelled
        n_at_flag = len(abandoned.generated)
        while time.time() < deadline and abandoned.finished_at is None:
            time.sleep(0.01)
        assert abandoned.finished_at is not None
        K = engine.config.decode_steps_per_pass
        assert len(abandoned.generated) <= n_at_flag + 2 * K, (
            len(abandoned.generated), n_at_flag)
        assert len(abandoned.generated) < 4096 - 16


class _FailingEngine:
    """An engine whose request emits ``tokens`` and then fails."""

    def __init__(self, tokens, error=None, refuse=None):
        self.tokens, self.error, self.refuse = tokens, error, refuse
        self.cancelled = []

    def submit(self, prompt_tokens, params, *, traceparent=None,
               tenant=None):
        req = GenRequest(prompt_tokens=list(prompt_tokens), params=params)
        if self.refuse:
            req.error = self.refuse
            return req
        for t in self.tokens:
            req.out_queue.put(t)

        def fail():
            # after the submit returned: the tokens were emitted first
            req.error = self.error
            req.finished_at = time.time()
            req.out_queue.put(None)
        threading.Timer(0.05, fail).start()
        return req

    def stream_request(self, req, timeout_s=None):
        while True:
            try:
                token = req.out_queue.get(timeout=timeout_s)
            except queue.Empty:
                yield None
                continue
            if token is None:
                return
            yield token

    def cancel(self, req):
        self.cancelled.append(req)


@contextmanager
def _stub_server(engine):
    from gofr_tpu_torch.serving.app import ChatServer
    server = ChatServer(("127.0.0.1", 0), None)
    server.env = {"GRPC_PORT": "0"}
    server.register_grpc_service(make_chat_service(engine, ByteTokenizer()))
    server.start_grpc()
    try:
        yield server.grpc_server.bound_port
    finally:
        server.server_close()


def test_failure_mid_generation_ends_after_the_last_token():
    with _stub_server(_FailingEngine([65, 66], error="kv lost")) as port, \
            channel(port) as chan:
        call = _method(chan, "unary_stream", "Stream")(
            {"prompt": "x", "max_tokens": 8}, timeout=30)
        events = []
        with pytest.raises(grpc.RpcError) as err:
            for event in call:
                events.append(event)
        assert [e["token"] for e in events] == [65, 66]
        assert err.value.code() == grpc.StatusCode.INTERNAL
        assert err.value.details() == "generation failed: kv lost"
        code, details = _code(complete, port, {"prompt": "x"})
        assert (code, details) == (grpc.StatusCode.INTERNAL,
                                   "generation failed: kv lost")


def test_refusal_never_reaches_the_stream():
    engine = _FailingEngine([], refuse="queue full")
    with _stub_server(engine) as port:
        assert _code(stream, port, {"prompt": "x"}) == (
            grpc.StatusCode.RESOURCE_EXHAUSTED, "queue full")
        assert engine.cancelled == []
