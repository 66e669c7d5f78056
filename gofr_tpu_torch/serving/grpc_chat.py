"""gRPC chat service (the port's counterpart of
``gofr_tpu/serving/grpc_chat.py``): the gRPC twin of ``POST /chat``, fed
by the same continuous-batching engine, JSON codec.

RPCs of service ``gofr.serving.Chat``:

- ``Stream`` (server-streaming): one ``{"token", "text"}`` message per
  token, then ``{"done": true, "usage": {"prompt_tokens",
  "completion_tokens", "ttft_ms" (2 places), "tpot_ms" (3 places, null
  unless more than one token), "tenant", "duration_ms"}}``;
- ``Complete`` (unary): ``{"text", "tokens", "usage": {"prompt_tokens",
  "completion_tokens", "ttft_ms", "tenant"}}``.

A request takes ``prompt`` (or ``messages``, whose contents are joined
by newlines), ``temperature`` (0.7), ``top_p`` (1.0), ``top_k`` (0) and
``max_tokens`` / ``max_new_tokens`` (128, 1..4096; outside it a
``ValueError``, which the server answers ``INTERNAL``, as JAX's does). A
refused admission answers ``RESOURCE_EXHAUSTED``; a failure
mid-generation raises ``generation failed: ...`` after the last token,
so a truncated stream never reads as a complete one.

The handlers are plain functions and generators on the server's thread
pool (the JAX package's are coroutines on ``grpc.aio``). A client that
cancels cancels the engine request: grpc's termination callback sets the
flag at once, and the handler, which checks ``is_active()`` while it
waits for tokens, stops. The tenant is the host's ``tenant_of`` applied
to the invocation metadata; the ``traceparent`` metadata reaches
``engine.submit``.
"""

from __future__ import annotations

import time
from contextlib import closing
from typing import Any, Iterator

import grpc

from ..grpc.service import GRPCService, rpc, server_stream_rpc
from .engine import Engine, GenRequest, SamplingParams
from .handlers import POLL_S


def _params_from(req: dict) -> tuple[str, SamplingParams]:
    prompt = req.get("prompt")
    if not prompt and isinstance(req.get("messages"), list):
        prompt = "\n".join(str(m.get("content", ""))
                           for m in req["messages"])
    if not prompt or not isinstance(prompt, str):
        raise ValueError("prompt required")
    max_new = int(req.get("max_tokens", req.get("max_new_tokens", 128)))
    if not 1 <= max_new <= 4096:
        raise ValueError("max_tokens out of range")
    return prompt, SamplingParams(
        temperature=float(req.get("temperature", 0.7)),
        top_p=float(req.get("top_p", 1.0)),
        top_k=int(req.get("top_k", 0)),
        max_new_tokens=max_new)


def _refused(req: GenRequest) -> RuntimeError:
    """A refused admission: ``RESOURCE_EXHAUSTED``, not ``INTERNAL``."""
    exc = RuntimeError(req.error)
    exc.grpc_status = grpc.StatusCode.RESOURCE_EXHAUSTED
    return exc


def make_chat_service(engine: Engine, tokenizer: Any) -> GRPCService:
    """The service instance for ``ChatServer.register_grpc_service``."""

    def submit(ctx, request) -> tuple[GenRequest, list[int], str | None]:
        prompt, params = _params_from(request or {})
        prompt_tokens = tokenizer.encode(prompt)
        tenant = ctx.tenant
        # the RPC's span is active on this thread, so the engine takes
        # its parent from there; the raw metadata is the fallback
        req = engine.submit(prompt_tokens, params,
                            traceparent=ctx.header("traceparent") or None,
                            tenant=tenant)
        if req.error:
            raise _refused(req)
        # the RPC's end, for any reason: a request still running is
        # abandoned (its client cancelled or the deadline passed)
        ctx.grpc_context.add_callback(
            lambda: req.finished_at is None and engine.cancel(req))
        return req, prompt_tokens, tenant

    def tokens_of(ctx, req: GenRequest) -> Iterator[int]:
        """``req``'s tokens as the engine emits them, until the request
        ends or the RPC does (closing the stream cancels the request)."""
        with closing(engine.stream_request(req, timeout_s=POLL_S)) as stream:
            for token in stream:
                if not ctx.grpc_context.is_active():
                    return
                if token is not None:
                    yield token

    class ChatService(GRPCService):
        name = "gofr.serving.Chat"

        @server_stream_rpc
        def Stream(self, ctx, request) -> Iterator[dict]:
            start = time.perf_counter()
            req, prompt_tokens, tenant = submit(ctx, request)
            n = 0
            for token in tokens_of(ctx, req):
                n += 1
                yield {"token": token, "text": tokenizer.decode([token])}
            if req.error:
                raise RuntimeError(f"generation failed: {req.error}")
            tpot_ms = None
            if (req.first_token_at is not None
                    and req.finished_at is not None and n > 1):
                tpot_ms = round((req.finished_at - req.first_token_at)
                                * 1000.0 / (n - 1), 3)
            yield {"done": True,
                   "usage": {"prompt_tokens": len(prompt_tokens),
                             "completion_tokens": n,
                             "ttft_ms": round(req.ttft_ms, 2)
                             if req.ttft_ms else None,
                             "tpot_ms": tpot_ms,
                             "tenant": tenant,
                             "duration_ms": round(
                                 (time.perf_counter() - start) * 1e3, 2)}}

        @rpc
        def Complete(self, ctx, request) -> dict:
            req, prompt_tokens, tenant = submit(ctx, request)
            tokens = list(tokens_of(ctx, req))
            if req.error:
                raise RuntimeError(f"generation failed: {req.error}")
            return {"text": tokenizer.decode(tokens), "tokens": tokens,
                    "usage": {"prompt_tokens": len(prompt_tokens),
                              "completion_tokens": len(tokens),
                              "ttft_ms": round(req.ttft_ms, 2)
                              if req.ttft_ms else None,
                              "tenant": tenant}}

    return ChatService()
