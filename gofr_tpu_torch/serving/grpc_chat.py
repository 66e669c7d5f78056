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

The handlers are coroutines on the server's ``grpc.aio`` loop, as JAX's
are: an RPC waiting for tokens holds no thread of its own. The submit
(tokenizing included) runs on the server's pool, and the engine's
per-token iterator (``engine.stream_request``) is read there by
``handler.ThreadPump``. A client that cancels, or a deadline that
passes, cancels the engine request: the RPC's done callback sets the
flag at once, and the pump, which looks at the RPC between tokens,
stops and closes the iterator. The tenant is the host's ``tenant_of``
applied to the invocation metadata; the ``traceparent`` metadata
reaches ``engine.submit``.
"""

from __future__ import annotations

import asyncio
import contextvars
import threading
import time
from typing import Any, AsyncIterator

import grpc

from ..grpc.service import GRPCService, rpc, server_stream_rpc
from ..handler import ThreadPump
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

    async def submit(ctx, request) -> tuple[GenRequest, list[int],
                                            str | None]:
        prompt, params = _params_from(request or {})

        def on_pool() -> tuple[GenRequest, list[int], str | None]:
            prompt_tokens = tokenizer.encode(prompt)
            tenant = ctx.tenant
            # the RPC's span is active in this context, so the engine
            # takes its parent from there; the raw metadata is the
            # fallback
            return engine.submit(
                prompt_tokens, params,
                traceparent=ctx.header("traceparent") or None,
                tenant=tenant), prompt_tokens, tenant

        req, prompt_tokens, tenant = await asyncio.get_running_loop() \
            .run_in_executor(ctx.executor, contextvars.copy_context().run,
                             on_pool)
        if req.error:
            raise _refused(req)
        # the RPC's end, for any reason: a request still running is
        # abandoned (its client cancelled or the deadline passed)
        ctx.grpc_context.add_done_callback(
            lambda _: req.finished_at is None and engine.cancel(req))
        return req, prompt_tokens, tenant

    async def tokens_of(ctx, req: GenRequest) -> AsyncIterator[int]:
        """``req``'s tokens as the engine emits them, until the request
        ends or the RPC does (the pump then closes the stream, which
        cancels the request)."""
        gone = threading.Event()
        ctx.grpc_context.add_done_callback(lambda _: gone.set())
        pump = ThreadPump(engine.stream_request(req, timeout_s=POLL_S),
                          gone.is_set, gone.set, ctx.executor,
                          asyncio.get_running_loop())
        try:
            async for token in pump:
                if token is not None:
                    yield token
        finally:
            await pump.aclose()

    class ChatService(GRPCService):
        name = "gofr.serving.Chat"

        @server_stream_rpc
        async def Stream(self, ctx, request) -> AsyncIterator[dict]:
            start = time.perf_counter()
            req, prompt_tokens, tenant = await submit(ctx, request)
            n = 0
            async for token in tokens_of(ctx, req):
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
        async def Complete(self, ctx, request) -> dict:
            req, prompt_tokens, tenant = await submit(ctx, request)
            tokens = [token async for token in tokens_of(ctx, req)]
            if req.error:
                raise RuntimeError(f"generation failed: {req.error}")
            return {"text": tokenizer.decode(tokens), "tokens": tokens,
                    "usage": {"prompt_tokens": len(prompt_tokens),
                              "completion_tokens": len(tokens),
                              "ttft_ms": round(req.ttft_ms, 2)
                              if req.ttft_ms else None,
                              "tenant": tenant}}

    return ChatService()
