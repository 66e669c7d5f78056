"""``POST /chat`` and ``POST /embed`` of the port's app (counterparts of
``gofr_tpu/serving/handlers.py``'s ``make_chat_handler`` and
``make_embed_handler``).

``{"prompt": str, "max_tokens"?, "temperature"?, "top_p"?, "top_k"?,
"stream"?: bool}``, or ``"messages": [{"content": ...}, ...]`` joined by
newlines when there is no prompt. A unary request answers ``201
{"data": {"text", "tokens", "usage": {"prompt_tokens",
"completion_tokens", "ttft_ms", "tpot_ms", "tenant"}}}``; with
``"stream": true`` every token is one server-sent event ``data:
{"token", "text"}``, then ``data: [DONE]``, or ``data: {"error": ...}``
and no ``[DONE]`` when generation failed. A refused admission answers
503 (429 for a rate limit) with ``Retry-After`` and ``details``; a
failure during generation answers 500, except a typed one (the engine
restarted mid-stream: ``engine_restart``), which answers 503 with
``Retry-After`` and ``details`` as a refusal does, and on a stream adds
those ``details`` to the error event.

Handlers run on the HTTP server's threads and talk to the engine only
through ``submit`` and the request's channel; ``ctx`` (``app.Context``)
gives the body (``bind``), the tenant the server resolved (``tenant``),
the server's ``request_timeout_s`` and whether the client is still
connected (``client_gone``).
"""

from __future__ import annotations

import json
import time
from contextlib import closing
from typing import Any

import numpy as np
import torch

from ..models.bert import bert_encode, mean_pool_embed
from .engine import Engine, GenRequest, SamplingParams
from .responses import (ClientGone, ErrorInvalidParam, ErrorMissingParam,
                        ErrorServiceUnavailable, ErrorTooManyRequests,
                        HTTPError, Raw, Stream)
from .scheduler import retry_after_header

#: seconds a handler waits on a request's channel before it checks that
#: its client is still connected
POLL_S = 0.05


def reject_details(req: GenRequest) -> dict:
    """``{code, tenant, retry_after_s}`` of a typed reject."""
    rej = req.reject
    return {"code": rej.code, "tenant": rej.tenant,
            "retry_after_s": round(rej.retry_after_s, 3)}


def admission_error(req: GenRequest) -> HTTPError:
    """The HTTP error of a refused submission (or of a typed failure
    later, ``engine_restart``): a typed reject gives 429 for a rate limit
    and 503 otherwise (queue full, shed, ``kv_exhausted``, ``draining``,
    ``engine_down``, ``engine_restart``), both with ``Retry-After`` and
    ``details`` ``{code, tenant, retry_after_s}``; an untyped one a plain
    503."""
    rej = req.reject
    if rej is None:
        return ErrorServiceUnavailable(req.error)
    cls = (ErrorTooManyRequests if rej.code == "rate_limited"
           else ErrorServiceUnavailable)
    return cls(req.error, details=reject_details(req),
               headers=retry_after_header(rej))


def live_tokens(ctx: Any, engine: Engine, req: GenRequest,
                timeout_s: float | None = None):
    """The token ids of ``req`` as the engine emits them. After each
    token, and after each wait of ``POLL_S`` without one, the client is
    checked: gone, it raises :class:`ClientGone`; past ``timeout_s`` in
    all, a 504. Either way, and when the caller closes this generator
    early, the request is cancelled (``Engine.stream_request``)."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    with closing(engine.stream_request(req, timeout_s=POLL_S)) as stream:
        for token in stream:
            if ctx.client_gone():
                raise ClientGone
            if token is not None:
                yield token
            if deadline is not None and time.monotonic() >= deadline:
                raise HTTPError("generation timed out", status_code=504)


def make_chat_handler(engine: Engine, tokenizer: Any):
    """The ``POST /chat`` handler over ``engine`` and ``tokenizer``."""

    def chat_handler(ctx) -> Any:
        body = ctx.bind() or {}
        prompt = body.get("prompt")
        if prompt is None and isinstance(body.get("messages"), list):
            prompt = "\n".join(str(m.get("content", ""))
                               for m in body["messages"])
        if not prompt or not isinstance(prompt, str):
            raise ErrorMissingParam("prompt")
        try:
            params = SamplingParams(
                temperature=float(body.get("temperature", 0.7)),
                top_p=float(body.get("top_p", 1.0)),
                top_k=int(body.get("top_k", 0)),
                max_new_tokens=int(body.get("max_tokens",
                                            body.get("max_new_tokens", 128))))
        except (TypeError, ValueError) as exc:
            raise ErrorInvalidParam("temperature/top_p/top_k/max_tokens") \
                from exc
        if params.max_new_tokens < 1 or params.max_new_tokens > 4096:
            raise ErrorInvalidParam("max_tokens")

        prompt_tokens = tokenizer.encode(prompt)
        tenant = ctx.tenant
        # the server's span is active on this thread, so the engine takes
        # its parent from there; the raw header is the fallback
        req = engine.submit(prompt_tokens, params,
                            traceparent=ctx.headers.get("traceparent"),
                            tenant=tenant)
        if req.error:
            # failed at once: admission refused it
            raise admission_error(req)

        if body.get("stream", False):
            def sse():
                with closing(engine.stream_request(
                        req, timeout_s=POLL_S)) as stream:
                    for token in stream:
                        if token is None:
                            yield ""         # no token yet: check the client
                            continue
                        yield ("data: " + json.dumps(
                            {"token": token,
                             "text": tokenizer.decode([token])}) + "\n\n")
                    if req.error:
                        # the truncation must show: no [DONE]
                        event = {"error": req.error}
                        if req.reject is not None:
                            event["details"] = reject_details(req)
                        yield "data: " + json.dumps(event) + "\n\n"
                    else:
                        yield "data: [DONE]\n\n"
            return Stream(sse())

        with closing(live_tokens(ctx, engine, req,
                                 ctx.request_timeout_s)) as live:
            tokens = list(live)
        if req.error:
            if req.reject is not None:
                raise admission_error(req)
            raise HTTPError(f"generation failed: {req.error}",
                            status_code=500)
        tpot_ms = None
        if (req.first_token_at is not None and req.finished_at is not None
                and len(tokens) > 1):
            tpot_ms = ((req.finished_at - req.first_token_at) * 1000.0
                       / (len(tokens) - 1))
        return {
            "text": tokenizer.decode(tokens),
            "tokens": tokens,
            "usage": {
                "prompt_tokens": len(prompt_tokens),
                "completion_tokens": len(tokens),
                "ttft_ms": round(req.ttft_ms, 2) if req.ttft_ms else None,
                "tpot_ms": round(tpot_ms, 3) if tpot_ms else None,
                "tenant": tenant,
            },
        }

    return chat_handler


def make_embed_handler(params: dict, config: Any, tokenizer: Any, *,
                       max_len: int = 512,
                       buckets=(16, 32, 64, 128, 256, 512)):
    """``POST /embed``: ``{"input": str | [str]}`` -> 201 ``{"embeddings":
    [[...]], "dim", "latency_ms"}`` (a bare body, no ``data`` envelope).
    Each text's ids are cut to ``max_len``; the batch is right-padded to
    the least bucket that holds its longest text (the widest bucket cuts
    longer ones); mean pooling over the mask, L2-normalised. The batch
    runs on the device that holds ``params``. A body without ``input``
    answers 400."""
    device = params["word_embed"].device

    def embed_handler(ctx: Any) -> Any:
        body = ctx.bind() or {}
        texts = body.get("input")
        if isinstance(texts, str):
            texts = [texts]
        if not texts or not isinstance(texts, list):
            raise ErrorMissingParam("input")
        start = time.perf_counter()
        token_lists = [tokenizer.encode(t)[:max_len] for t in texts]
        longest = max(len(t) for t in token_lists)
        bucket = next((b for b in buckets if longest <= b), buckets[-1])
        batch = np.zeros((len(texts), bucket), np.int64)
        mask = np.zeros((len(texts), bucket), np.int32)
        for i, toks in enumerate(token_lists):
            toks = toks[:bucket]
            batch[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        with torch.inference_mode():
            mask_t = torch.from_numpy(mask).to(device)
            hidden, _ = bert_encode(params, torch.from_numpy(batch).to(device),
                                    config, attention_mask=mask_t)
            emb = mean_pool_embed(hidden, mask_t).cpu().double().numpy()
        return Raw({
            "embeddings": [e.tolist() for e in emb],
            "dim": int(emb.shape[-1]),
            "latency_ms": round((time.perf_counter() - start) * 1000, 2),
        })

    return embed_handler
