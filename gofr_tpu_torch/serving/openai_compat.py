"""The OpenAI-compatible routes of the port's app:
``/v1/chat/completions``, ``/v1/completions`` and ``/v1/models`` over
the engine (counterpart of ``gofr_tpu/serving/openai_compat.py``, same
envelopes and errors).

    install_openai_routes(server, engine, tokenizer, model="llama3_1b")

Request surface: ``messages`` / ``prompt``, ``max_tokens`` (and
``max_completion_tokens``), ``temperature``, ``top_p``, ``stream``,
``stop`` (up to 4 strings, enforced while the tokens arrive: the text is
cut at the match and the request cancelled), ``n`` (only 1; a 400
otherwise). Answers: ``chat.completion`` / ``text_completion`` objects
with ``chatcmpl-`` / ``cmpl-`` ids, ``finish_reason`` ("stop" for eos or
a stop sequence, "length" for the token budget) and token ``usage``.
Streaming is SSE: for chat a role chunk first, then content deltas
re-decoded from the whole token list (held back while they could start
a stop sequence or end in a split character), a terminal chunk with
``finish_reason``, then ``data: [DONE]``; a failure sends an ``error``
event and no ``[DONE]``. Errors: ``invalid_request_error`` 400,
``rate_limit_error`` 429 and ``server_error`` 503 with ``Retry-After``
for refused admissions and for a typed failure during generation (the
engine restarted mid-stream), ``server_error`` 500 for any other failed
generation.
"""

from __future__ import annotations

import json
import secrets
import time
from contextlib import closing
from typing import Any

from .engine import Engine, GenRequest, SamplingParams
from .handlers import POLL_S, live_tokens
from .responses import HTTPError, Raw, Stream
from .scheduler import retry_after_header


class _OpenAIError(HTTPError):
    """The ``{"error": {"message", "details": {"type", "param"}}}``
    envelope: clients key on the status and ``error.message``."""

    def __init__(self, message: str, *, status: int = 400,
                 err_type: str = "invalid_request_error",
                 param: str | None = None) -> None:
        super().__init__(message, status_code=status,
                         details={"type": err_type, "param": param})


def _typed_error(req: GenRequest) -> _OpenAIError:
    """A refused or typed-failed request: ``rate_limit_error`` 429 for a
    rate limit, else ``server_error`` 503, with ``Retry-After`` when the
    reject is typed."""
    rej = req.reject
    limited = rej is not None and rej.code == "rate_limited"
    err = _OpenAIError(req.error, status=429 if limited else 503,
                       err_type="rate_limit_error" if limited
                       else "server_error")
    if rej is not None:
        err.headers.update(retry_after_header(rej))
    return err


def _content_text(content: Any) -> str:
    """Message content: a string, or text parts ``[{"type": "text",
    "text": ...}, ...]`` concatenated (any other part is refused)."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        texts = []
        for part in content:
            if not isinstance(part, dict) or part.get("type") != "text" \
                    or not isinstance(part.get("text"), str):
                raise _OpenAIError(
                    "only text content parts are supported",
                    param="messages")
            texts.append(part["text"])
        return "".join(texts)
    raise _OpenAIError("message content must be a string or text parts",
                       param="messages")


def _render_messages(messages: list) -> str:
    """The role-tagged transcript ``role: content`` per line, then
    ``assistant:`` (``render`` replaces it with a checkpoint's own
    template)."""
    parts = []
    for m in messages:
        if not isinstance(m, dict) or "content" not in m:
            raise _OpenAIError("each message needs role and content",
                               param="messages")
        parts.append(f"{m.get('role', 'user')}: "
                     f"{_content_text(m['content'])}")
    parts.append("assistant:")
    return "\n".join(parts)


def _opt(body: dict, key: str, default):
    """An explicit JSON null counts as absent."""
    value = body.get(key, default)
    return default if value is None else value


def _params_from(body: dict) -> SamplingParams:
    max_new = _opt(body, "max_completion_tokens",
                   _opt(body, "max_tokens", 128))
    try:
        params = SamplingParams(
            temperature=float(_opt(body, "temperature", 1.0)),
            top_p=float(_opt(body, "top_p", 1.0)),
            max_new_tokens=int(max_new))
        n = int(_opt(body, "n", 1))
    except (TypeError, ValueError) as exc:
        raise _OpenAIError("temperature/top_p/max_tokens/n must be "
                           "numbers", param="max_tokens") from exc
    if not 1 <= params.max_new_tokens <= 4096:
        raise _OpenAIError("max_tokens out of range [1, 4096]",
                           param="max_tokens")
    if n != 1:
        raise _OpenAIError("only n=1 is supported", param="n")
    return params


def _stops_from(body: dict) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or len(stop) > 4 \
            or not all(isinstance(s, str) and s for s in stop):
        raise _OpenAIError("stop must be a string or up to 4 strings",
                           param="stop")
    return stop


def _cut_at_stop(text: str, stops: list[str]) -> tuple[str, bool]:
    """``text`` cut at the earliest stop-sequence match; True on a
    match."""
    cut = -1
    for s in stops:
        i = text.find(s)
        if i >= 0 and (cut < 0 or i < cut):
            cut = i
    return (text[:cut], True) if cut >= 0 else (text, False)


class OpenAIRoutes:
    def __init__(self, engine: Engine, tokenizer: Any, *,
                 model: str = "gofr-tpu", render=None) -> None:
        self.engine = engine
        self.tokenizer = tokenizer
        self.model = model
        self.render = render or _render_messages

    def models(self, ctx) -> Any:
        return Raw({"object": "list",
                    "data": [{"id": self.model, "object": "model",
                              "owned_by": "gofr-tpu"}]})

    def chat_completions(self, ctx) -> Any:
        body = ctx.bind() or {}
        messages = body.get("messages")
        if not messages or not isinstance(messages, list):
            raise _OpenAIError("messages required", param="messages")
        prompt = self.render(messages)
        return self._complete(ctx, body, prompt, chat=True)

    def completions(self, ctx) -> Any:
        body = ctx.bind() or {}
        prompt = body.get("prompt")
        if isinstance(prompt, list):  # the API allows a list of one
            prompt = prompt[0] if prompt else None
        if not prompt or not isinstance(prompt, str):
            raise _OpenAIError("prompt required", param="prompt")
        return self._complete(ctx, body, prompt, chat=False)

    def _complete(self, ctx, body: dict, prompt: str, *, chat: bool) -> Any:
        params = _params_from(body)
        stops = _stops_from(body)
        prompt_tokens = self.tokenizer.encode(prompt)
        req = self.engine.submit(prompt_tokens, params,
                                 traceparent=ctx.headers.get("traceparent"),
                                 tenant=ctx.tenant)
        if req.error:
            raise _typed_error(req)
        oid = ("chatcmpl-" if chat else "cmpl-") + secrets.token_hex(12)
        created = int(time.time())
        if body.get("stream"):
            return Stream(self._sse(req, oid, created, stops, chat))

        tokens: list[int] = []
        stopped = False
        with closing(live_tokens(ctx, self.engine, req,
                                 ctx.request_timeout_s)) as live:
            for token in live:
                tokens.append(token)
                if stops:
                    # a match ends the drain, and closing the stream
                    # cancels the request: no slot decodes past it
                    _, stopped = _cut_at_stop(
                        self.tokenizer.decode(tokens), stops)
                    if stopped:
                        break
        if req.error:
            if req.reject is not None:
                raise _typed_error(req)
            raise _OpenAIError(f"generation failed: {req.error}",
                               status=500, err_type="server_error")
        text, hit = _cut_at_stop(self.tokenizer.decode(tokens), stops)
        stopped = stopped or hit
        finish = "stop" if (stopped or len(tokens)
                            < params.max_new_tokens) else "length"
        choice = ({"index": 0, "message": {"role": "assistant",
                                           "content": text},
                   "finish_reason": finish} if chat else
                  {"index": 0, "text": text, "finish_reason": finish})
        return Raw({
            "id": oid,
            "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": self.model,
            "choices": [choice],
            "usage": {"prompt_tokens": len(prompt_tokens),
                      "completion_tokens": len(tokens),
                      "total_tokens": len(prompt_tokens) + len(tokens)},
        })

    def _sse(self, req: GenRequest, oid: str, created: int,
             stops: list[str], chat: bool):
        def chunk(delta: dict | None, finish: str | None = None) -> str:
            if chat:
                c = {"index": 0, "delta": delta or {},
                     "finish_reason": finish}
            else:
                c = {"index": 0, "text": (delta or {}).get("content", ""),
                     "finish_reason": finish}
            return "data: " + json.dumps({
                "id": oid,
                "object": ("chat.completion.chunk" if chat
                           else "text_completion"),
                "created": created, "model": self.model,
                "choices": [c]}) + "\n\n"

        # deltas come from re-decoding the whole token list (one token
        # alone may be half a multi-byte character); ``hold`` characters
        # stay back while they could still begin a stop sequence
        tokens_acc: list[int] = []
        sent = 0
        hold = max((len(s) for s in stops), default=1) - 1
        stopped = False
        with closing(self.engine.stream_request(req,
                                                timeout_s=POLL_S)) as stream:
            if chat:
                yield chunk({"role": "assistant"})
            for token in stream:
                if token is None:
                    yield ""                 # no token yet: check the client
                    continue
                tokens_acc.append(token)
                text = self.tokenizer.decode(tokens_acc)
                cut, stopped = _cut_at_stop(text, stops)
                if stopped:
                    if cut[sent:]:
                        yield chunk({"content": cut[sent:]})
                    break
                emit_to = len(text) - hold
                # a split multi-byte character decodes as U+FFFD until
                # its rest arrives: trailing replacements stay back
                while emit_to > sent and text[emit_to - 1] == "�":
                    emit_to -= 1
                if emit_to > sent:
                    yield chunk({"content": text[sent:emit_to]})
                    sent = emit_to
            if req.error:
                yield ("data: " + json.dumps(
                    {"error": {"message": req.error,
                               "type": "server_error"}}) + "\n\n")
                return
            if not stopped:
                text = self.tokenizer.decode(tokens_acc)
                if text[sent:]:
                    yield chunk({"content": text[sent:]})
            finish = "stop" if (stopped or len(tokens_acc)
                                < req.params.max_new_tokens) else "length"
            yield chunk(None, finish)
            yield "data: [DONE]\n\n"


def install_openai_routes(app: Any, engine: Engine, tokenizer: Any, *,
                          model: str = "gofr-tpu", render=None
                          ) -> OpenAIRoutes:
    """Register the three routes on ``app`` (an ``App``, a ``ChatServer``, or
    anything with ``post(path, fn)`` / ``get(path, fn)``)."""
    routes = OpenAIRoutes(engine, tokenizer, model=model, render=render)
    app.post("/v1/chat/completions", routes.chat_completions)
    app.post("/v1/completions", routes.completions)
    app.get("/v1/models", routes.models)
    return routes
