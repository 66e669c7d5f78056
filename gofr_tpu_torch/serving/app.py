"""HTTP front end of the port: ``POST /chat`` and ``GET
/.well-known/health`` on the standard library's threading HTTP server
(counterpart of ``gofr_tpu/app.py:serve_model`` with
``gofr_tpu/serving/handlers.py:make_chat_handler``; no streaming, no
OpenAI routes, no metrics port in this slice).

``POST /chat`` takes ``{"prompt", "max_tokens"?, "temperature"?,
"top_p"?, "top_k"?}`` and answers ``{"data": {"text", "tokens",
"usage": {...}}}``; errors answer ``{"error": {"message"}}``.

Run: ``python -m gofr_tpu_torch.serving.app`` on ``HTTP_HOST`` (default
0.0.0.0) and ``HTTP_PORT`` (default 8000) on the CUDA device, with the
model chosen as ``examples/model-serving/main.py`` chooses it
(:func:`app_engine`):

- ``MODEL_PATH``: a local Hugging Face Llama directory (``config.json``,
  ``model.safetensors`` or its sharded index, optionally
  ``tokenizer.json``, which switches on the BPE tokenizer and its
  end-of-text id); ``MODEL_MAX_SEQ`` (default 8192) caps its context,
  ``MODEL_DTYPE`` overrides its dtype;
- else ``MODEL_PRESET`` (default ``llama3_1b``), random weights from
  seed 0, with the byte tokenizer;
- ``MODEL_QUANT=int8|int4`` quantizes the weights in either case (on
  load for a checkpoint): their decode products and every LM head then
  run through the weight-dequantizing GEMM kernel.

Prompts up to the widest bucket prefill through the flash kernel,
longer ones and prefix-cache suffixes walk through the paged chunk
kernel, and every token decodes through the paged decode kernel. The
prefix cache is on, as in the JAX engine.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any

import torch

from ..device import resolve_device
from ..models.hf_checkpoint import (load_llama_checkpoint,
                                    resolve_serving_dtype)
from ..models.llama import LlamaConfig, llama_init
from .engine import Engine, EngineConfig, SamplingParams
from .glue import llama_engine
from .tokenizer import BPETokenizer, ByteTokenizer


class _HTTPError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


def _sampling_params(body: dict) -> SamplingParams:
    try:
        params = SamplingParams(
            temperature=float(body.get("temperature", 0.7)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0)),
            max_new_tokens=int(body.get("max_tokens",
                                        body.get("max_new_tokens", 128))))
    except (TypeError, ValueError) as exc:
        raise _HTTPError(400, "invalid temperature/top_p/top_k/max_tokens") \
            from exc
    if not 1 <= params.max_new_tokens <= 4096:
        raise _HTTPError(400, "max_tokens must be in [1, 4096]")
    return params


class _Handler(BaseHTTPRequestHandler):
    server: "ChatServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # quiet: one line per request would swamp the smoke output

    def _send(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server's naming
        if self.path != "/.well-known/health":
            self._send(404, {"error": {"message": "not found"}})
            return
        health = self.server.engine.health_check()
        self._send(200 if health["status"] == "UP" else 503,
                   {"data": health})

    def do_POST(self) -> None:  # noqa: N802 — http.server's naming
        if self.path != "/chat":
            self._send(404, {"error": {"message": "not found"}})
            return
        try:
            self._send(200, {"data": self._chat()})
        except _HTTPError as exc:
            self._send(exc.status, {"error": {"message": str(exc)}})

    def _chat(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError as exc:
            raise _HTTPError(400, "body is not JSON") from exc
        prompt = body.get("prompt") if isinstance(body, dict) else None
        if not prompt or not isinstance(prompt, str):
            raise _HTTPError(400, "missing parameter: prompt")
        params = _sampling_params(body)
        server = self.server
        prompt_tokens = server.tokenizer.encode(prompt)
        req = server.engine.submit(prompt_tokens, params)
        if not req.done.wait(server.request_timeout_s):
            # the caller is gone: free the slot instead of decoding to
            # max_tokens for nobody (gofr_tpu/serving/handlers.py cancels)
            server.engine.cancel(req)
            raise _HTTPError(504, "generation timed out")
        if req.error:
            raise _HTTPError(503, req.error)
        tokens = list(req.generated)
        tpot_ms = None
        if req.first_token_at and req.finished_at and len(tokens) > 1:
            tpot_ms = ((req.finished_at - req.first_token_at) * 1000.0
                       / (len(tokens) - 1))
        return {"text": server.tokenizer.decode(tokens),
                "tokens": tokens,
                "usage": {"prompt_tokens": len(prompt_tokens),
                          "completion_tokens": len(tokens),
                          "ttft_ms": req.ttft_ms,
                          "tpot_ms": tpot_ms}}


class ChatServer(ThreadingHTTPServer):
    """Threading HTTP server bound to an engine and a tokenizer."""

    daemon_threads = True

    def __init__(self, address: tuple, engine: Engine, tokenizer: Any,
                 request_timeout_s: float = 600.0) -> None:
        super().__init__(address, _Handler)
        self.engine = engine
        self.tokenizer = tokenizer
        self.request_timeout_s = request_timeout_s


def serve_config(model_config: LlamaConfig, **overrides) -> EngineConfig:
    """The engine that ``chip_smoke.py`` measures: 8 slots of up to 2048
    rows (fewer when the model's context is shorter) in 64-row pages,
    prefill buckets up to 1024, the prefix cache on (a quarter of the
    pool); ``overrides`` set other ``EngineConfig`` fields (the smoke's
    speculative cell: ``speculative=True, spec_ngram=2``; its int8 cell:
    ``kv_dtype="int8"``, the same bytes of pool as about twice the
    pages)."""
    return EngineConfig(**{"max_batch": 8,
                           "max_seq": min(2048, model_config.max_seq),
                           "page_size": 64, "seed": 0, **overrides})


def build_engine(model_config: LlamaConfig, *,
                 device: str | torch.device | None = None, seed: int = 0,
                 engine_config: EngineConfig | None = None,
                 quantize: str | None = None) -> Engine:
    """An engine for ``model_config`` with random weights drawn from
    ``seed`` on ``device`` (default: CUDA, or raise), quantized with
    ``quantize`` (None, "int8", "int4"); ``engine_config`` defaults to
    ``serve_config(model_config)``."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    params = llama_init(model_config, generator, dev)
    engine_config = engine_config or serve_config(model_config)
    return llama_engine(params, model_config, engine_config, device=dev,
                        quantize=quantize)


def app_engine(env: Mapping[str, str], *,
               device: str | torch.device | None = None
               ) -> tuple[Engine, Any, str]:
    """(engine, tokenizer, model name) from the environment surface of
    ``examples/model-serving/main.py``, on ``device`` (default: CUDA, or
    raise). ``MODEL_PATH``: a local HF Llama checkpoint directory, its
    weights quantized on load with ``MODEL_QUANT`` (``int8`` / ``int4``),
    its context capped at ``MODEL_MAX_SEQ`` (default 8192), its dtype
    ``MODEL_DTYPE``, served by ``serve_config`` with that context; a
    ``tokenizer.json`` beside the weights gives the BPE tokenizer, and
    the engine stops at its end-of-text id (without one the byte
    tokenizer serves and nothing stops early: its eos id would alias an
    ordinary vocabulary id). Else ``MODEL_PRESET`` (default
    ``llama3_1b``), random weights from seed 0, the byte tokenizer,
    ``MODEL_QUANT`` honoured the same way."""
    quantize = env.get("MODEL_QUANT", "") or None
    model_path = env.get("MODEL_PATH", "")
    if model_path:
        dev = resolve_device(device)
        dtype_name = env.get("MODEL_DTYPE", "")
        params, model_config = load_llama_checkpoint(
            model_path, quantize=quantize,
            max_seq=int(env.get("MODEL_MAX_SEQ", "8192")),
            dtype=resolve_serving_dtype(dtype_name) if dtype_name else None,
            device=dev)
        tokenizer: Any = ByteTokenizer()
        eos_id = -1
        tok_json = Path(model_path) / "tokenizer.json"
        if tok_json.is_file():
            tokenizer = BPETokenizer.from_hf_json(tok_json)
            eos_id = tokenizer.eos_id
        config = serve_config(model_config, max_seq=model_config.max_seq,
                              eos_id=eos_id)
        return (llama_engine(params, model_config, config, device=dev),
                tokenizer, Path(model_path).name)
    preset = env.get("MODEL_PRESET", "llama3_1b")
    engine = build_engine(getattr(LlamaConfig, preset)(), device=device,
                          quantize=quantize)
    return engine, ByteTokenizer(), preset


def build_server(engine: Engine, tokenizer: Any = None,
                 host: str = "127.0.0.1", port: int = 0) -> ChatServer:
    """Bind (port 0 = any free port); call ``serve_forever()`` on it."""
    return ChatServer((host, port), engine, tokenizer or ByteTokenizer())


def main() -> None:
    env = os.environ
    engine, tokenizer, name = app_engine(env)
    server = build_server(engine, tokenizer,
                          host=env.get("HTTP_HOST", "0.0.0.0"),
                          port=int(env.get("HTTP_PORT", "8000")))
    engine.start()
    print(f"serving {name} on http://{server.server_address[0]}:"
          f"{server.server_address[1]} (POST /chat)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
