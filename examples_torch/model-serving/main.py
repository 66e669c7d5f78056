"""TPU model serving — the flagship path with no reference
counterpart: a Llama-family model behind /chat AND the
OpenAI-compatible /v1 surface, with continuous batching, TTFT
metrics, and health showing engine state.

Uses the tiny random-weight config by default so it runs anywhere.
Point MODEL_PATH at an HF-format checkpoint directory
(config.json + model.safetensors [+ tokenizer.json]) to serve real
weights; or set MODEL_PRESET=llama3_1b (etc.) for a random-weight
architecture twin. MODEL_QUANT=int8|int4 enables weight-only quantization
(half the HBM traffic of the memory-bound decode) in either mode.
"""

from gofr_tpu_torch.app import App, new_app


def build_app(config=None, *, device=None) -> App:
    import torch
    from gofr_tpu_torch.device import resolve_device
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.serving.engine import EngineConfig
    from gofr_tpu_torch.serving.glue import llama_engine
    from gofr_tpu_torch.serving.openai_compat import install_openai_routes
    from gofr_tpu_torch.serving.tokenizer import BPETokenizer, ByteTokenizer

    app = new_app() if config is None else App(config=config)
    quant = app.config.get_or_default("MODEL_QUANT", "") or None
    model_path = app.config.get_or_default("MODEL_PATH", "")
    tokenizer = ByteTokenizer()
    hf_tokenizer = False
    if model_path:
        from pathlib import Path

        from gofr_tpu_torch.models.hf_checkpoint import (load_llama_checkpoint,
                                                   resolve_serving_dtype)
        max_seq = int(app.config.get_or_default("MODEL_MAX_SEQ", "8192"))
        dtype_name = app.config.get_or_default("MODEL_DTYPE", "")
        params, model_config = load_llama_checkpoint(
            model_path, quantize=quant, max_seq=max_seq,
            dtype=resolve_serving_dtype(dtype_name) if dtype_name else None,
            device=device)
        quant = None  # already applied on load
        model_name = Path(model_path).name
        tok_json = Path(model_path) / "tokenizer.json"
        if tok_json.is_file():
            tokenizer = BPETokenizer.from_hf_json(tok_json)
            hf_tokenizer = True
    else:
        model_name = app.config.get_or_default("MODEL_PRESET", "tiny")
        model_config = getattr(LlamaConfig, model_name)()
        # the byte tokenizer's ids (BOS 257, EOS 258) must lie inside the
        # model's vocabulary, which the tiny preset's 256 does not hold
        model_config = model_config.scaled(
            vocab_size=max(model_config.vocab_size, tokenizer.vocab_size))
        params = llama_init(model_config, torch.Generator().manual_seed(0),
                            resolve_device(device))
    engine = llama_engine(
        params, model_config,
        EngineConfig(max_batch=4, max_seq=model_config.max_seq,
                     # stop at end-of-text only when the checkpoint's
                     # own tokenizer defined it — the byte-fallback's
                     # eos_id would alias an ordinary vocab token
                     eos_id=tokenizer.eos_id if hf_tokenizer else -1),
        device=device, quantize=quant)
    app.serve_model("llama", engine,
                    tokenizer)  # POST /chat + health + lifecycle
    install_openai_routes(app, engine, tokenizer,
                          model=model_name)  # /v1/* (OpenAI clients)
    return app


if __name__ == "__main__":
    build_app().run()
