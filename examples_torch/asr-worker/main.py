"""ASR batch worker (baseline config 4): Whisper transcription pulled
from pub/sub in device-sized batches + an interactive /transcribe
endpoint. No reference counterpart — this is the TPU-native analog of
a GoFr subscriber app.
"""

import asyncio

from gofr_tpu_torch.app import App, new_app


def build_app(config=None, *, device=None) -> App:
    import torch
    from gofr_tpu_torch.device import resolve_device
    from gofr_tpu_torch.models.whisper import WhisperConfig, whisper_init
    from gofr_tpu_torch.serving.asr import (ASRConfig, ASRWorker, Transcriber,
                                      make_asr_handler)

    app = new_app() if config is None else App(config=config)
    if app.container.pubsub is None:
        from gofr_tpu_torch.pubsub.inmemory import InMemoryBroker
        app.container.add_pubsub(InMemoryBroker(
            logger=app.logger, metrics=app.container.metrics))

    model_path = app.config.get_or_default("MODEL_PATH", "")
    if model_path:
        # HF-format Whisper checkpoint (config.json + model.safetensors);
        # MODEL_DTYPE overrides the serving dtype (default bfloat16 —
        # set float32 to keep a float32 checkpoint's exact numerics)
        from gofr_tpu_torch.models.hf_checkpoint import (load_whisper_checkpoint,
                                                   resolve_serving_dtype)
        dtype_name = app.config.get_or_default("MODEL_DTYPE", "")
        params, model_config = load_whisper_checkpoint(
            model_path,
            dtype=resolve_serving_dtype(dtype_name) if dtype_name else None,
            device=device)
    else:
        preset = getattr(
            WhisperConfig,
            app.config.get_or_default("MODEL_PRESET", "tiny_test"))
        model_config = preset()
        params = whisper_init(model_config, torch.Generator().manual_seed(0),
                              resolve_device(device))
    transcriber = Transcriber(params, model_config,
                              ASRConfig(max_batch=4, max_tokens=16,
                                        sample_buckets=(16000, 80000)),
                              device=device)
    app.container.add_model("whisper", transcriber)
    app.post("/transcribe", make_asr_handler(transcriber))

    worker = ASRWorker(transcriber, app.container.pubsub)
    app.state_worker = worker  # exposed for tests/inspection

    @app.on_start
    def start_worker(container):
        app._tasks.append(asyncio.ensure_future(worker.run()))

    return app


if __name__ == "__main__":
    build_app().run()
