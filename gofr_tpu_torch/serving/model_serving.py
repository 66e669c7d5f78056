"""Model serving through the framework: a Llama-family model behind
``POST /chat`` and the OpenAI-compatible ``/v1`` routes of an
:class:`~gofr_tpu_torch.app.App` (the counterpart of
``examples/model-serving/main.py``'s ``build_app``).

    python -m gofr_tpu_torch.serving.model_serving

The model comes from the environment surface of :func:`.app.app_engine`
(``MODEL_PATH`` / ``MODEL_MAX_SEQ`` / ``MODEL_DTYPE`` for a local Hugging
Face checkpoint, else ``MODEL_PRESET``, default ``llama3_1b``, with
random weights from seed 0; ``MODEL_QUANT=int8|int4``), read through the
app's config (``configs/.env``, ``configs/.{APP_ENV}.env``, then the
process environment). The app's own keys apply: ``HTTP_PORT`` (default
8000), ``METRICS_PORT`` (default 2121), ``REQUEST_TIMEOUT``,
``PROFILER_ENABLED``, ``SHUTDOWN_GRACE_PERIOD``, ... The engine runs on
CUDA, or :func:`build_app` raises, unless the caller passes ``device``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..app import App, new_app
from .app import app_engine
from .openai_compat import install_openai_routes

#: the served model's name in the container, health and ``/debug/*``
MODEL_NAME = "llama"


class _ConfigEnv:
    """A config as the mapping ``app_engine`` reads (``get(key,
    default)``)."""

    def __init__(self, config: Any) -> None:
        self._config = config

    def get(self, key: str, default: str | None = None) -> str | None:
        value = self._config.get(key)
        return default if value in (None, "") else value


def build_app(config: Any = None, *,
              device: str | torch.device | None = None) -> App:
    """An app serving the configured model on ``device`` (default: CUDA,
    or raise): ``App.serve_model`` (``POST /chat``, health, metrics, the
    debug routes, lifecycle) and ``install_openai_routes`` (``/v1/*``,
    the model id the preset's or the checkpoint directory's name).
    ``config``: a ``Config`` (default: ``EnvConfig("configs")``)."""
    app = new_app() if config is None else App(config=config)
    engine, tokenizer, model_id = app_engine(_ConfigEnv(app.config),
                                             device=device)
    app.serve_model(MODEL_NAME, engine, tokenizer)
    install_openai_routes(app, engine, tokenizer, model=model_id)
    return app


if __name__ == "__main__":
    build_app().run()
