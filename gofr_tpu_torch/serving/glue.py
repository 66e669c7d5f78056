"""Model -> Engine glue (counterpart of ``gofr_tpu/serving/glue.py``'s
``llama_engine``, single device, native paged layout)."""

from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from ..models.llama import (LlamaConfig, llama_decode_step_paged,
                            llama_prefill_chunk_paged, llama_prefill_last,
                            make_pool)
from .engine import Engine, EngineConfig


def llama_engine(params: Any, model_config: LlamaConfig,
                 engine_config: EngineConfig | None = None, *,
                 device: str | torch.device | None = None) -> Engine:
    """An engine serving ``params`` on ``device`` (default: CUDA, or
    raise): bucketed prefill through ``llama_prefill_last`` (the flash
    kernel), chunk walks — long prompts and prefix-cache suffixes —
    through ``llama_prefill_chunk_paged`` (the paged chunk kernel),
    speculative tree verify through the same function's tree mode (the
    paged tree kernel), decode through ``llama_decode_step_paged`` (the
    paged decode kernel and the KV write kernel, T steps a dispatch
    replayed as one CUDA graph), on a head-major pool allocated on the same
    device in the engine config's ``kv_dtype`` (int8 pools go through
    the kernels' int8 branches)."""
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, the "
                         f"engine was asked to run on {dev}")
    c = model_config

    def prefill_fn(params, tokens, kv_lengths):
        return llama_prefill_last(params, tokens, c, kv_lengths=kv_lengths)

    def paged_decode_fn(params, tokens, k_pool, v_pool, tables, lengths,
                        active=None):
        return llama_decode_step_paged(params, tokens, k_pool, v_pool,
                                       tables, lengths, c, active=active)

    def paged_chunk_fn(params, tokens, k_pool, v_pool, tables, offsets,
                       chunk_lengths):
        return llama_prefill_chunk_paged(params, tokens, k_pool, v_pool,
                                         tables, offsets, chunk_lengths, c)

    def paged_verify_fn(params, tokens, k_pool, v_pool, tables, offsets,
                        chunk_lengths, tree_depths=None, tree_masks=None):
        return llama_prefill_chunk_paged(
            params, tokens, k_pool, v_pool, tables, offsets, chunk_lengths,
            c, return_all_logits=True, tree_depths=tree_depths,
            tree_masks=tree_masks)

    def make_cache(n_pages, page, kv_dtype):
        return make_pool(c, n_pages, page, dev, kv_dtype)

    return Engine(params, engine_config or EngineConfig(),
                  prefill_fn=prefill_fn, paged_decode_fn=paged_decode_fn,
                  paged_chunk_fn=paged_chunk_fn,
                  paged_verify_fn=paged_verify_fn, make_cache=make_cache,
                  device=dev,
                  vocab_size=c.vocab_size)
