"""Model -> Engine glue (counterpart of ``gofr_tpu/serving/glue.py``'s
``llama_engine`` and ``demo_llama_engine``, single device, on every
layout, and its ``moe_engine``, on the slot layout or through the paged
pool's view)."""

from __future__ import annotations

from functools import partial
from typing import Any

import torch

from ..device import resolve_device
from ..models.llama import (LlamaConfig, llama_decode_flops,
                            llama_decode_step, llama_decode_step_paged,
                            llama_init, llama_prefill_chunk,
                            llama_prefill_chunk_paged, llama_prefill_last,
                            make_empty_cache, make_pool)
from ..models.moe import (MoEConfig, moe_decode_flops, moe_decode_step,
                          moe_prefill_last)
from ..ops.quant import (M_MAX, is_quantized, quantize_llama_int4,
                         quantize_llama_int8)
from .engine import Engine, EngineConfig


def llama_engine(params: Any, model_config: LlamaConfig,
                 engine_config: EngineConfig | None = None, *,
                 device: str | torch.device | None = None,
                 quantize: str | None = None) -> Engine:
    """An engine serving ``params`` on ``device`` (default: CUDA, or
    raise), on every layout: bucketed prefill through
    ``llama_prefill_last`` (the flash kernel); on the paged layout,
    unless ``paged_attention="view"``, chunk walks — long prompts and
    prefix-cache suffixes — through ``llama_prefill_chunk_paged`` (the
    paged chunk kernel), speculative tree verify through the same
    function's tree mode (the paged tree kernel), decode through
    ``llama_decode_step_paged`` (the paged decode kernel and the KV
    write kernel), on a head-major pool allocated on the same device in
    the engine config's ``kv_dtype`` (int8 pools go through the kernels'
    int8 branches); on the slot layout and the view, decode through
    ``llama_decode_step`` and the walk and verify through
    ``llama_prefill_chunk`` on dense caches (the view: the pool gathered
    and written back through the slab kernel). T decode steps a dispatch
    replay as one CUDA graph on every layout.

    ``quantize="int8"`` / ``"int4"``: weight-only quantization of
    ``params`` (``ops/quant.py``, on the engine's device) before
    serving; the model functions take the ``{q, s}`` leaves as they
    come, so a tree quantized beforehand (``load_llama_checkpoint(...,
    quantize=)``) serves with ``quantize=None``. With quantized weights
    the decode step's and the tree verify's products must fit the
    weight-dequantizing kernel (:func:`kernel_rows` <= ``M_MAX``), or
    this raises."""
    if quantize is not None and quantize not in ("int8", "int4"):
        raise ValueError(f"quantize must be None, 'int8' or "
                         f"'int4', got {quantize!r}")
    dev = _device_of(params, device)
    engine_config = engine_config or EngineConfig()
    rows = kernel_rows(engine_config)
    if (quantize is not None or is_quantized(params["layers"]["wq"])) \
            and rows > M_MAX:
        raise ValueError(
            f"quantized weights: the decode step or tree verify products "
            f"have {rows} rows, above the weight-dequantizing kernel's "
            f"M_MAX = {M_MAX}; lower max_batch, spec_draft or spec_branches")
    if quantize is not None:
        params = (quantize_llama_int8(params) if quantize == "int8"
                  else quantize_llama_int4(params))
    c = model_config

    def prefill_fn(params, tokens, kv_lengths):
        return llama_prefill_last(params, tokens, c, kv_lengths=kv_lengths)

    def decode_fn(params, tokens, k_cache, v_cache, lengths,
                  attn_window=None):
        return llama_decode_step(params, tokens, k_cache, v_cache, lengths,
                                 c, attn_window=attn_window)

    def prefill_chunk_fn(params, tokens, k_cache, v_cache, offsets,
                         chunk_lengths):
        return llama_prefill_chunk(params, tokens, k_cache, v_cache, offsets,
                                   chunk_lengths, c)

    def spec_verify_fn(params, tokens, k_cache, v_cache, offsets,
                       chunk_lengths, tree_depths=None, tree_masks=None):
        return llama_prefill_chunk(
            params, tokens, k_cache, v_cache, offsets, chunk_lengths, c,
            return_all_logits=True, tree_depths=tree_depths,
            tree_masks=tree_masks)

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

    return Engine(params, engine_config, prefill_fn=prefill_fn,
                  decode_fn=decode_fn, prefill_chunk_fn=prefill_chunk_fn,
                  spec_verify_fn=spec_verify_fn,
                  paged_decode_fn=paged_decode_fn,
                  paged_chunk_fn=paged_chunk_fn,
                  paged_verify_fn=paged_verify_fn,
                  make_cache=partial(_make_cache, c, dev), device=dev,
                  vocab_size=c.vocab_size,
                  flops_per_token=partial(llama_decode_flops, c))


def demo_llama_engine(engine_config: EngineConfig | None = None,
                      seed: int = 0, *,
                      device: str | torch.device | None = None,
                      **kw) -> Engine:
    """A tiny random-weight engine for tests and examples:
    ``LlamaConfig.tiny()`` from ``seed``, ``EngineConfig(max_batch=4,
    max_seq=128)`` unless given, on ``device`` (default: CUDA, or
    raise)."""
    c = LlamaConfig.tiny()
    dev = resolve_device(device)
    params = llama_init(c, torch.Generator().manual_seed(seed), dev)
    return llama_engine(params, c,
                        engine_config or EngineConfig(max_batch=4,
                                                      max_seq=128),
                        device=dev, **kw)


def moe_engine(params: Any, model_config: MoEConfig,
               engine_config: EngineConfig | None = None, *,
               device: str | torch.device | None = None) -> Engine:
    """An engine serving the MoE family's ``params`` on ``device``
    (default: CUDA, or raise): bucketed prefill through
    ``moe_prefill_last`` (the flash kernel), decode through
    ``moe_decode_step`` on dense caches — the slot layout's, or on the
    paged layout the pool's dense view, gathered once a dispatch and
    written back through the slab kernel (an int8 pool dequantized to the
    model's dtype for the view and quantized again on the write) — T
    steps a dispatch replayed as one CUDA graph per decode window. The
    family has no chunk or verify function: prompts are clamped to the
    widest bucket, the prefix cache is off and ``speculative`` serves
    plain decode, as in the JAX engine."""
    dev = _device_of(params, device)
    engine_config = engine_config or EngineConfig()
    c = model_config

    def prefill_fn(params, tokens, kv_lengths):
        logits, caches, _router = moe_prefill_last(params, tokens, c,
                                                   kv_lengths=kv_lengths)
        return logits, caches

    def decode_fn(params, tokens, k_cache, v_cache, lengths,
                  attn_window=None):
        return moe_decode_step(params, tokens, k_cache, v_cache, lengths, c,
                               attn_window=attn_window)

    return Engine(params, engine_config, prefill_fn=prefill_fn,
                  decode_fn=decode_fn,
                  make_cache=partial(_make_cache, c, dev), device=dev,
                  vocab_size=c.vocab_size,
                  flops_per_token=partial(moe_decode_flops, c))


def _make_cache(c: LlamaConfig, dev: torch.device, n: int, rows: int,
                kv_dtype: str = "bf16", head_major: bool = True):
    """The engine's ``make_cache``: a head-major pool of ``n`` pages of
    ``rows`` rows each in ``kv_dtype`` (``make_pool``), or with
    ``head_major=False`` the slot layout's dense caches, ``n`` slots of
    ``rows`` rows (``make_empty_cache``)."""
    if head_major:
        return make_pool(c, n, rows, dev, kv_dtype)
    return make_empty_cache(c, n, rows, dev)


def _device_of(params: Any, device) -> torch.device:
    """The engine's device (``resolve_device``), or raise when the
    params live elsewhere."""
    dev = resolve_device(device)
    embed = params["embed"]
    where = (embed["q"] if is_quantized(embed) else embed).device
    if where != dev:
        raise ValueError(f"params live on {where}, the "
                         f"engine was asked to run on {dev}")
    return dev


def kernel_rows(config: EngineConfig) -> int:
    """The most rows a backbone product has in a decode step
    (``max_batch``) or, with speculation, in a tree verify pass
    (``max_batch`` x the power-of-two width that holds the widest tree,
    at least 2, as the engine buckets it)."""
    if not config.speculative:
        return config.max_batch
    nodes = 1 + config.spec_draft * config.spec_branches
    return config.max_batch * (1 << max(1, (nodes - 1).bit_length()))
