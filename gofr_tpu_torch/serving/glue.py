"""Model -> Engine glue (counterpart of ``gofr_tpu/serving/glue.py``'s
``llama_engine`` and ``demo_llama_engine``, on one device or, with
``mesh=``, on a tensor-parallel mesh of ranks, on every layout, and its
``moe_engine``, on the slot layout or through the paged pool's view)."""

from __future__ import annotations

from dataclasses import replace
from functools import partial
from typing import Any

import torch
import torch.distributed as dist

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
from ..parallel.comm import TensorParallel
from ..parallel.sharding import (Sharding, kv_cache_spec, kv_pool_spec,
                                 llama_param_specs, shard_params)
from .engine import Engine, EngineConfig


def llama_engine(params: Any, model_config: LlamaConfig,
                 engine_config: EngineConfig | None = None, *,
                 device: str | torch.device | None = None,
                 quantize: str | None = None, mesh: Any = None,
                 metrics: Any = None, logger: Any = None,
                 tracer: Any = None) -> Engine:
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
    this raises.

    ``mesh=`` (``parallel.mesh.create_mesh``): serve on a tensor-parallel
    mesh, as JAX's ``llama_engine(mesh=)``. Every rank of the mesh calls
    this with the same whole ``params`` (on the CPU or on its device)
    and arguments: the tree is quantized first when asked, then cut to
    this rank's shards (``shard_params(llama_param_specs(mesh))``) on
    the mesh's device; the caches hold this rank's ``Hkv / tp`` KV heads
    (dense caches ``[L, B, S, Hkv/tp, hd]``, pools ``[L, Hkv/tp, Np, pg,
    hd]``); the steps run their tp forms (``models/llama.py``), with the
    all-reduces after ``wo`` and ``w2`` and the logits whole on every
    rank. As in JAX no native paged function is passed on a mesh, so the
    paged layout serves through the pool's dense view. ``dp`` ranks hold
    replicas of their ``tp`` line and run the same operations; ``pp``
    and ``sp`` above 1 are refused. The mesh's leader rank returns the
    serving engine (``start()``, ``submit``); every other rank's engine
    runs ``serving.lockstep.follow(engine)``. On an ``nccl`` mesh the
    decode dispatch is a captured CUDA graph holding the all-reduces; on
    ``gloo`` (ranks sharing one card) it runs uncaptured.

    ``metrics`` (a ``metrics.Manager``: the engine's series are
    registered on it), ``logger`` and ``tracer`` are set on the engine,
    as JAX's ``llama_engine`` sets them; ``App.serve_model`` adopts
    what is set and fills in the rest."""
    if quantize is not None and quantize not in ("int8", "int4"):
        raise ValueError(f"quantize must be None, 'int8' or "
                         f"'int4', got {quantize!r}")
    tp = None
    if mesh is None:
        dev = _device_of(params, device)
    else:
        dev, tp = _mesh_device(mesh, model_config, device)
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
    if mesh is not None:
        return _mesh_engine(params, c, engine_config, mesh, dev, tp,
                            metrics=metrics, logger=logger, tracer=tracer)

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
                  flops_per_token=partial(llama_decode_flops, c),
                  metrics=metrics, logger=logger, tracer=tracer)


def _mesh_device(mesh: Any, c: LlamaConfig, device) -> tuple:
    """(this rank's device, its ``TensorParallel``) for a serving mesh,
    or raise: a rank outside the mesh, ``pp`` / ``sp`` above 1, KV heads
    that do not split over ``tp``, a ``device`` other than the mesh's."""
    for axis in ("pp", "sp"):
        if mesh.size(axis) > 1:
            raise ValueError(
                f"llama_engine(mesh=): serving runs tp (and dp replicas); "
                f"{axis} = {mesh.size(axis)} is not served (pipeline and "
                f"sequence-parallel serving are not implemented)")
    if mesh.rank is None:
        raise ValueError(f"this rank is outside the mesh {mesh.shape}")
    tp = mesh.size("tp")
    if c.n_kv_heads % tp or c.n_heads % tp:
        raise ValueError(f"{c.n_heads} query / {c.n_kv_heads} KV heads do "
                         f"not split over tp = {tp}")
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"the mesh's device is {mesh.device}, the engine "
                         f"was asked to run on {device}")
    return mesh.device, TensorParallel(mesh)


def _mesh_engine(params: Any, c: LlamaConfig, engine_config: EngineConfig,
                 mesh: Any, dev: torch.device, tp: TensorParallel,
                 **wiring: Any) -> Engine:
    """The tp engine of ``llama_engine(mesh=)`` on this rank's shards."""
    params = shard_params(params, mesh, llama_param_specs(mesh))
    size = mesh.size("tp")
    if tp.group is not None and mesh.backend == "nccl":
        # NCCL makes its communicator at the first collective, which must
        # not be inside a graph capture
        dist.all_reduce(torch.zeros(1, device=dev), group=tp.group)

    def prefill_fn(params, tokens, kv_lengths):
        return llama_prefill_last(params, tokens, c, kv_lengths=kv_lengths,
                                  tp=tp)

    def decode_fn(params, tokens, k_cache, v_cache, lengths,
                  attn_window=None):
        return llama_decode_step(params, tokens, k_cache, v_cache, lengths,
                                 c, attn_window=attn_window, tp=tp)

    def prefill_chunk_fn(params, tokens, k_cache, v_cache, offsets,
                         chunk_lengths):
        return llama_prefill_chunk(params, tokens, k_cache, v_cache, offsets,
                                   chunk_lengths, c, tp=tp)

    def spec_verify_fn(params, tokens, k_cache, v_cache, offsets,
                       chunk_lengths, tree_depths=None, tree_masks=None):
        return llama_prefill_chunk(
            params, tokens, k_cache, v_cache, offsets, chunk_lengths, c,
            return_all_logits=True, tree_depths=tree_depths,
            tree_masks=tree_masks, tp=tp)

    engine = Engine(params, engine_config, prefill_fn=prefill_fn,
                    decode_fn=decode_fn, prefill_chunk_fn=prefill_chunk_fn,
                    spec_verify_fn=spec_verify_fn,
                    make_cache=partial(_make_cache, c, dev, mesh=mesh),
                    device=dev,
                    vocab_size=c.vocab_size,
                    flops_per_token=lambda n: llama_decode_flops(c, n) / size,
                    mesh=mesh, **wiring)
    engine.tp = tp
    return engine


def demo_config(device: str | torch.device) -> LlamaConfig:
    """The demo engine's model: ``LlamaConfig.tiny()``, JAX's demo model
    (float32, head_dim 16), on every device: the CUDA kernels take its
    type and head dim as they take any other."""
    del device
    return LlamaConfig.tiny()


def demo_llama_engine(engine_config: EngineConfig | None = None,
                      seed: int = 0, *,
                      device: str | torch.device | None = None,
                      **kw) -> Engine:
    """A tiny random-weight engine for tests, examples and the operator
    tools (``scripts/torch_replay.py``, ``torch_capacity.py``): the
    model of :func:`demo_config` from ``seed``,
    ``EngineConfig(max_batch=4, max_seq=128)`` unless given, on
    ``device`` (default: CUDA, or raise)."""
    dev = resolve_device(device)
    c = demo_config(dev)
    params = llama_init(c, torch.Generator().manual_seed(seed), dev)
    return llama_engine(params, c,
                        engine_config or EngineConfig(max_batch=4,
                                                      max_seq=128),
                        device=dev, **kw)


def moe_engine(params: Any, model_config: MoEConfig,
               engine_config: EngineConfig | None = None, *,
               device: str | torch.device | None = None,
               metrics: Any = None, logger: Any = None,
               tracer: Any = None) -> Engine:
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
    plain decode, as in the JAX engine. ``metrics``, ``logger`` and
    ``tracer``: as :func:`llama_engine`'s."""
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
                  flops_per_token=partial(moe_decode_flops, c),
                  metrics=metrics, logger=logger, tracer=tracer)


def _make_cache(c: LlamaConfig, dev: torch.device, n: int, rows: int,
                kv_dtype: str = "bf16", head_major: bool = True, *,
                mesh: Any = None):
    """The engine's ``make_cache``: a head-major pool of ``n`` pages of
    ``rows`` rows each in ``kv_dtype`` (``make_pool``), or with
    ``head_major=False`` the slot layout's dense caches, ``n`` slots of
    ``rows`` rows (``make_empty_cache``). On a ``mesh``: this rank's
    block of the KV heads, as ``kv_pool_spec`` / ``kv_cache_spec`` place
    them (each rank allocates its own block; no whole cache exists)."""
    if mesh is not None:
        spec, dim = ((kv_pool_spec(mesh), 1) if head_major
                     else (kv_cache_spec(mesh), 3))
        shape = [1] * 5
        shape[dim] = c.n_kv_heads
        heads = Sharding(mesh, spec).index(shape)[dim]
        c = replace(c, n_kv_heads=heads.stop - heads.start)
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
