"""Local Hugging Face Llama and Whisper checkpoints (counterpart of
``gofr_tpu/models/hf_checkpoint.py``).

* :func:`read_safetensors` / :func:`write_safetensors` — the safetensors
  container from scratch (u64-LE header length, a JSON header of
  ``{name: {dtype, shape, data_offsets}}``, raw little-endian bytes),
  memory-mapped so a checkpoint is never buffered whole in Python. BF16
  needs no third-party type: its bytes are read as 16-bit integers and
  viewed as ``torch.bfloat16``, and written back the same way;
* :func:`load_llama_checkpoint` — HF names and ``[out, in]`` layouts
  (``model.layers.{i}.self_attn.q_proj.weight``) onto the port's stacked
  tree (``[L, in, out]`` plain, ``[L, out, in]`` quantized),
  ``config.json`` for the architecture and the
  ``model.safetensors.index.json`` weight map for sharded checkpoints,
  tensor by tensor onto the device, with optional int8 / int4
  quantize-on-load (``ops/quant.py``);
* :func:`save_llama_checkpoint` — the inverse (one file, or shards with
  their index), so a tree round-trips to a directory any HF-format
  consumer reads, the JAX package's loader included;
* :func:`load_whisper_checkpoint` / :func:`save_whisper_checkpoint` —
  the same for ``WhisperForConditionalGeneration`` directories and the
  port's Whisper tree.

Local files only: nothing here downloads.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import quantize_int4, quantize_int8
from .llama import LlamaConfig
from .whisper import WhisperConfig

# safetensors dtype tag -> torch dtype; BF16 travels as 16-bit integers
_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NP_OF = {torch.float64: np.float64, torch.float32: np.float32,
          torch.float16: np.float16, torch.bfloat16: np.int16,
          torch.int64: np.int64, torch.int32: np.int32,
          torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
          torch.bool: np.bool_}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Parse one .safetensors file into name -> CPU tensor.

    The tensors share one copy-on-write ``np.memmap`` of the file: a
    tensor's bytes are read when it is used, and nothing is written
    back."""
    path = Path(path)
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    data = np.memmap(path, mode="c", offset=8 + header_len)
    out: dict[str, torch.Tensor] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _DTYPES[spec["dtype"]]
        except KeyError:
            raise ValueError(f"unsupported safetensors dtype "
                             f"{spec['dtype']!r}") from None
        start, end = spec["data_offsets"]
        raw = data[start:end]
        if raw.ctypes.data % np.dtype(_NP_OF[dtype]).itemsize:
            raw = raw.copy()    # an unaligned run (an unpadded header)
        arr = raw.view(_NP_OF[dtype]).reshape(spec["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
    return out


def write_safetensors(path: str | Path, tensors: dict[str, torch.Tensor],
                      metadata: dict[str, str] | None = None) -> None:
    """Write tensors as one .safetensors file (little-endian, C order;
    the header padded with spaces to a multiple of 8 bytes, so every
    tensor's bytes stay aligned)."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    tag_of = {dt: tag for tag, dt in _DTYPES.items()}
    offset = 0
    blobs: list[bytes] = []
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in tag_of:
            raise ValueError(f"cannot store dtype {t.dtype} in safetensors")
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
            .numpy()
        blob = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": tag_of[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


# ------------------------------------------------------------ llama map
#
# HF linear layers store [out_features, in_features]. The port's plain
# products run x @ w with stacked [L, in, out] weights, so an unquantized
# load transposes every projection on the way through; its quantized
# matrices are stored [L, out, in] (ops/quant.py), so a quantized load
# takes HF's layout as it is.

_LAYER_MAP = (
    # (tree key, HF suffix, transpose when unquantized)
    ("attn_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("ffn_norm", "post_attention_layernorm.weight", False),
    ("w1", "mlp.gate_proj.weight", True),
    ("w3", "mlp.up_proj.weight", True),
    ("w2", "mlp.down_proj.weight", True),
)

_SERVING_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
                   "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                   "float16": torch.float16, "fp16": torch.float16}


def resolve_serving_dtype(name: str) -> torch.dtype:
    """Map a user-facing dtype name (``MODEL_DTYPE``) to a torch float
    dtype, accepting the common short spellings; anything else — ``int8``
    above all, which is not quantization — is rejected up front."""
    dtype = _SERVING_DTYPES.get(name.strip().lower())
    if dtype is None:
        raise ValueError(
            f"MODEL_DTYPE={name!r}: expected one of "
            f"{sorted(set(_SERVING_DTYPES))} (for int8 weight-only "
            f"quantization use MODEL_QUANT=int8)")
    return dtype


def llama_config_from_hf(cfg: dict) -> LlamaConfig:
    """config.json -> LlamaConfig (HF "LlamaForCausalLM" schema)."""
    return LlamaConfig(
        vocab_size=cfg["vocab_size"],
        dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads",
                           cfg["num_attention_heads"]),
        ffn_dim=cfg["intermediate_size"],
        max_seq=cfg.get("max_position_embeddings", 8192),
        rope_theta=float(cfg.get("rope_theta", 500000.0)),
        rope_scaling=cfg.get("rope_scaling"),
        norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
    )


def llama_config_to_hf(c: LlamaConfig) -> dict:
    out = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": c.vocab_size,
        "hidden_size": c.dim,
        "num_hidden_layers": c.n_layers,
        "num_attention_heads": c.n_heads,
        "num_key_value_heads": c.n_kv_heads,
        "intermediate_size": c.ffn_dim,
        "max_position_embeddings": c.max_seq,
        "rope_theta": c.rope_theta,
        "rms_norm_eps": c.norm_eps,
        "tie_word_embeddings": c.tie_embeddings,
    }
    if c.rope_scaling:
        out["rope_scaling"] = c.rope_scaling
    return out


def _resolve_weight_files(directory: Path) -> dict[str, Path]:
    """name -> file, honoring the sharded-checkpoint index."""
    index = directory / "model.safetensors.index.json"
    if index.is_file():
        weight_map = json.loads(index.read_text())["weight_map"]
        return {name: directory / fname
                for name, fname in weight_map.items()}
    single = directory / "model.safetensors"
    if single.is_file():
        return {name: single for name in read_safetensors(single)}
    raise FileNotFoundError(
        f"no model.safetensors or model.safetensors.index.json under "
        f"{directory}")


def _tensor_reader(directory: Path):
    """name -> memmap-backed CPU tensor across the checkpoint's files,
    each file opened at its first use."""
    files = _resolve_weight_files(directory)
    opened: dict[Path, dict[str, torch.Tensor]] = {}

    def tensor(name: str) -> torch.Tensor:
        try:
            path = files[name]
        except KeyError:
            raise KeyError(f"checkpoint is missing tensor {name!r}") \
                from None
        if path not in opened:
            opened[path] = read_safetensors(path)
        return opened[path][name]

    return tensor


def load_llama_checkpoint(directory: str | Path, *,
                          dtype: torch.dtype | None = None,
                          quantize: str | None = None,
                          max_seq: int | None = None,
                          device: str | torch.device | None = None,
                          ) -> tuple[dict, LlamaConfig]:
    """Load an HF-format Llama checkpoint directory into ``(params,
    LlamaConfig)`` on ``device`` (default: CUDA, or raise), ready for
    ``serving.glue.llama_engine``.

    ``dtype`` overrides the serving dtype (default: the config's,
    bfloat16); ``quantize="int8"`` / ``"int4"`` quantizes the weight
    matrices on load, one stacked matrix at a time on the device, so the
    full-precision tree never resides there; ``max_seq`` caps the KV
    capacity below the checkpoint's ``max_position_embeddings`` (a cap,
    never a raise)."""
    if quantize not in (None, "int8", "int4"):
        raise ValueError(f"quantize must be None, 'int8' or 'int4', "
                         f"got {quantize!r}")
    dev = resolve_device(device)
    directory = Path(directory)
    config = llama_config_from_hf(
        json.loads((directory / "config.json").read_text()))
    if max_seq is not None:
        config = config.scaled(max_seq=min(config.max_seq, max_seq))
    if dtype is not None:
        config = config.scaled(dtype=dtype)
    tensor = _tensor_reader(directory)
    qfn = {None: None, "int8": quantize_int8, "int4": quantize_int4}[quantize]
    c = config

    def on_device(name: str, transpose: bool = False) -> torch.Tensor:
        # straight from the memmap into the serving dtype on the device
        t = tensor(name).to(dev).to(c.dtype)
        return t.t().contiguous() if transpose else t

    def to(t: torch.Tensor, quant_axis: int | None):
        if qfn is not None and quant_axis is not None:
            return qfn(t, axis=quant_axis)
        return t

    def stack(key: str, suffix: str, transpose: bool):
        stacked = torch.stack([on_device(f"model.layers.{i}.{suffix}",
                                         transpose and qfn is None)
                               for i in range(c.n_layers)])
        # quantized [L, out, in]: reduce the contraction axis; norm gains
        # stay exact
        return to(stacked, None if key.endswith("_norm") else 2)

    params: dict = {
        # embed [V, D]: per-row scales serve the gather AND the tied head
        "embed": to(on_device("model.embed_tokens.weight"), 1),
        "layers": {key: stack(key, suffix, tr)
                   for key, suffix, tr in _LAYER_MAP},
        "final_norm": on_device("model.norm.weight"),
    }
    if not c.tie_embeddings:   # [V, D] quantized, [D, V] plain
        params["lm_head"] = to(on_device("lm_head.weight", qfn is None), 1)
    return params, config


def save_llama_checkpoint(params: dict, config: LlamaConfig,
                          directory: str | Path, *,
                          shards: int = 1) -> None:
    """Export a (plain, unquantized) Llama tree as an HF-format
    checkpoint directory: config.json and model.safetensors, or with
    ``shards`` > 1 that many ``model-0000i-of-0000n.safetensors`` files
    (tensors in order, cut by bytes) and ``model.safetensors.index.json``.
    The inverse of :func:`load_llama_checkpoint`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(
        json.dumps(llama_config_to_hf(config), indent=1))

    def host(t: torch.Tensor, transpose: bool) -> torch.Tensor:
        t = t.detach().to("cpu")
        if t.dtype not in (torch.float32, torch.float16, torch.bfloat16):
            t = t.float()
        return t.t() if transpose else t

    tensors: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": host(params["embed"], False),
        "model.norm.weight": host(params["final_norm"], False),
    }
    for key, suffix, transpose in _LAYER_MAP:
        stacked = params["layers"][key]
        for i in range(config.n_layers):
            tensors[f"model.layers.{i}.{suffix}"] = host(stacked[i],
                                                         transpose)
    if "lm_head" in params:
        tensors["lm_head.weight"] = host(params["lm_head"], True)
    if shards <= 1:
        write_safetensors(directory / "model.safetensors", tensors,
                          metadata={"format": "pt"})
        return
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    groups: list[dict] = [{} for _ in range(shards)]
    seen = 0
    for name, t in tensors.items():
        groups[min(shards - 1, seen * shards // total)][name] = t
        seen += t.numel() * t.element_size()
    weight_map = {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        write_safetensors(directory / fname, group,
                          metadata={"format": "pt"})
        weight_map.update({name: fname for name in group})
    (directory / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=1))


# ---------------------------------------------------------- whisper map
#
# HF "WhisperForConditionalGeneration" layout. Linear layers are [out, in]
# and transpose into the port's stacked [L, in, out]; the convolutions
# are [out, in, k] on both sides (the JAX tree's are [k, in, out], so its
# loader reverses their axes and this one does not). k_proj has no bias
# in any Whisper size; proj_out is tied to the token embedding.

_WHISPER_BLOCK = (
    ("ln1_w", "self_attn_layer_norm.weight", False),
    ("ln1_b", "self_attn_layer_norm.bias", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("bq", "self_attn.q_proj.bias", False),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("bv", "self_attn.v_proj.bias", False),
    ("wo", "self_attn.out_proj.weight", True),
    ("bo", "self_attn.out_proj.bias", False),
    ("ln_mlp_w", "final_layer_norm.weight", False),
    ("ln_mlp_b", "final_layer_norm.bias", False),
    ("fc1", "fc1.weight", True),
    ("fc1_b", "fc1.bias", False),
    ("fc2", "fc2.weight", True),
    ("fc2_b", "fc2.bias", False),
)
_WHISPER_CROSS = (
    ("lnx_w", "encoder_attn_layer_norm.weight", False),
    ("lnx_b", "encoder_attn_layer_norm.bias", False),
    ("xwq", "encoder_attn.q_proj.weight", True),
    ("xbq", "encoder_attn.q_proj.bias", False),
    ("xwk", "encoder_attn.k_proj.weight", True),
    ("xwv", "encoder_attn.v_proj.weight", True),
    ("xbv", "encoder_attn.v_proj.bias", False),
    ("xwo", "encoder_attn.out_proj.weight", True),
    ("xbo", "encoder_attn.out_proj.bias", False),
)
#: tree key -> HF name of the leaves outside the layer stacks
_WHISPER_TOP = (
    ("conv1_w", "model.encoder.conv1.weight"),
    ("conv1_b", "model.encoder.conv1.bias"),
    ("conv2_w", "model.encoder.conv2.weight"),
    ("conv2_b", "model.encoder.conv2.bias"),
    ("enc_pos", "model.encoder.embed_positions.weight"),
    ("enc_ln_w", "model.encoder.layer_norm.weight"),
    ("enc_ln_b", "model.encoder.layer_norm.bias"),
    ("embed", "model.decoder.embed_tokens.weight"),
    ("dec_pos", "model.decoder.embed_positions.weight"),
    ("dec_ln_w", "model.decoder.layer_norm.weight"),
    ("dec_ln_b", "model.decoder.layer_norm.bias"),
)


def _whisper_stacks(config: WhisperConfig):
    """(tree key, HF side, layer count, entries) of the two stacks."""
    return (("enc_layers", "encoder", config.n_audio_layers, _WHISPER_BLOCK),
            ("dec_layers", "decoder", config.n_text_layers,
             _WHISPER_BLOCK + _WHISPER_CROSS))


def whisper_config_from_hf(cfg: dict) -> WhisperConfig:
    """config.json -> WhisperConfig; refuses a checkpoint whose encoder
    and decoder head counts differ (the config models one count, true of
    every released size; another would reshape q/k/v wrong silently)."""
    enc_heads = cfg.get("encoder_attention_heads", 8)
    dec_heads = cfg.get("decoder_attention_heads", enc_heads)
    if dec_heads != enc_heads:
        raise ValueError(
            f"unsupported Whisper config: encoder_attention_heads="
            f"{enc_heads} != decoder_attention_heads={dec_heads}")
    return WhisperConfig(
        vocab_size=cfg["vocab_size"],
        n_mels=cfg.get("num_mel_bins", 80),
        dim=cfg["d_model"],
        n_heads=enc_heads,
        n_audio_layers=cfg["encoder_layers"],
        n_text_layers=cfg["decoder_layers"],
        audio_ctx=cfg.get("max_source_positions", 1500),
        audio_frames=2 * cfg.get("max_source_positions", 1500),
        text_ctx=cfg.get("max_target_positions", 448),
        sot_token=cfg.get("decoder_start_token_id", 50258),
        eot_token=cfg.get("eos_token_id", 50257),
    )


def whisper_config_to_hf(c: WhisperConfig) -> dict:
    return {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper",
        "vocab_size": c.vocab_size,
        "num_mel_bins": c.n_mels,
        "d_model": c.dim,
        "encoder_attention_heads": c.n_heads,
        "decoder_attention_heads": c.n_heads,
        "encoder_layers": c.n_audio_layers,
        "decoder_layers": c.n_text_layers,
        "max_source_positions": c.audio_ctx,
        "max_target_positions": c.text_ctx,
        "decoder_start_token_id": c.sot_token,
        "eos_token_id": c.eot_token,
    }


def load_whisper_checkpoint(directory: str | Path, *,
                            dtype: torch.dtype | None = None,
                            device: str | torch.device | None = None,
                            ) -> tuple[dict, WhisperConfig]:
    """Load an HF-format Whisper checkpoint directory into ``(params,
    WhisperConfig)`` on ``device`` (default: CUDA, or raise), for
    ``models/whisper.py``'s transcription. ``dtype`` overrides the
    serving dtype (default: the config's, bfloat16)."""
    dev = resolve_device(device)
    directory = Path(directory)
    config = whisper_config_from_hf(
        json.loads((directory / "config.json").read_text()))
    if dtype is not None:
        config = config.scaled(dtype=dtype)
    tensor = _tensor_reader(directory)

    def on_device(name: str, transpose: bool = False) -> torch.Tensor:
        t = tensor(name).to(dev).to(config.dtype)
        return t.t().contiguous() if transpose else t

    params: dict = {key: on_device(name) for key, name in _WHISPER_TOP}
    for key, side, n_layers, entries in _whisper_stacks(config):
        params[key] = {
            k: torch.stack([on_device(f"model.{side}.layers.{i}.{suffix}",
                                      transpose) for i in range(n_layers)])
            for k, suffix, transpose in entries}
    return params, config


def save_whisper_checkpoint(params: dict, config: WhisperConfig,
                            directory: str | Path) -> None:
    """Export a Whisper tree as an HF-format checkpoint directory
    (config.json and model.safetensors): the inverse of
    :func:`load_whisper_checkpoint`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(
        json.dumps(whisper_config_to_hf(config), indent=1))

    def host(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        t = t.detach().to("cpu")
        if t.dtype not in (torch.float32, torch.float16, torch.bfloat16):
            t = t.float()
        return t.t() if transpose else t

    tensors = {name: host(params[key]) for key, name in _WHISPER_TOP}
    for key, side, n_layers, entries in _whisper_stacks(config):
        for k, suffix, transpose in entries:
            for i in range(n_layers):
                tensors[f"model.{side}.layers.{i}.{suffix}"] = host(
                    params[key][k][i], transpose)
    write_safetensors(directory / "model.safetensors", tensors,
                      metadata={"format": "pt"})
