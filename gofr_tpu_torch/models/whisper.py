"""Whisper-family encoder-decoder for ASR (counterpart of
``gofr_tpu/models/whisper.py``).

Two 1-D convolutions (the second at stride 2) and sinusoidal positions
feed a pre-LN encoder; the decoder has causal self-attention over a
dense cache, cross-attention over the encoder output (its K/V computed
once per utterance), learned positions and the tied output embedding.
Layer weights are stacked ``[L, ...]``, linear matrices ``[in, out]``
as in the JAX tree; the convolutions are stored ``[out, in, k]``
(PyTorch's and Hugging Face's layout; the JAX tree's ``[k, in, out]``
is transposed once, by ``convert.whisper_params_from_jax``).

Greedy transcription runs eagerly, one decode step at a time, where the
JAX package compiles one graph per (batch, max_tokens) bucket; it stops
early once every row has emitted end-of-text, which leaves the output
as the fixed-length loop gives it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import decode_attention, xla_attention
from ..ops.audio import log_mel_spectrogram
from ..ops.norms import layer_norm
from .bert import unstack


@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51866
    n_mels: int = 80
    audio_frames: int = 3000     # 30 s at a 10 ms hop
    audio_ctx: int = 1500        # frames after the stride-2 convolution
    text_ctx: int = 448
    dim: int = 1280
    n_heads: int = 20
    n_audio_layers: int = 32
    n_text_layers: int = 32
    sot_token: int = 50258       # <|startoftranscript|>
    eot_token: int = 50257       # <|endoftext|>
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def tiny_test(cls) -> "WhisperConfig":
        """Milliseconds-everywhere test shape."""
        return cls(vocab_size=128, n_mels=8, audio_frames=64, audio_ctx=32,
                   text_ctx=32, dim=32, n_heads=4, n_audio_layers=2,
                   n_text_layers=2, sot_token=1, eot_token=2,
                   dtype=torch.float32)

    @classmethod
    def whisper_tiny(cls) -> "WhisperConfig":
        return cls(dim=384, n_heads=6, n_audio_layers=4, n_text_layers=4,
                   vocab_size=51865)

    @classmethod
    def whisper_base(cls) -> "WhisperConfig":
        return cls(dim=512, n_heads=8, n_audio_layers=6, n_text_layers=6,
                   vocab_size=51865)

    @classmethod
    def whisper_small(cls) -> "WhisperConfig":
        return cls(dim=768, n_heads=12, n_audio_layers=12, n_text_layers=12,
                   vocab_size=51865)

    @classmethod
    def whisper_large_v3(cls) -> "WhisperConfig":
        return cls(n_mels=128)   # the large defaults; v3 has 128 mels

    def scaled(self, **kw) -> "WhisperConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------- params

def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positional table (log-spaced sinusoids)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def whisper_init(config: WhisperConfig, generator: torch.Generator,
                 device: str | torch.device) -> dict:
    """Random-init parameters drawn from ``generator`` (on the
    generator's device) and placed on ``device``; the JAX
    ``whisper_init``'s scales: N(0, 1/fan_in) matrices, N(0, 0.02²) token
    and N(0, 0.01²) position embeddings, unit norms, zero biases."""
    c = config
    gdev = generator.device

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * std
        return x.to(device=device, dtype=c.dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=c.dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=c.dtype)

    def block(L: int, cross: bool) -> dict:
        d = c.dim
        out = {
            "ln1_w": ones((L, d)), "ln1_b": zeros((L, d)),
            "wq": normal((L, d, d), d ** -0.5), "bq": zeros((L, d)),
            "wk": normal((L, d, d), d ** -0.5),     # no k bias (Whisper)
            "wv": normal((L, d, d), d ** -0.5), "bv": zeros((L, d)),
            "wo": normal((L, d, d), d ** -0.5), "bo": zeros((L, d)),
            "ln_mlp_w": ones((L, d)), "ln_mlp_b": zeros((L, d)),
            "fc1": normal((L, d, 4 * d), d ** -0.5),
            "fc1_b": zeros((L, 4 * d)),
            "fc2": normal((L, 4 * d, d), (4 * d) ** -0.5),
            "fc2_b": zeros((L, d)),
        }
        if cross:
            out.update({
                "lnx_w": ones((L, d)), "lnx_b": zeros((L, d)),
                "xwq": normal((L, d, d), d ** -0.5), "xbq": zeros((L, d)),
                "xwk": normal((L, d, d), d ** -0.5),
                "xwv": normal((L, d, d), d ** -0.5), "xbv": zeros((L, d)),
                "xwo": normal((L, d, d), d ** -0.5), "xbo": zeros((L, d)),
            })
        return out

    return {
        "conv1_w": normal((c.dim, c.n_mels, 3), (3 * c.n_mels) ** -0.5),
        "conv1_b": zeros((c.dim,)),
        "conv2_w": normal((c.dim, c.dim, 3), (3 * c.dim) ** -0.5),
        "conv2_b": zeros((c.dim,)),
        "enc_pos": torch.from_numpy(_sinusoids(c.audio_ctx, c.dim))
        .to(device=device, dtype=c.dtype),
        "enc_layers": block(c.n_audio_layers, cross=False),
        "enc_ln_w": ones((c.dim,)),
        "enc_ln_b": zeros((c.dim,)),
        "embed": normal((c.vocab_size, c.dim), 0.02),
        "dec_pos": normal((c.text_ctx, c.dim), 0.01),
        "dec_layers": block(c.n_text_layers, cross=True),
        "dec_ln_w": ones((c.dim,)),
        "dec_ln_b": zeros((c.dim,)),
    }


# ---------------------------------------------------------------- encoder

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default, the tanh approximation, in x's dtype
    return F.gelu(x, approximate="tanh")


def _same_pad(length: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding: the output has ``ceil(length / stride)``
    frames, and an odd total pad puts the extra frame on the right. At
    3000 frames, stride 2, that is (0, 1), not ``Conv1d(padding=1)``'s
    (1, 1)."""
    total = max((math.ceil(length / stride) - 1) * stride + kernel - length,
                0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int) -> torch.Tensor:
    """[B, T, in] -> [B, ceil(T / stride), out], ``w`` [out, in, k]; the
    bias added after the product, in x's dtype, as JAX adds it."""
    xt = x.transpose(1, 2)
    xt = F.pad(xt, _same_pad(xt.shape[-1], w.shape[-1], stride))
    return F.conv1d(xt, w, stride=stride).transpose(1, 2) + b


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = x.shape
    return x.reshape(b, s, h * hd)


def _mlp(h: torch.Tensor, lp: dict) -> torch.Tensor:
    m = layer_norm(h, lp["ln_mlp_w"], lp["ln_mlp_b"])
    return h + (_gelu(m @ lp["fc1"] + lp["fc1_b"]) @ lp["fc2"]
                + lp["fc2_b"])


def _cross(h: torch.Tensor, lp: dict, xk: torch.Tensor, xv: torch.Tensor,
           n_heads: int) -> torch.Tensor:
    xa = layer_norm(h, lp["lnx_w"], lp["lnx_b"])
    xq = _heads(xa @ lp["xwq"] + lp["xbq"], n_heads)
    xattn = xla_attention(xq, xk, xv, causal=False)
    return h + (_merge(xattn) @ lp["xwo"] + lp["xbo"])


def whisper_encode(params: dict, mel: torch.Tensor,
                   config: WhisperConfig) -> torch.Tensor:
    """mel [B, frames, n_mels] -> encoder states [B, audio_ctx, dim]."""
    c = config
    x = mel.to(c.dtype)
    x = _gelu(_conv(x, params["conv1_w"], params["conv1_b"], 1))
    x = _gelu(_conv(x, params["conv2_w"], params["conv2_b"], 2))
    x = x + params["enc_pos"][None, :x.shape[1], :]
    for lp in unstack(params["enc_layers"], c.n_audio_layers):
        a = layer_norm(x, lp["ln1_w"], lp["ln1_b"])
        q = _heads(a @ lp["wq"] + lp["bq"], c.n_heads)
        k = _heads(a @ lp["wk"], c.n_heads)
        v = _heads(a @ lp["wv"] + lp["bv"], c.n_heads)
        attn = xla_attention(q, k, v, causal=False)
        x = x + (_merge(attn) @ lp["wo"] + lp["bo"])
        x = _mlp(x, lp)
    return layer_norm(x, params["enc_ln_w"], params["enc_ln_b"])


# ---------------------------------------------------------------- decoder

def precompute_cross_kv(params: dict, enc: torch.Tensor,
                        config: WhisperConfig) -> tuple:
    """Per-layer cross-attention K/V from the encoder output, computed
    once per utterance and reused by every decode step: (k, v), each
    [L, B, audio_ctx, H, hd]."""
    c = config
    lp = params["dec_layers"]
    ks, vs = [], []
    for i in range(c.n_text_layers):
        ks.append(_heads(enc @ lp["xwk"][i], c.n_heads))
        vs.append(_heads(enc @ lp["xwv"][i] + lp["xbv"][i], c.n_heads))
    return torch.stack(ks), torch.stack(vs)


def _decoder_prefill(params: dict, tokens: torch.Tensor,
                     positions: torch.Tensor, cross_k: torch.Tensor,
                     cross_v: torch.Tensor, config: WhisperConfig):
    """A causal prefill over a token prompt.

    tokens [B, S]; positions [S] absolute; cross_k/v [L, B, Sa, H, hd].
    Returns (hidden [B, S, dim], (k, v) each [L, B, S, H, hd])."""
    c = config
    x = params["embed"][tokens].to(c.dtype) \
        + params["dec_pos"][positions][None].to(c.dtype)
    new_k, new_v = [], []
    for i, lp in enumerate(unstack(params["dec_layers"], c.n_text_layers)):
        a = layer_norm(x, lp["ln1_w"], lp["ln1_b"])
        q = _heads(a @ lp["wq"] + lp["bq"], c.n_heads)
        k = _heads(a @ lp["wk"], c.n_heads)
        v = _heads(a @ lp["wv"] + lp["bv"], c.n_heads)
        attn = xla_attention(q, k, v, causal=True)
        x = x + (_merge(attn) @ lp["wo"] + lp["bo"])
        x = _cross(x, lp, cross_k[i], cross_v[i], c.n_heads)
        x = _mlp(x, lp)
        new_k.append(k)
        new_v.append(v)
    x = layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    return x, (torch.stack(new_k), torch.stack(new_v))


def _logits(params: dict, hidden: torch.Tensor,
            config: WhisperConfig) -> torch.Tensor:
    """float32 product with the tied token embedding."""
    return hidden.float() @ params["embed"].float().T


def _decoder_step_kv(params: dict, tok: torch.Tensor, pos: int,
                     cross_k: torch.Tensor, cross_v: torch.Tensor,
                     c: WhisperConfig, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, lengths: torch.Tensor,
                     layers: list[dict] | None = None):
    """One decode step that writes its K/V into the dense cache
    ``[L, B, T, H, hd]`` at row ``lengths[b]`` (in place) and attends
    rows ``< lengths[b] + 1``. Returns (logits [B, V], cache_k,
    cache_v). ``layers``: ``unstack(params["dec_layers"], L)``, made once
    by a caller that steps many times."""
    x = params["embed"][tok[:, None]].to(c.dtype) \
        + params["dec_pos"][pos][None, None].to(c.dtype)
    if layers is None:
        layers = unstack(params["dec_layers"], c.n_text_layers)
    batch = torch.arange(tok.shape[0], device=tok.device)
    for i, lp in enumerate(layers):
        a = layer_norm(x, lp["ln1_w"], lp["ln1_b"])
        q = _heads(a @ lp["wq"] + lp["bq"], c.n_heads)
        k = _heads(a @ lp["wk"], c.n_heads)
        v = _heads(a @ lp["wv"] + lp["bv"], c.n_heads)
        cache_k[i, batch, lengths] = k[:, 0].to(cache_k.dtype)
        cache_v[i, batch, lengths] = v[:, 0].to(cache_v.dtype)
        attn = decode_attention(q, cache_k[i], cache_v[i], lengths + 1)
        x = x + (_merge(attn) @ lp["wo"] + lp["bo"])
        x = _cross(x, lp, cross_k[i], cross_v[i], c.n_heads)
        x = _mlp(x, lp)
    x = layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    return _logits(params, x[:, -1], c), cache_k, cache_v


def transcribe_greedy(params: dict, mel: torch.Tensor,
                      config: WhisperConfig, *,
                      max_tokens: int = 64
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy ASR: mel [B, frames, n_mels] -> (tokens [B,
    max_tokens] int32, lengths [B] int32).

    Encode, the cross K/V, the start-token prefill, then decode step
    ``i`` at position ``i + 1`` over a cache of ``max_tokens + 1`` rows.
    ``tokens[:, 0]`` is the first sampled token; a row's tokens after
    its end-of-text are end-of-text, and ``lengths`` counts the others.
    Greedy ties go to the lowest id."""
    c = config
    b = mel.shape[0]
    dev = mel.device
    enc = whisper_encode(params, mel, c)
    cross_k, cross_v = precompute_cross_kv(params, enc, c)

    sot = torch.full((b, 1), c.sot_token, dtype=torch.int64, device=dev)
    hidden, (first_k, first_v) = _decoder_prefill(
        params, sot, torch.arange(1, device=dev), cross_k, cross_v, c)
    first_logits = _logits(params, hidden[:, -1], c)

    shape = (c.n_text_layers, b, max_tokens + 1, c.n_heads, c.head_dim)
    cache_k = torch.zeros(shape, dtype=c.dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    cache_k[:, :, :1] = first_k
    cache_v[:, :, :1] = first_v

    tok = first_logits.argmax(dim=-1)
    done = tok == c.eot_token
    out = [tok]
    layers = unstack(params["dec_layers"], c.n_text_layers)
    # the step that would sample token max_tokens is not run: the JAX
    # scan computes it and drops it
    for i in range(max_tokens - 1):
        if bool(done.all()):
            break
        lengths = torch.full((b,), i + 1, dtype=torch.int64, device=dev)
        logits, cache_k, cache_v = _decoder_step_kv(
            params, tok, i + 1, cross_k, cross_v, c, cache_k, cache_v,
            lengths, layers)
        nxt = logits.argmax(dim=-1)
        tok = torch.where(done, torch.full_like(nxt, c.eot_token), nxt)
        done = done | (tok == c.eot_token)
        out.append(tok)
    tokens = torch.full((b, max_tokens), c.eot_token, dtype=torch.int32,
                        device=dev)
    tokens[:, :len(out)] = torch.stack(out, dim=1).to(torch.int32)
    lengths = (tokens != c.eot_token).sum(dim=-1).to(torch.int32)
    return tokens, lengths


def transcribe_audio(params: dict, audio: torch.Tensor,
                     config: WhisperConfig, *, max_tokens: int = 64):
    """PCM [B, T] -> (tokens, lengths): the mel frontend padded to
    ``audio_frames``, then greedy decoding."""
    mel = log_mel_spectrogram(audio, n_mels=config.n_mels,
                              pad_to_frames=config.audio_frames)
    return transcribe_greedy(params, mel, config, max_tokens=max_tokens)


def param_count(params: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else param_count(v)
               for v in params.values())
