"""BERT-family encoder, the ``/embed`` model (counterpart of
``gofr_tpu/models/bert.py``).

Bidirectional encoder: learned position and segment embeddings, post-LN
blocks, a tanh-approximate GELU MLP, a tanh pooler over [CLS]. Layer
weights are stacked ``[L, ...]`` with matrices ``[in, out]`` (the JAX
tree's layout, so ``x @ w`` reads as there); the QKV product is one
fused ``[D, 3D]`` matrix, split q / k / v in that order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.attention import xla_attention
from ..ops.norms import layer_norm


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=128, dim=32, n_layers=2, n_heads=2,
                   ffn_dim=64, max_positions=64, dtype=torch.float32)

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()


def bert_init(config: BertConfig, generator: torch.Generator,
              device: str | torch.device) -> dict:
    """Random-init parameters drawn from ``generator`` (on the
    generator's device) and placed on ``device``; the JAX ``bert_init``'s
    scales: N(0, 1/fan_in) matrices, N(0, 0.02²) embeddings, unit norms,
    zero biases."""
    c = config
    L = c.n_layers
    gdev = generator.device

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * std
        return x.to(device=device, dtype=c.dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=c.dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=c.dtype)

    return {
        "word_embed": normal((c.vocab_size, c.dim), 0.02),
        "pos_embed": normal((c.max_positions, c.dim), 0.02),
        "type_embed": normal((c.type_vocab, c.dim), 0.02),
        "embed_ln_w": ones((c.dim,)),
        "embed_ln_b": zeros((c.dim,)),
        "layers": {
            "wqkv": normal((L, c.dim, 3 * c.dim), c.dim ** -0.5),
            "wqkv_b": zeros((L, 3 * c.dim)),
            "wo": normal((L, c.dim, c.dim), c.dim ** -0.5),
            "wo_b": zeros((L, c.dim)),
            "ln1_w": ones((L, c.dim)),
            "ln1_b": zeros((L, c.dim)),
            "w1": normal((L, c.dim, c.ffn_dim), c.dim ** -0.5),
            "w1_b": zeros((L, c.ffn_dim)),
            "w2": normal((L, c.ffn_dim, c.dim), c.ffn_dim ** -0.5),
            "w2_b": zeros((L, c.dim)),
            "ln2_w": ones((L, c.dim)),
            "ln2_b": zeros((L, c.dim)),
        },
        "pooler_w": normal((c.dim, c.dim), c.dim ** -0.5),
        "pooler_b": zeros((c.dim,)),
    }


def unstack(layers: dict, n_layers: int) -> list[dict]:
    """Stacked ``[L, ...]`` layer weights -> one dict of views a layer."""
    return [{k: v[i] for k, v in layers.items()} for i in range(n_layers)]


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ids past the table clamped to its last row, as
    JAX's gather clamps them (a byte tokenizer's specials index past a
    small test vocabulary)."""
    return table[ids.clamp(0, table.shape[0] - 1)]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default: the tanh approximation
    return F.gelu(x, approximate="tanh")


def bert_encode(params: dict, tokens: torch.Tensor, config: BertConfig, *,
                attention_mask: torch.Tensor | None = None,
                token_types: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (hidden [B, S, D], pooled [B, D]).

    ``attention_mask`` [B, S] (1 = a token) is taken as right padding:
    each row attends its first ``mask.sum()`` positions."""
    c = config
    b, s = tokens.shape
    dev = tokens.device
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    if token_types is None:
        token_types = torch.zeros((b, s), dtype=torch.int64, device=dev)

    x = (_rows(params["word_embed"], tokens)
         + _rows(params["pos_embed"], torch.arange(s, device=dev))[None]
         + _rows(params["type_embed"], token_types))
    x = layer_norm(x, params["embed_ln_w"], params["embed_ln_b"], c.norm_eps)

    lengths = attention_mask.sum(dim=-1).to(torch.int32)
    for lp in unstack(params["layers"], c.n_layers):
        qkv = x @ lp["wqkv"] + lp["wqkv_b"]
        q, k, v = (t.reshape(b, s, c.n_heads, c.head_dim)
                   for t in qkv.split(c.dim, dim=-1))
        attn = xla_attention(q, k, v, causal=False, kv_lengths=lengths)
        attn = attn.reshape(b, s, c.dim) @ lp["wo"] + lp["wo_b"]
        x = layer_norm(x + attn, lp["ln1_w"], lp["ln1_b"], c.norm_eps)
        h = _gelu((x @ lp["w1"] + lp["w1_b"]).float())
        h = h.to(x.dtype) @ lp["w2"] + lp["w2_b"]
        x = layer_norm(x + h, lp["ln2_w"], lp["ln2_b"], c.norm_eps)

    pooled = torch.tanh((x[:, 0] @ params["pooler_w"] + params["pooler_b"])
                        .float()).to(c.dtype)
    return x, pooled


def mean_pool_embed(hidden: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling -> float32 L2-normalised sentence embeddings
    [B, D]."""
    mask = attention_mask[..., None].float()
    summed = (hidden.float() * mask).sum(dim=1)
    counts = torch.clamp(mask.sum(dim=1), min=1.0)
    emb = summed / counts
    return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                             min=1e-9)


def param_count(params: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else param_count(v)
               for v in params.values())
