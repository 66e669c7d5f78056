#!/usr/bin/env python3
"""The encoders' eager hot paths with two versions of the port's plain
attention ops, in one process on one CUDA GPU.

    python3 scripts/torch_encoder_hostsync.py --parent <checkout>

``<checkout>`` holds another tree of the repository (e.g. the parent's,
unpacked with ``git archive`` under the git-ignored ``build/``): its
``gofr_tpu_torch/ops/attention.py`` is loaded beside this tree's, and
the Whisper and BERT modules are pointed at one or the other in turns
(parent, change, change, parent). Times: a Whisper-large-v3 decode step
at batch 8 (``_decoder_step_kv``, 32 layers, cross K/V over 1500 frames,
random bf16 weights from seed 0), a BERT-base encode at 32 x 128 and at
1 x 128; ``chip_smoke.time_ms`` (CUDA events around each call, host
launches included), then the device ms of the change
(``chip_smoke.device_ms``). One JSON line, led by the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="checkout whose ops/attention.py is the parent's")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from gofr_tpu_torch.device import resolve_device
    from gofr_tpu_torch.models import bert
    from gofr_tpu_torch.models import whisper as W
    from gofr_tpu_torch.ops import attention as change

    spec = importlib.util.spec_from_file_location(
        "parent_attention",
        Path(args.parent) / "gofr_tpu_torch" / "ops" / "attention.py")
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    dev = resolve_device("cuda")

    def use(mod) -> None:
        W.xla_attention, W.decode_attention = (mod.xla_attention,
                                               mod.decode_attention)
        bert.xla_attention = mod.xla_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = W.WhisperConfig.whisper_large_v3()
    params = W.whisper_init(cfg, gen, dev)
    bcfg = bert.BertConfig.base()
    bparams = bert.bert_init(bcfg, gen, dev)
    out = {"card": cs.phase_env()[0]}
    with torch.inference_mode():
        enc = torch.randn(8, cfg.audio_ctx, cfg.dim, generator=gen,
                          device=dev).to(cfg.dtype)
        ck, cv = W.precompute_cross_kv(params, enc, cfg)
        shape = (cfg.n_text_layers, 8, 65, cfg.n_heads, cfg.head_dim)
        cache_k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        cache_v = torch.zeros_like(cache_k)
        layers = W.unstack(params["dec_layers"], cfg.n_text_layers)
        tok = torch.randint(0, cfg.vocab_size, (8,), generator=gen,
                            device=dev)
        lengths = torch.full((8,), 32, dtype=torch.int64, device=dev)
        ids = torch.randint(0, 260, (32, 128), generator=gen, device=dev)
        mask = torch.ones((32, 128), dtype=torch.int32, device=dev)
        cases = {
            "whisper_decode_step_b8": lambda: W._decoder_step_kv(
                params, tok, 33, ck, cv, cfg, cache_k, cache_v, lengths,
                layers),
            "bert_encode_32x128": lambda: bert.bert_encode(
                bparams, ids, bcfg, attention_mask=mask),
            "bert_encode_1x128": lambda: bert.bert_encode(
                bparams, ids[:1], bcfg, attention_mask=mask[:1]),
        }
        for name, fn in cases.items():
            res = {}
            for tag, mod in (("parent", parent), ("change", change),
                             ("change2", change), ("parent2", parent)):
                use(mod)
                res[tag] = cs.time_ms(fn, warmup=3, iters=15)
            use(change)
            res["device_ms"] = cs.device_ms(fn, warmup=2, iters=5)
            out[name] = res
    cs.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
