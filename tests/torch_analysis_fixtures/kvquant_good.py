"""kv-quant-boundary, the torch twin of analysis_fixtures/kvquant_good.py:
the writers own the pool representation — callers hand them raw rows
and read the pool back only through the gather."""
import torch

from gofr_tpu_torch.ops.paged_kv import (gather_view, rope_kv_write,
                                         scatter_chunk_kv)


def fused_prefill(kc, vc, tables, k, v, kv_len, zeros):
    # no cast at the boundary: the writer casts/quantizes on write
    return scatter_chunk_kv(kc, vc, tables, k, v, zeros, kv_len)


def fused_chunk(kp, vp, tables, q, positions, view_dtype):
    # the gather dequantizes to the model dtype; rows written back raw
    k_view = gather_view(kp, tables, view_dtype)
    q = rope_kv_write(q, kp, vp, tables, k_view, positions)
    return q, k_view.to(kp.device)


def sample_rows(k, kc):
    # casting NON-pool rows elsewhere is fine — only the pool and its
    # writer boundaries are protected
    return k.float(), k.to(torch.float32), kc.to("cuda:0")
