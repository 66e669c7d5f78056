"""kv-quant-boundary, the torch twin of analysis_fixtures/kvquant_bad.py:
the same lines are flagged. Lines matter."""
import torch
import numpy as np

from gofr_tpu_torch.ops.paged_kv import (gather_view, rope_kv_write,
                                         scatter_chunk_kv, kv_write)


def fused_prefill(kc, vc, tables, k, v, kv_len, zeros):
    kc, vc = scatter_chunk_kv(kc, vc, tables, k.to(kc.dtype),  # L11: cast
                              v, zeros, kv_len)
    kc, vc = scatter_chunk_kv(kc, vc, tables, k,
                              v.bfloat16(),                    # L14: cast
                              zeros, kv_len)
    return kc, vc


def fused_chunk(kp, vp, tables, offsets, q, positions):
    k_view = gather_view(kp, tables)
    q = rope_kv_write(q, kp, vp, tables,
                      k_view.to(dtype=torch.bfloat16), positions)  # L22
    kv_write(kp, tables, offsets, q)
    vp = vp.float()                                            # L24: pool cast
    return kp, vp, q


def debug_dump(pool, k_cache):
    host = pool["q"].cpu()                                     # L29: readback
    k_cache.numpy()                                            # L30: readback
    np.asarray(k_cache)                                        # L31: readback
    return host
