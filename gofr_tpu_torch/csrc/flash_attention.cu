// Causal flash prefill attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel gofr_tpu/ops/flash_attention.py
// `_flash_kernel` (wrapper `flash_attention`). It computes the same
// function: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] (the serving layout,
// read in place with strides — no transposed copies), query head h
// reads KV head h / (Hq / Hkv) (GQA without repeating K/V), the mask
// `col <= row && col < kv_lengths[b]`, float32 running max / sum /
// accumulator (online softmax), and the causal bound: KV tiles past the
// query tile are never visited. A row whose sum l is 0 writes 0.
//
// What bounds it on the H100: the two products per tile (Q K^T and
// P V), 4·D flops per visible (row, col) pair per head, against the q
// and out bytes (4·D per row per head; K/V are read once per KV head).
// With causal masking a row sees S/2 columns on average, so the work is
// about S/2 flops per byte: FLOP-bound on the tensor cores (989 TFLOP/s
// bf16 dense) from S ~ 600 up — the widest prefill bucket, 1024 — and
// byte-bound (3.35 TB/s) below, where the kernel has to stream q/out at
// full rate. The design puts both products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate), reads q and writes out
// exactly once, and keeps the softmax state in registers:
//   - one block of 4 warps per (64-row q tile, q head, batch row);
//     each warp owns 16 q rows, its Q fragments stay in registers;
//   - K and V tiles of 64 rows are staged in shared memory (V stored
//     transposed so a B fragment is one 32-bit load), rows padded by 8
//     so the fragment loads are free of bank conflicts;
//   - the S accumulator fragment is re-packed in registers as the A
//     fragment of P V (the FlashAttention-2 layout trick);
//   - the KV loop also stops after the tile holding kv_lengths[b] - 1:
//     later columns are masked for every row (p = 0 exactly), so this
//     changes no result for kv_len >= 1. (A kv_len == 0 row visits no
//     tile and writes 0 — the engine never prefills such a row.)
// Not yet: wgmma, TMA, a multi-stage cp.async pipeline, warp
// specialisation — the later work that takes it toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;       // q rows per block: 4 warps x 16 rows
constexpr int BK = 64;       // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const int* __restrict__ kv_lengths,
          __nv_bfloat16* __restrict__ out,
          int Sq, int Skv, int Hq, int Hkv, float scale) {
  constexpr int KP = D + 8;    // padded row stride of the Q/K tile
  constexpr int VP = BK + 8;   // padded row stride of the transposed V tile
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  constexpr int KC = D / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;   // n-tiles of S
  constexpr int NO = D / 8;    // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[BK * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = qt * BQ;
  const int kv_len = min(max(kv_lengths[b], 0), Skv);

  const size_t q_rs = (size_t)Hq * D;     // row stride of q / out
  const size_t kv_rs = (size_t)Hkv * D;   // row stride of k / v
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_rs + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_rs + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_rs + (size_t)hk * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // stage the Q tile through the K buffer, keep its A fragments
  for (int i = tid; i < BQ * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    uint4 val = zero;
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_rs + c * 8);
    *reinterpret_cast<uint4*>(&ks[r * KP + c * 8]) = val;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int col = kc * 16 + tig * 2;
    qa[kc][0] = ld_u32(&ks[(wr + gid) * KP + col]);
    qa[kc][1] = ld_u32(&ks[(wr + gid + 8) * KP + col]);
    qa[kc][2] = ld_u32(&ks[(wr + gid) * KP + col + 8]);
    qa[kc][3] = ld_u32(&ks[(wr + gid + 8) * KP + col + 8]);
  }
  __syncthreads();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  const int row0 = q0 + wr + gid;   // rows of c0,c1 (and +8 for c2,c3)
  const int row1 = row0 + 8;

  // causal bound (no tile past the q tile) and length bound
  const int q_hi = min(q0 + BQ, Sq);
  int n_tiles = min((Skv + BK - 1) / BK, (q_hi + BK - 1) / BK);
  n_tiles = min(n_tiles, (kv_len + BK - 1) / BK);

  for (int j = 0; j < n_tiles; ++j) {
    const int c0 = j * BK;
    for (int i = tid; i < BK * CPR; i += NTHREADS) {
      const int r = i / CPR, c = i % CPR;
      uint4 kval = zero, vval = zero;
      if (c0 + r < Skv) {
        kval = *reinterpret_cast<const uint4*>(kb + (size_t)(c0 + r) * kv_rs + c * 8);
        vval = *reinterpret_cast<const uint4*>(vb + (size_t)(c0 + r) * kv_rs + c * 8);
      }
      *reinterpret_cast<uint4*>(&ks[r * KP + c * 8]) = kval;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c * 8 + e) * VP + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 columns
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kr = &ks[(n * 8 + gid) * KP + kc * 16 + tig * 2];
        mma_16816(s[n], qa[kc], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // mask, then the online-softmax update (rows row0 / row1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + tig * 2 + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        const bool ok = (col <= row) && (col < kv_len);
        const float val = ok ? s[n][e] * scale : NEG_INF;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
    // l stays a per-thread partial sum (the quad shares m and alpha);
    // the quad reduction happens once, after the loop
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // O += P V: the S fragments re-packed as A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vr = &vt[(n * 8 + gid) * VP + kk * 16 + tig * 2];
        mma_16816(o[n], pa, ld_u32(vr), ld_u32(vr + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + tig * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(out + (size_t)b * Sq * q_rs + (size_t)row0 * q_rs
                                   + (size_t)h * D + d) =
          pack_bf16x2(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(out + (size_t)b * Sq * q_rs + (size_t)row1 * q_rs
                                   + (size_t)h * D + d) =
          pack_bf16x2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

// C interface (bound with ctypes). All tensors contiguous, bf16 except
// kv_lengths (int32 [B]); `stream` is a cudaStream_t. Returns the
// launch's cudaError_t (0 = launched), or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const int* kv_lengths, void* out,
                                    int B, int Sq, int Skv, int Hq, int Hkv,
                                    int D, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const dim3 block(NTHREADS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64)
    flash_fwd<64><<<grid, block, 0, s>>>(qp, kp, vp, kv_lengths, op, Sq, Skv, Hq, Hkv, scale);
  else if (D == 128)
    flash_fwd<128><<<grid, block, 0, s>>>(qp, kp, vp, kv_lengths, op, Sq, Skv, Hq, Hkv, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
