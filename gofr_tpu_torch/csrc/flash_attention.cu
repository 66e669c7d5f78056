// Causal flash prefill attention for Hopper (sm_90a): the bf16 wgmma
// kernel at head dims 64 and 128 below, and attn_simt.cuh's float32
// kernel for every other head dim and for float16 and float32.
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
// With causal masking a row sees S/2 columns on average. At the serve
// path's widest prefill bucket (P = 1, S = 1024, Llama-3.2-1B: Hq 32,
// Hkv 8, D 64) that is ~4.3 GFLOP (4.3 µs at 989 TFLOP/s bf16) against
// ~10.5 MB of q, out, K and V (3.1 µs at 3.35 TB/s): bound by the tensor
// cores, by a little; at S = 512 and below it is bound by HBM, where the
// kernel has to stream q/out at full rate. The design:
//   - the q tile is 64 rows of one head (one block = one warpgroup per
//     (q head, batch row, q tile)), exactly the M of wgmma.m64nNk16.
//     Packing the group's heads into the tile, as the paged chunk kernel
//     does, would read the same K/V tiles the same number of times
//     (64 / group positions x group heads walk as far as 64 positions of
//     one head do), so the simpler causal tile is kept; at S = 1024 it is
//     16 q tiles x 32 heads = 512 blocks, and 4 share an SM at hd 64;
//   - both products on the warpgroup core of wgmma_attn.cuh: S = Q K^T
//     with Q and K from shared memory, O += P V with P from registers
//     (the S accumulator re-packed) and V read MN-major from its
//     row-major tile, so V is never transposed;
//   - Q, K and V reach the 128-byte-swizzled tiles wgmma reads through
//     16-byte cp.async (each copy writes chunk c of row r at chunk
//     c ^ (r & 7)); the K/V tiles are double buffered, tile j + 1 in
//     flight while tile j is multiplied, one block barrier a tile, and
//     rows at or past
//     kv_lengths[b] are zero-filled by the copy itself (no read);
//   - the KV walk stops after the tile holding kv_lengths[b] - 1: later
//     columns are masked for every row (p = 0 exactly), so this changes
//     no result for kv_len >= 1. (A kv_len == 0 row visits no tile and
//     writes 0 — the engine never prefills such a row.) The q tiles run
//     last-first, so the longest causal walks start first.
// What bounds it now: instruction issue, as in the paged chunk kernel
// whose tile loop it shares (softmax, then the 16 B-per-thread copies,
// then the two products' latency), with the overlap coming only from the
// other blocks on the SM — no producer warp, no cross-tile overlap of S
// with the softmax — and at P = 1, S = 1024 the causal walks' tail: the
// last q tile walks 15-16 tiles while most blocks have finished.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_simt.cuh"
#include "paged_common.cuh"
#include "wgmma_attn.cuh"

namespace {

using wgattn::BK;
using wgattn::NTHREADS;
using wgattn::ROWS;
using wgattn::STAGES;
using wgattn::swz;

// Shared memory: swizzled [64][D] bf16 tiles — Q, then stage s's K and
// V at tiles 1 + 2 s and 2 + 2 s — plus the alignment slack.
template <int D>
constexpr size_t smem_bytes() {
  return (1 + 2 * STAGES) * (size_t)BK * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 2)
flash_fwd(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const int* __restrict__ kv_lengths,
          __nv_bfloat16* __restrict__ out,
          int Sq, int Skv, int Hq, int Hkv, float scale) {
  constexpr int CPR = D / 8;                  // 16-byte chunks per row
  constexpr int PER = BK * CPR / NTHREADS;    // loads per thread per side
  constexpr int NH = D / 64;                  // 64-column blocks of O
  constexpr size_t TILE = (size_t)BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = wgattn::align1024(smem_raw);
  auto tile = [&](int i) { return smem + (size_t)i * TILE; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = (int)gridDim.z - 1 - (int)blockIdx.z;   // longest walks first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = qt * ROWS;
  const int kv_len = min(max(kv_lengths[b], 0), Skv);

  const size_t q_rs = (size_t)Hq * D;     // row stride of q / out
  const size_t kv_rs = (size_t)Hkv * D;   // row stride of k / v
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_rs + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_rs + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_rs + (size_t)hk * D;

  // causal bound (no tile past the q tile) and length bound
  const int q_hi = min(q0 + ROWS, Sq);
  const int n_tiles = min((q_hi + BK - 1) / BK, (kv_len + BK - 1) / BK);

  // issue the copies of the K/V tile at c0 into stage st
  auto issue = [&](int c0, int st) {
#pragma unroll
    for (int kk = 0; kk < PER; ++kk) {
      const int i = tid + kk * NTHREADS, r = i / CPR, c = i % CPR;
      const bool ok = c0 + r < kv_len;
      const size_t off = ok ? (size_t)(c0 + r) * kv_rs + c * 8 : 0;
      cp_async16(tile(1 + 2 * st) + swz(r, c), kb + off, ok ? 16 : 0);
      cp_async16(tile(2 + 2 * st) + swz(r, c), vb + off, ok ? 16 : 0);
    }
  };

  // stage the Q tile (rows past Sq as zeros), and the walk's first tile
  for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = q0 + r < Sq;
    cp_async16(tile(0) + swz(r, c), ok ? qb + (size_t)(q0 + r) * q_rs + c * 8 : qb,
               ok ? 16 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {   // one commit group per tile
    if (t < n_tiles) issue(t * BK, t);
    cp_async_commit();
  }

  float o[NH][8][4], s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = 0.f;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) o[hh][n][e] = 0.f;
    }
  }
  float m[2] = {wgattn::NEG_INF, wgattn::NEG_INF};
  float l[2] = {0.f, 0.f};
  const float lg2 = scale * wgattn::LOG2E;
  const int row0 = q0 + warp * 16 + gid;   // rows of e = 0, 1 (and + 8: e = 2, 3)

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    cp_async_wait<STAGES - 2>();
    wgattn::fence_proxy_async();
    // tile j (and the Q tile) staged by every thread, and every warp done
    // with tile j - 1, whose stage takes tile j + STAGES - 1
    __syncthreads();
    if (j + STAGES - 1 < n_tiles)
      issue((j + STAGES - 1) * BK, (st + STAGES - 1) % STAGES);
    cp_async_commit();

    wgattn::qk<D>(s, tile(0), tile(1 + 2 * st));

    // visible: col <= row and col < kv_len; a tile wholly below the q
    // tile's first row and kv_len is seen in full (no test, no masking)
    const int c0 = j * BK;
    auto lg = [&](int) { return lg2; };
    auto pw = [](int) { return 1.f; };
    uint32_t pa[4][4];
    if (c0 + BK <= min(q0 + 1, kv_len)) {
      wgattn::softmax_tile<true>(s, 0u, lg, pw, m, l, o, pa);
    } else {
      uint32_t vis = 0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + tig * 2 + (e & 1);
          if (col <= row0 + 8 * (e >> 1) && col < kv_len) vis |= 1u << (4 * n + e);
        }
      wgattn::softmax_tile<false>(s, vis, lg, pw, m, l, o, pa);
    }
    wgattn::pv<D>(o, pa, tile(2 + 2 * st));
  }
  cp_async_wait<0>();

  wgattn::reduce_rows(l);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int row = row0 + 8 * t;
    if (row >= Sq) continue;
    const float inv = l[t] > 0.f ? 1.f / l[t] : 0.f;
    __nv_bfloat16* orow = out + (size_t)b * Sq * q_rs + (size_t)row * q_rs
                        + (size_t)h * D;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + hh * 64 + n * 8 + tig * 2) =
            wgattn::pack_bf16x2(o[hh][n][2 * t] * inv, o[hh][n][2 * t + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* kv_lengths,
           void* out, int B, int Sq, int Skv, int Hq, int Hkv, float scale,
           cudaStream_t s) {
  const dim3 grid(Hq, B, (Sq + ROWS - 1) / ROWS);
  return launch_split(flash_fwd<D>, grid, NTHREADS, smem_bytes<D>(), 1, s,
                      static_cast<const __nv_bfloat16*>(q),
                      static_cast<const __nv_bfloat16*>(k),
                      static_cast<const __nv_bfloat16*>(v), kv_lengths,
                      static_cast<__nv_bfloat16*>(out), Sq, Skv, Hq, Hkv,
                      scale);
}

}  // namespace

// C interface (bound with ctypes). All tensors contiguous, of the
// activation type `dtype` (0 bf16, 1 float16, 2 float32) except
// kv_lengths (int32 [B]); `stream` is a cudaStream_t. bf16 at D = 64 or
// 128 runs the wgmma kernel above; every other type and head dim (a
// multiple of 4 from 16 to 256) the float32 kernel of attn_simt.cuh.
// Returns the launch's cudaError_t (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const int* kv_lengths, void* out,
                                    int B, int Sq, int Skv, int Hq, int Hkv,
                                    int D, int dtype, float scale,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || (Sq + ROWS - 1) / ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == simt::BF16 && D == 64)
    return launch<64>(q, k, v, kv_lengths, out, B, Sq, Skv, Hq, Hkv, scale, s);
  if (dtype == simt::BF16 && D == 128)
    return launch<128>(q, k, v, kv_lengths, out, B, Sq, Skv, Hq, Hkv, scale, s);
  simt::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.len_a = kv_lengths;
  a.out = out;
  a.B = B;
  a.Sq = Sq;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.Skv = Skv;
  a.mode = simt::FLASH;
  a.scale = scale;
  return simt::run<false>(a, dtype, s);
}
