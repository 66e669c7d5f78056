// Causal flash prefill attention for Hopper (sm_90a): the wgmma kernel
// below for bf16 and float16 at every head dim the kernels take (a
// multiple of 4 from 16 to 256), and attn_simt.cuh's float32 kernel for
// float32 (kept in float32: TF32 is not JAX's float32).
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
//     16 q tiles x 32 heads = 512 blocks, and 4 share an SM at hd 64.
//     The grid runs over every q head, so no group is too wide;
//   - both products on the warpgroup core of wgmma_attn.cuh in the
//     activations' 16-bit type: S = Q K^T with Q and K from shared
//     memory, O += P V with P from registers (the S accumulator re-packed,
//     P rounded to that type) and V read MN-major from its row-major
//     tile, so V is never transposed. A head dim that is not a multiple
//     of 64 is staged at DP, the next multiple (100 -> 128): zero columns
//     of Q and K leave S as it is, V's extra output columns are never
//     stored, and HBM reads only the D real columns;
//   - Q, K and V reach the 128-byte-swizzled tiles wgmma reads through
//     cp.async (each copy writes chunk c of row r at chunk c ^ (r & 7)),
//     16 bytes a copy, or 8 where a row's bytes are not a multiple of 16
//     (D 100: 200 bytes), columns past D zero-filled by the copy itself;
//     the K/V tiles are double buffered, tile j + 1 in flight while tile
//     j is multiplied, one block barrier a tile, and rows at or past
//     kv_lengths[b] are zero-filled by the copy itself (no read);
//   - the KV walk stops after the tile holding kv_lengths[b] - 1: later
//     columns are masked for every row (p = 0 exactly), so this changes
//     no result for kv_len >= 1. (A kv_len == 0 row visits no tile and
//     writes 0 — the engine never prefills such a row.) The q tiles run
//     last-first, so the longest causal walks start first.
// What bounds it now: instruction issue, as in the paged chunk kernel
// whose tile loop it shares (softmax, then the copies, then the two
// products' latency), with the overlap coming only from the other blocks
// on the SM — no producer warp, no cross-tile overlap of S with the
// softmax — and at P = 1, S = 1024 the causal walks' tail: the last q
// tile walks 15-16 tiles while most blocks have finished.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "act_types.cuh"
#include "attn_simt.cuh"
#include "paged_common.cuh"
#include "wgmma_attn.cuh"

namespace {

using wgattn::BK;
using wgattn::NTHREADS;
using wgattn::ROWS;
using wgattn::STAGES;
using wgattn::swz;

// Shared memory: swizzled [64][DP] 16-bit tiles — Q, then stage s's K
// and V at tiles 1 + 2 s and 2 + 2 s — plus the alignment slack.
template <int DP>
constexpr size_t smem_bytes() {
  return (1 + 2 * STAGES) * (size_t)BK * DP * 2 + 1024;
}

// The copies of a [64][DP] tile's rows 0 .. 63 at `src` + row * stride
// (row r live iff r < n_rows) into the swizzled tile `dst`, VEC bytes a
// copy: PW copies cover a staged row, those past D are zero-filled, and
// so is every column of a row that is not live.
template <int VEC, int DP, typename T>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const T* src,
                                           size_t stride, int n_rows, int D) {
  constexpr int PW = DP * 2 / VEC, EPV = VEC / 2;
  const int np = D / EPV;
  wgattn::for_each<BK * PW / NTHREADS, DP <= 128>([&](int k) {
    const int i = threadIdx.x + k * NTHREADS, r = i / PW, p = i % PW;
    const bool ok = r < n_rows && p < np;
    cp_async_vec(dst + swz(r, p * VEC / 16) + p * VEC % 16,
                 ok ? src + (size_t)r * stride + p * EPV : src, VEC,
                 ok ? VEC : 0);
  });
}

// d_in (<= DP): the call's head dim; vec_in: the bytes of one staging
// copy. EXACT: d_in is DP and the copies are 16 bytes, both fixed when
// compiled (the 16-bit types at D 64 / 128: the kernel as it was before it
// took other head dims).
template <typename T, int DP, bool EXACT>
__global__ void __launch_bounds__(NTHREADS, DP == 64 ? 3 : DP == 128 ? 2 : 1)
flash_fwd(const T* __restrict__ q,
          const T* __restrict__ k,
          const T* __restrict__ v,
          const int* __restrict__ kv_lengths,
          T* __restrict__ out,
          int Sq, int Skv, int Hq, int Hkv, int d_in, int vec_in, float scale) {
  const int D = EXACT ? DP : d_in;
  const int vec = EXACT ? 16 : vec_in;
  constexpr int NH = DP / 64;                 // 64-column blocks of O
  constexpr size_t TILE = (size_t)BK * DP * 2;
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
  const T* qb = q + (size_t)b * Sq * q_rs + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_rs + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * kv_rs + (size_t)hk * D;

  // causal bound (no tile past the q tile) and length bound
  const int q_hi = min(q0 + ROWS, Sq);
  const int n_tiles = min((q_hi + BK - 1) / BK, (kv_len + BK - 1) / BK);

  // issue the copies of the K/V tile at c0 into stage st
  auto issue = [&](int c0, int st) {
    const int n = kv_len - c0;
    if (vec == 16) {
      stage_tile<16, DP>(tile(1 + 2 * st), kb + c0 * kv_rs, kv_rs, n, D);
      stage_tile<16, DP>(tile(2 + 2 * st), vb + c0 * kv_rs, kv_rs, n, D);
    } else {
      stage_tile<8, DP>(tile(1 + 2 * st), kb + c0 * kv_rs, kv_rs, n, D);
      stage_tile<8, DP>(tile(2 + 2 * st), vb + c0 * kv_rs, kv_rs, n, D);
    }
  };

  // stage the Q tile (rows past Sq as zeros), and the walk's first tile
  if (vec == 16)
    stage_tile<16, DP>(tile(0), qb + q0 * q_rs, q_rs, Sq - q0, D);
  else
    stage_tile<8, DP>(tile(0), qb + q0 * q_rs, q_rs, Sq - q0, D);
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

    wgattn::qk<T, DP>(s, tile(0), tile(1 + 2 * st));

    // visible: col <= row and col < kv_len; a tile wholly below the q
    // tile's first row and kv_len is seen in full (no test, no masking)
    const int c0 = j * BK;
    auto lg = [&](int) { return lg2; };
    auto pw = [](int) { return 1.f; };
    uint32_t pa[4][4];
    if (c0 + BK <= min(q0 + 1, kv_len)) {
      wgattn::softmax_tile<T, true>(s, 0u, lg, pw, m, l, o, pa);
    } else {
      uint32_t vis = 0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + tig * 2 + (e & 1);
          if (col <= row0 + 8 * (e >> 1) && col < kv_len) vis |= 1u << (4 * n + e);
        }
      wgattn::softmax_tile<T, false>(s, vis, lg, pw, m, l, o, pa);
    }
    wgattn::pv<T, DP>(o, pa, tile(2 + 2 * st));
  }
  cp_async_wait<0>();

  wgattn::reduce_rows(l);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int row = row0 + 8 * t;
    if (row >= Sq) continue;
    const float inv = l[t] > 0.f ? 1.f / l[t] : 0.f;
    T* orow = out + (size_t)b * Sq * q_rs + (size_t)row * q_rs + (size_t)h * D;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = hh * 64 + n * 8 + tig * 2;
        if (d < D)
          *reinterpret_cast<uint32_t*>(orow + d) = wgattn::pack2<T>(
              o[hh][n][2 * t] * inv, o[hh][n][2 * t + 1] * inv);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const int* kv_lengths,
           void* out, int B, int Sq, int Skv, int Hq, int Hkv, int D, int vec,
           float scale, cudaStream_t s) {
  const dim3 grid(Hq, B, (Sq + ROWS - 1) / ROWS);
  auto go = [&](auto kernel) {
    return launch_split(kernel, grid, NTHREADS, smem_bytes<DP>(), 1, s,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), kv_lengths,
                        static_cast<T*>(out), Sq, Skv, Hq, Hkv, D, vec, scale);
  };
  if constexpr (DP <= 128)
    if (D == DP && vec == 16) return go(flash_fwd<T, DP, true>);
  return go(flash_fwd<T, DP, false>);
}

// the head-dim class: D rounded up to a multiple of 64
template <typename T>
int launch_dim(const void* q, const void* k, const void* v,
               const int* kv_lengths, void* out, int B, int Sq, int Skv,
               int Hq, int Hkv, int D, int vec, float scale, cudaStream_t s) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, kv_lengths, out, B, Sq, Skv, Hq, Hkv, D, vec,
                         scale, s);
  if (D <= 128)
    return launch<T, 128>(q, k, v, kv_lengths, out, B, Sq, Skv, Hq, Hkv, D,
                          vec, scale, s);
  if (D <= 192)
    return launch<T, 192>(q, k, v, kv_lengths, out, B, Sq, Skv, Hq, Hkv, D,
                          vec, scale, s);
  return launch<T, 256>(q, k, v, kv_lengths, out, B, Sq, Skv, Hq, Hkv, D, vec,
                        scale, s);
}

}  // namespace

// C interface (bound with ctypes). All tensors contiguous, of the
// activation type `dtype` (0 bf16, 1 float16, 2 float32) except
// kv_lengths (int32 [B]), aligned to four elements; `stream` is a
// cudaStream_t. D: a multiple of 4 from 16 to 256. bf16 and float16 run
// the wgmma kernel above; float32 the float32 kernel of attn_simt.cuh.
// Returns the launch's cudaError_t (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const int* kv_lengths, void* out,
                                    int B, int Sq, int Skv, int Hq, int Hkv,
                                    int D, int dtype, float scale,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
      B > 65535 || (Sq + ROWS - 1) / ROWS > 65535 ||
      D < 16 || D > 256 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == act::F32) {
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
    return simt::run<false>(a, s);
  }
  const int vec = copy_width(D * 2, {q, k, v, out});
  if (vec < 8) return (int)cudaErrorInvalidValue;
  if (dtype == act::BF16)
    return launch_dim<__nv_bfloat16>(q, k, v, kv_lengths, out, B, Sq, Skv, Hq,
                                     Hkv, D, vec, scale, s);
  if (dtype == act::F16)
    return launch_dim<__half>(q, k, v, kv_lengths, out, B, Sq, Skv, Hq, Hkv,
                              D, vec, scale, s);
  return (int)cudaErrorInvalidValue;
}
