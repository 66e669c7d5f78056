// KV row writes for Hopper (sm_90a) into the head-major page pool, in
// the activation type (bf16, float16 or float32, the `dtype` argument of
// each entry) or int8 codes with a float32 scale per row. Three entries:
//
// - gofr_kv_write / _i8: one layer's new K and V rows as they are
//   (`pool_write` and the K-only `scatter_chunk` write through it);
// - gofr_rope_kv_write / _i8: the decode and chunk/verify steps' new
//   token: RoPE on q and k, the rotated q out, and K and V into the pool,
//   one launch a layer;
// - gofr_kv_write_slab / _i8: a prefill's K and V slabs for every layer
//   at once, one launch a prefill.
//
// Replaces no Pallas kernel. On the TPU the write is XLA's scatter, fused
// into the jitted step together with the RoPE in front of it
// (gofr_tpu/models/llama.py:336-339 decode, :518-521 chunk):
// gofr_tpu/ops/paged_kv.py `pool_write`, `pool.at[li, :, pids,
// offs].set(rows, mode="drop")`, and `scatter_chunk` for the prefill,
// with `quantize_rows` in front for the int8 pool. Row n (K and V, each
// [Hkv, hd] in the activation type) lands at page pids[n], offset offs[n] of every KV head
// of the layer [Hkv, Np, pg, hd]; a row whose page id is outside [0, Np)
// (or whose offset is outside [0, pg)) is dropped, here on the card, so
// the caller needs no host sync to select the rows in range (what the
// eager PyTorch version does with `nonzero`, and what a CUDA graph cannot
// hold). For the int8 pool each row is quantized on the way: scale =
// max(amax, 1e-8) / 127 with an IEEE division (__fdiv_rn), codes rint(x /
// scale) (round half to even, IEEE division) clipped to +-127 -- bit for
// bit the codes and scales of ops/paged_kv.py:quantize_rows, and so of
// the JAX package's.
//
// What bounds it on the H100: bytes, and at decode sizes the launch. A
// decode step writes B x Hkv x hd x 2 values a layer (8 KiB at B = 8 for
// Llama-3.2-1B): far below a microsecond of HBM time, so a write is only
// worth its launch when it takes the work around it. The eager RoPE
// (ops/rope.py:apply_rope) is 13 launches for q and 13 for k a layer; the
// rotated k goes nowhere but the pool and the rotated q straight into the
// attention kernel, so the fused entry does both rotations and the write
// in one launch (26 fewer a layer, 416 a Llama-3.2-1B decode step). Its
// arithmetic is the plain version's, operation for operation, so the two
// agree bit for bit: angle = float(pos) * inv_freq[i] (__fmul_rn),
// precise cosf / sinf, x1 cos - x2 sin and x2 cos + x1 sin with every
// product and sum rounded on its own (__fmul_rn / __fsub_rn / __fadd_rn:
// no FMA contraction; PyTorch rounds each in its own kernel), rounded to
// bf16 nearest-even; an int8 K row takes its amax over those bf16 values.
// One block per (row, group of 8 heads of q, k and v), one warp a head;
// the row's cos / sin are computed once per block into shared memory.
// At hd 64 lane l holds elements l and l + 32, exactly rotate-half's
// pair, so no shuffle moves data; hd 128 gives a lane two pairs.
//
// The prefill slab is [L, P, S, Hkv, hd] with P x S rows, most of them
// padding or dummy prompts (56 % at a group of 8 x 512 with 6 x 301
// real). The slab entry makes one launch for every layer: a grid sized
// to the card, each warp walking (row, layer) units with a stride, so a
// dropped row costs a warp two index loads and no block exists only to
// exit; a unit's K and V head rows move as 16-byte vectors (8 lanes a
// head row at hd 64), int8 rows reducing their amax over those lanes.
//
// Other head dims and types. The kernels above hold bf16 at their
// widths (the fused write at hd 64 and 128, the slab at powers of two);
// every other case -- float16 and float32 at any head dim, bf16 at a
// head dim such as 100 (OpenLLaMA-3B) -- runs a kernel of the same
// arithmetic written for any D (a multiple of 4 up to 256): the fused
// write with a lane looping over its pairs (rounding the rotated K row
// to the activation type before the int8 amax), the slab write one head
// row at a time with 4-element vectors, the per-layer write templated on
// the type. A float32 row is written as it is: nothing rounds.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_types.cuh"

namespace {

using act::BF16;
using act::F16;
using act::F32;
using act::from_f;
using act::to_f;

// x rounded to T (round to nearest even) and back: the value a tensor of
// type T holds
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// --------------------------------------------------- quantize, shared

// scale = max(amax, 1e-8) / 127 and the code of x under it: the
// arithmetic of quantize_rows, IEEE division and round half to even
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

__device__ __forceinline__ int8_t code_of(float x, float scale) {
  const float c = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(c, -127.0f), 127.0f));
}

// ------------------------------------------------------ per-layer write

template <typename T, bool QUANT>
__global__ void kv_write_kernel(const T* __restrict__ k_rows,
                                const T* __restrict__ v_rows,
                                const int* __restrict__ pids,
                                const int* __restrict__ offs, void* k_dst,
                                void* v_dst, float* k_scales,
                                float* v_scales, int Hkv, int n_pages,
                                int page, int D) {
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* src = warp == 0 ? k_rows : v_rows;
  if (src == nullptr) return;  // a K-only write
  const int pid = pids[n];
  const int off = offs[n];
  if (pid < 0 || pid >= n_pages || off < 0 || off >= page) return;
  const T* row = src + ((size_t)n * Hkv + h) * D;
  const size_t dst_row = ((size_t)h * n_pages + pid) * page + off;
  void* dst = warp == 0 ? k_dst : v_dst;
  if constexpr (!QUANT) {
    T* out = static_cast<T*>(dst) + dst_row * D;
    for (int i = lane; i < D; i += 32) out[i] = row[i];
  } else {
    float amax = 0.0f;
    for (int i = lane; i < D; i += 32)
      amax = fmaxf(amax, fabsf(to_f(row[i])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = row_scale(amax);
    int8_t* out = static_cast<int8_t*>(dst) + dst_row * D;
    for (int i = lane; i < D; i += 32)
      out[i] = code_of(to_f(row[i]), scale);
    if (lane == 0) (warp == 0 ? k_scales : v_scales)[dst_row] = scale;
  }
}

template <typename T, bool QUANT>
int launch_t(const void* k_rows, const void* v_rows, const int* pids,
             const int* offs, void* k_dst, void* v_dst, float* k_scales,
             float* v_scales, int N, int Hkv, int n_pages, int page, int D,
             void* stream) {
  kv_write_kernel<T, QUANT><<<dim3(N, Hkv), 64, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(k_rows), static_cast<const T*>(v_rows), pids,
      offs, k_dst, v_dst, k_scales, v_scales, Hkv, n_pages, page, D);
  return (int)cudaGetLastError();
}

template <bool QUANT>
int launch(const void* k_rows, const void* v_rows, const int* pids,
           const int* offs, void* k_dst, void* v_dst, float* k_scales,
           float* v_scales, int N, int Hkv, int n_pages, int page, int D,
           int dtype, void* stream) {
  if (N <= 0) return 0;
  switch (dtype) {
    case BF16:
      return launch_t<__nv_bfloat16, QUANT>(k_rows, v_rows, pids, offs, k_dst,
                                            v_dst, k_scales, v_scales, N, Hkv,
                                            n_pages, page, D, stream);
    case F16:
      return launch_t<__half, QUANT>(k_rows, v_rows, pids, offs, k_dst, v_dst,
                                     k_scales, v_scales, N, Hkv, n_pages, page,
                                     D, stream);
    case F32:
      return launch_t<float, QUANT>(k_rows, v_rows, pids, offs, k_dst, v_dst,
                                    k_scales, v_scales, N, Hkv, n_pages, page,
                                    D, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// --------------------------------------------------- fused RoPE + write

constexpr int kRopeWarps = 8;  // heads a block: one warp each

// (x1 cos - x2 sin, x2 cos + x1 sin), each product and sum rounded on
// its own as PyTorch's elementwise kernels round them
__device__ __forceinline__ void rotate(float x1, float x2, float c, float s,
                                       float& o1, float& o2) {
  o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Grid (N, ceil((Hq + 2 Hkv) / kRopeWarps)); warp w of block (n, g) takes
// head j = g kRopeWarps + w of row n: q heads first, then k, then v.
// Lane l holds pair p's elements (i, i + D/2), i = 32 p + l.
template <bool QUANT, int D>
__global__ void __launch_bounds__(kRopeWarps * 32)
    rope_kv_write_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ positions,
                         const float* __restrict__ inv_freq,
                         const int* __restrict__ pids,
                         const int* __restrict__ offs,
                         __nv_bfloat16* __restrict__ q_out, void* k_dst,
                         void* v_dst, float* k_scales, float* v_scales,
                         int Hq, int Hkv, int n_pages, int page) {
  constexpr int HALF = D / 2;
  constexpr int PAIRS = HALF / 32;
  __shared__ float s_cos[HALF], s_sin[HALF];
  const int n = blockIdx.x;
  const int first = blockIdx.y * kRopeWarps;
  const int pid = pids[n];
  const int off = offs[n];
  const bool keep = pid >= 0 && pid < n_pages && off >= 0 && off < page;
  if (!keep && first >= Hq) return;  // only K/V heads of a dropped row
  if (threadIdx.x < HALF) {
    const float angle =
        __fmul_rn(static_cast<float>(positions[n]), inv_freq[threadIdx.x]);
    s_cos[threadIdx.x] = cosf(angle);
    s_sin[threadIdx.x] = sinf(angle);
  }
  __syncthreads();
  const int j = first + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= Hq + 2 * Hkv) return;
  if (j < Hq) {  // q: rotated, out as bf16
    const size_t base = ((size_t)n * Hq + j) * D;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int i = 32 * p + lane;
      float o1, o2;
      rotate(__bfloat162float(q[base + i]),
             __bfloat162float(q[base + i + HALF]), s_cos[i], s_sin[i], o1,
             o2);
      q_out[base + i] = __float2bfloat16_rn(o1);
      q_out[base + i + HALF] = __float2bfloat16_rn(o2);
    }
    return;
  }
  if (!keep) return;
  const bool is_k = j < Hq + Hkv;
  const int h = j - Hq - (is_k ? 0 : Hkv);
  const __nv_bfloat16* row = (is_k ? k : v) + ((size_t)n * Hkv + h) * D;
  float x[2 * PAIRS];  // the row's values as the pool gets them (bf16)
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int i = 32 * p + lane;
    x[2 * p] = __bfloat162float(row[i]);
    x[2 * p + 1] = __bfloat162float(row[i + HALF]);
    if (is_k) {
      float o1, o2;
      rotate(x[2 * p], x[2 * p + 1], s_cos[i], s_sin[i], o1, o2);
      x[2 * p] = bf16_round(o1);
      x[2 * p + 1] = bf16_round(o2);
    }
  }
  const size_t dst_row = ((size_t)h * n_pages + pid) * page + off;
  if constexpr (!QUANT) {
    __nv_bfloat16* out =
        static_cast<__nv_bfloat16*>(is_k ? k_dst : v_dst) + dst_row * D;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      out[32 * p + lane] = __float2bfloat16_rn(x[2 * p]);
      out[32 * p + lane + HALF] = __float2bfloat16_rn(x[2 * p + 1]);
    }
  } else {
    float amax = 0.0f;
#pragma unroll
    for (int e = 0; e < 2 * PAIRS; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = row_scale(amax);
    int8_t* out = static_cast<int8_t*>(is_k ? k_dst : v_dst) + dst_row * D;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      out[32 * p + lane] = code_of(x[2 * p], scale);
      out[32 * p + lane + HALF] = code_of(x[2 * p + 1], scale);
    }
    if (lane == 0) (is_k ? k_scales : v_scales)[dst_row] = scale;
  }
}

// The same function at any even head dim D up to 256 (the wrappers take
// multiples of 4 from 16) and any activation type T: lane l holds the
// pairs (i, i + D/2) for i = l + 32 p, i < D/2, and the rotated K row is
// rounded to T before its amax is taken. The arithmetic is the bf16
// kernel's, operation for operation, so it matches the plain version
// bit for bit in every type (float32 rounds nothing).
constexpr int kRopeMaxPairs = 4;   // (D/2) / 32 at D = 256

template <typename T, bool QUANT>
__global__ void __launch_bounds__(kRopeWarps * 32)
    rope_kv_write_any(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ positions,
                      const float* __restrict__ inv_freq,
                      const int* __restrict__ pids,
                      const int* __restrict__ offs, T* __restrict__ q_out,
                      void* k_dst, void* v_dst, float* k_scales,
                      float* v_scales, int Hq, int Hkv, int n_pages, int page,
                      int D) {
  __shared__ float s_cos[kRopeMaxPairs * 32], s_sin[kRopeMaxPairs * 32];
  const int half = D / 2;
  const int n = blockIdx.x;
  const int first = blockIdx.y * kRopeWarps;
  const int pid = pids[n];
  const int off = offs[n];
  const bool keep = pid >= 0 && pid < n_pages && off >= 0 && off < page;
  if (!keep && first >= Hq) return;  // only K/V heads of a dropped row
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float angle = __fmul_rn(static_cast<float>(positions[n]), inv_freq[i]);
    s_cos[i] = cosf(angle);
    s_sin[i] = sinf(angle);
  }
  __syncthreads();
  const int j = first + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= Hq + 2 * Hkv) return;
  if (j < Hq) {  // q: rotated, out in T
    const size_t base = ((size_t)n * Hq + j) * D;
    for (int i = lane; i < half; i += 32) {
      float o1, o2;
      rotate(to_f(q[base + i]), to_f(q[base + i + half]), s_cos[i], s_sin[i],
             o1, o2);
      q_out[base + i] = from_f<T>(o1);
      q_out[base + i + half] = from_f<T>(o2);
    }
    return;
  }
  if (!keep) return;
  const bool is_k = j < Hq + Hkv;
  const int h = j - Hq - (is_k ? 0 : Hkv);
  const T* row = (is_k ? k : v) + ((size_t)n * Hkv + h) * D;
  float x[2 * kRopeMaxPairs];  // the row's values as the pool gets them
#pragma unroll
  for (int p = 0; p < kRopeMaxPairs; ++p) {
    const int i = 32 * p + lane;
    x[2 * p] = x[2 * p + 1] = 0.0f;
    if (i < half) {
      x[2 * p] = to_f(row[i]);
      x[2 * p + 1] = to_f(row[i + half]);
      if (is_k) {
        float o1, o2;
        rotate(x[2 * p], x[2 * p + 1], s_cos[i], s_sin[i], o1, o2);
        x[2 * p] = round_to<T>(o1);
        x[2 * p + 1] = round_to<T>(o2);
      }
    }
  }
  const size_t dst_row = ((size_t)h * n_pages + pid) * page + off;
  if constexpr (!QUANT) {
    T* out = static_cast<T*>(is_k ? k_dst : v_dst) + dst_row * D;
#pragma unroll
    for (int p = 0; p < kRopeMaxPairs; ++p) {
      const int i = 32 * p + lane;
      if (i < half) {
        out[i] = from_f<T>(x[2 * p]);
        out[i + half] = from_f<T>(x[2 * p + 1]);
      }
    }
  } else {
    float amax = 0.0f;   // lanes past the row hold zeros
#pragma unroll
    for (int e = 0; e < 2 * kRopeMaxPairs; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = row_scale(amax);
    int8_t* out = static_cast<int8_t*>(is_k ? k_dst : v_dst) + dst_row * D;
#pragma unroll
    for (int p = 0; p < kRopeMaxPairs; ++p) {
      const int i = 32 * p + lane;
      if (i < half) {
        out[i] = code_of(x[2 * p], scale);
        out[i + half] = code_of(x[2 * p + 1], scale);
      }
    }
    if (lane == 0) (is_k ? k_scales : v_scales)[dst_row] = scale;
  }
}

template <typename T, bool QUANT>
int launch_rope_any(const void* q, const void* k, const void* v,
                    const int* positions, const float* inv_freq,
                    const int* pids, const int* offs, void* q_out, void* k_dst,
                    void* v_dst, float* k_scales, float* v_scales, dim3 grid,
                    int Hq, int Hkv, int n_pages, int page, int D,
                    cudaStream_t s) {
  rope_kv_write_any<T, QUANT><<<grid, kRopeWarps * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), positions, inv_freq, pids, offs,
      static_cast<T*>(q_out), k_dst, v_dst, k_scales, v_scales, Hq, Hkv,
      n_pages, page, D);
  return (int)cudaGetLastError();
}

template <bool QUANT>
int launch_rope(const void* q, const void* k, const void* v,
                const int* positions, const float* inv_freq, const int* pids,
                const int* offs, void* q_out, void* k_dst, void* v_dst,
                float* k_scales, float* v_scales, int N, int Hq, int Hkv,
                int n_pages, int page, int D, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (D < 2 || D % 2 || D / 2 > kRopeMaxPairs * 32)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N, (Hq + 2 * Hkv + kRopeWarps - 1) / kRopeWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16 && (D == 64 || D == 128)) {
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(q_out);
    if (D == 64) {
      rope_kv_write_kernel<QUANT, 64><<<grid, kRopeWarps * 32, 0, s>>>(
          qb, kb, vb, positions, inv_freq, pids, offs, ob, k_dst, v_dst,
          k_scales, v_scales, Hq, Hkv, n_pages, page);
    } else {
      rope_kv_write_kernel<QUANT, 128><<<grid, kRopeWarps * 32, 0, s>>>(
          qb, kb, vb, positions, inv_freq, pids, offs, ob, k_dst, v_dst,
          k_scales, v_scales, Hq, Hkv, n_pages, page);
    }
    return (int)cudaGetLastError();
  }
#define GOFR_ROPE_ANY(T)                                                    \
  launch_rope_any<T, QUANT>(q, k, v, positions, inv_freq, pids, offs, q_out, \
                            k_dst, v_dst, k_scales, v_scales, grid, Hq, Hkv, \
                            n_pages, page, D, s)
  switch (dtype) {
    case BF16: return GOFR_ROPE_ANY(__nv_bfloat16);
    case F16: return GOFR_ROPE_ANY(__half);
    case F32: return GOFR_ROPE_ANY(float);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GOFR_ROPE_ANY
}

// ------------------------------------------------- prefill slab, all layers

constexpr int kSlabWarps = 8;
constexpr int kSlabBlocksPerSM = 8;

// 8 bf16 of a 16-byte vector as floats
__device__ __forceinline__ void unpack8(const uint4& w, float* x) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(
        &words[i]);
    x[2 * i] = __low2float(pair);
    x[2 * i + 1] = __high2float(pair);
  }
}

// A unit is (row r, layer l): K and V of every head, 2 Hkv head rows of
// LPR 16-byte vectors (LPR = D / 8 lanes a head row). Vector c < Hkv LPR
// is K's, the rest V's; both slabs hold a row's [Hkv, D] block
// contiguously, so a warp's loads are contiguous, and its stores are
// whole head rows.
template <bool QUANT, int LPR>
__global__ void __launch_bounds__(kSlabWarps * 32)
    kv_write_slab_kernel(const __nv_bfloat16* __restrict__ k_slab,
                         const __nv_bfloat16* __restrict__ v_slab,
                         const int* __restrict__ pids,
                         const int* __restrict__ offs, void* k_dst,
                         void* v_dst, float* k_scales, float* v_scales,
                         int L, int R, int Hkv, int n_pages, int page) {
  const int lane = threadIdx.x & 31;
  const int per_side = Hkv * LPR;      // vectors of one [Hkv, D] block
  const long long units = (long long)R * L;
  const long long stride = (long long)gridDim.x * kSlabWarps;
  for (long long u = (long long)blockIdx.x * kSlabWarps + (threadIdx.x >> 5);
       u < units; u += stride) {
    const int r = (int)(u / L);
    const int l = (int)(u - (long long)r * L);
    const int pid = __ldg(pids + r);
    const int off = __ldg(offs + r);
    if (pid < 0 || pid >= n_pages || off < 0 || off >= page) continue;
    const size_t src = ((size_t)l * R + r) * per_side;   // in vectors
    for (int c0 = 0; c0 < 2 * per_side; c0 += 32) {
      const int c = c0 + lane;
      const bool live = c < 2 * per_side;   // whole head rows: LPR | 32
      const bool is_k = c < per_side;
      const int cc = is_k ? c : c - per_side;
      const int h = cc / LPR;
      const int part = cc - h * LPR;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (live)
        w = __ldg(reinterpret_cast<const uint4*>(is_k ? k_slab : v_slab) +
                  src + cc);
      const size_t dst_row =
          (((size_t)l * Hkv + h) * n_pages + pid) * page + off;
      if constexpr (!QUANT) {
        if (live)
          reinterpret_cast<uint4*>(is_k ? k_dst : v_dst)[dst_row * LPR +
                                                         part] = w;
      } else {
        float x[8];
        unpack8(w, x);
        float amax = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        const float scale = row_scale(amax);
        if (live) {
          uint32_t packed[2] = {0, 0};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            packed[e >> 2] |= (uint32_t)(uint8_t)code_of(x[e], scale)
                              << (8 * (e & 3));
          reinterpret_cast<uint2*>(is_k ? k_dst : v_dst)[dst_row * LPR +
                                                         part] =
              make_uint2(packed[0], packed[1]);
          if (part == 0) (is_k ? k_scales : v_scales)[dst_row] = scale;
        }
      }
    }
  }
}

// The same write at any head dim D that is a multiple of 4 (up to 256)
// and any activation type T: a warp takes one head row of its unit at a
// time, each lane moving whole 4-element vectors (8 bytes of a 16-bit
// type, 16 of float32; int8 codes 4 bytes), an int8 row reducing its
// amax over the whole warp.
constexpr int kSlabMaxVecs = 2;   // 4-element vectors a lane holds: D <= 256

template <typename T>
struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__half> { using type = uint2; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

template <typename T, bool QUANT>
__global__ void __launch_bounds__(kSlabWarps * 32)
    kv_write_slab_any(const T* __restrict__ k_slab,
                      const T* __restrict__ v_slab,
                      const int* __restrict__ pids,
                      const int* __restrict__ offs, void* k_dst, void* v_dst,
                      float* k_scales, float* v_scales, int L, int R, int Hkv,
                      int n_pages, int page, int D) {
  using V = typename Vec4<T>::type;
  const int lane = threadIdx.x & 31;
  const int nv = D / 4;                // vectors of a head row
  const long long units = (long long)R * L;
  const long long stride = (long long)gridDim.x * kSlabWarps;
  for (long long u = (long long)blockIdx.x * kSlabWarps + (threadIdx.x >> 5);
       u < units; u += stride) {
    const int r = (int)(u / L);
    const int l = (int)(u - (long long)r * L);
    const int pid = __ldg(pids + r);
    const int off = __ldg(offs + r);
    if (pid < 0 || pid >= n_pages || off < 0 || off >= page) continue;
    for (int hr = 0; hr < 2 * Hkv; ++hr) {
      const bool is_k = hr < Hkv;
      const int h = is_k ? hr : hr - Hkv;
      const T* src = (is_k ? k_slab : v_slab) + (((size_t)l * R + r) * Hkv + h) * D;
      const size_t dst_row = (((size_t)l * Hkv + h) * n_pages + pid) * page + off;
      if constexpr (!QUANT) {
        V* dst = reinterpret_cast<V*>(static_cast<T*>(is_k ? k_dst : v_dst) +
                                      dst_row * D);
        for (int c = lane; c < nv; c += 32)
          dst[c] = reinterpret_cast<const V*>(src)[c];
      } else {
        float x[kSlabMaxVecs][4];
        float amax = 0.0f;
#pragma unroll
        for (int t = 0; t < kSlabMaxVecs; ++t) {
          const int c = lane + 32 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[t][e] = c < nv ? to_f(src[4 * c + e]) : 0.0f;
            amax = fmaxf(amax, fabsf(x[t][e]));
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        const float scale = row_scale(amax);
        int8_t* dst = static_cast<int8_t*>(is_k ? k_dst : v_dst) + dst_row * D;
#pragma unroll
        for (int t = 0; t < kSlabMaxVecs; ++t) {
          const int c = lane + 32 * t;
          if (c < nv) {
            uint32_t packed = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              packed |= (uint32_t)(uint8_t)code_of(x[t][e], scale) << (8 * e);
            reinterpret_cast<uint32_t*>(dst)[c] = packed;
          }
        }
        if (lane == 0) (is_k ? k_scales : v_scales)[dst_row] = scale;
      }
    }
  }
}

template <bool QUANT>
int launch_slab(const void* k_slab, const void* v_slab, const int* pids,
                const int* offs, void* k_dst, void* v_dst, float* k_scales,
                float* v_scales, int L, int R, int Hkv, int n_pages,
                int page, int D, int dtype, void* stream) {
  if (L <= 0 || R <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)R * L;
  const long long want = (units + kSlabWarps - 1) / kSlabWarps;
  const int blocks =
      (int)(want < (long long)sms * kSlabBlocksPerSM
                ? want
                : (long long)sms * kSlabBlocksPerSM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pow2 = D >= 8 && D <= 256 && (D & (D - 1)) == 0;
  if (dtype != BF16 || !pow2) {
    // every other type and head dim: a multiple of 4 up to 256
    if (D < 4 || D % 4 || D > 4 * 32 * kSlabMaxVecs)
      return (int)cudaErrorInvalidValue;
#define GOFR_SLAB_ANY(T)                                                   \
  kv_write_slab_any<T, QUANT><<<blocks, kSlabWarps * 32, 0, s>>>(          \
      static_cast<const T*>(k_slab), static_cast<const T*>(v_slab), pids,  \
      offs, k_dst, v_dst, k_scales, v_scales, L, R, Hkv, n_pages, page, D)
    switch (dtype) {
      case BF16: GOFR_SLAB_ANY(__nv_bfloat16); break;
      case F16: GOFR_SLAB_ANY(__half); break;
      case F32: GOFR_SLAB_ANY(float); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef GOFR_SLAB_ANY
    return (int)cudaGetLastError();
  }
  const auto* kb = static_cast<const __nv_bfloat16*>(k_slab);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_slab);
#define GOFR_SLAB(LPR)                                                   \
  kv_write_slab_kernel<QUANT, LPR><<<blocks, kSlabWarps * 32, 0, s>>>(   \
      kb, vb, pids, offs, k_dst, v_dst, k_scales, v_scales, L, R, Hkv,   \
      n_pages, page)
  switch (D) {
    case 8: GOFR_SLAB(1); break;
    case 16: GOFR_SLAB(2); break;
    case 32: GOFR_SLAB(4); break;
    case 64: GOFR_SLAB(8); break;
    case 128: GOFR_SLAB(16); break;
    case 256: GOFR_SLAB(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GOFR_SLAB
  return (int)cudaGetLastError();
}

}  // namespace

// One layer's K and V rows, each [N, Hkv, D] of the activation type
// `dtype` (0 bf16, 1 float16, 2 float32; v_rows may be null: K only),
// into pools [Hkv, n_pages, page, D] of the same type at (pids[n],
// offs[n]), int32 [N]. Returns the launch's cudaError_t (0 = launched).
extern "C" int gofr_kv_write(const void* k_rows, const void* v_rows,
                             const int* pids, const int* offs, void* k_pool,
                             void* v_pool, int N, int Hkv, int n_pages,
                             int page, int D, int dtype, void* stream) {
  return launch<false>(k_rows, v_rows, pids, offs, k_pool, v_pool, nullptr,
                       nullptr, N, Hkv, n_pages, page, D, dtype, stream);
}

// The same into an int8 pool: codes int8 [Hkv, n_pages, page, D], scales
// float32 [Hkv, n_pages, page, 1], quantized on the way.
extern "C" int gofr_kv_write_i8(const void* k_rows, const void* v_rows,
                                const int* pids, const int* offs,
                                void* k_codes, void* v_codes, float* k_scales,
                                float* v_scales, int N, int Hkv, int n_pages,
                                int page, int D, int dtype, void* stream) {
  return launch<true>(k_rows, v_rows, pids, offs, k_codes, v_codes, k_scales,
                      v_scales, N, Hkv, n_pages, page, D, dtype, stream);
}

// RoPE at positions[n] (int32 [N]) with inv_freq (float32 [D/2]) on q
// ([N, Hq, D]) into q_out ([N, Hq, D]) and on k ([N, Hkv, D]), then the
// rotated k and v ([N, Hkv, D]) into one layer's pools [Hkv, n_pages,
// page, D] at (pids[n], offs[n]), int32 [N]; q, k, v, q_out and the
// pools of the activation type `dtype` (0 bf16, 1 float16, 2 float32), D
// even and at most 256 (bf16 at 64 or 128: the kernel above it).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int gofr_rope_kv_write(const void* q, const void* k, const void* v,
                                  const int* positions, const float* inv_freq,
                                  const int* pids, const int* offs,
                                  void* q_out, void* k_pool, void* v_pool,
                                  int N, int Hq, int Hkv, int n_pages,
                                  int page, int D, int dtype, void* stream) {
  return launch_rope<false>(q, k, v, positions, inv_freq, pids, offs, q_out,
                            k_pool, v_pool, nullptr, nullptr, N, Hq, Hkv,
                            n_pages, page, D, dtype, stream);
}

// The same into an int8 layer: codes int8 [Hkv, n_pages, page, D], scales
// float32 [Hkv, n_pages, page, 1]; the rotated K row is rounded to the
// activation type before its amax is taken, as the plain version
// quantizes it.
extern "C" int gofr_rope_kv_write_i8(
    const void* q, const void* k, const void* v, const int* positions,
    const float* inv_freq, const int* pids, const int* offs, void* q_out,
    void* k_codes, void* v_codes, float* k_scales, float* v_scales, int N,
    int Hq, int Hkv, int n_pages, int page, int D, int dtype, void* stream) {
  return launch_rope<true>(q, k, v, positions, inv_freq, pids, offs, q_out,
                           k_codes, v_codes, k_scales, v_scales, N, Hq, Hkv,
                           n_pages, page, D, dtype, stream);
}

// A prefill's K and V slabs, [L, R, Hkv, D] of the activation type
// `dtype` (R = P x S rows, row r at (pids[r], offs[r]), int32 [R]), into
// the whole pools [L, Hkv, n_pages, page, D] of that type, every layer
// in one launch; D a multiple of 4 up to 256 (bf16 also 8), and every
// pointer 16-byte aligned.
extern "C" int gofr_kv_write_slab(const void* k_slab, const void* v_slab,
                                  const int* pids, const int* offs,
                                  void* k_pool, void* v_pool, int L, int R,
                                  int Hkv, int n_pages, int page, int D,
                                  int dtype, void* stream) {
  return launch_slab<false>(k_slab, v_slab, pids, offs, k_pool, v_pool,
                            nullptr, nullptr, L, R, Hkv, n_pages, page, D,
                            dtype, stream);
}

// The same into int8 pools: codes [L, Hkv, n_pages, page, D], scales
// float32 [L, Hkv, n_pages, page, 1].
extern "C" int gofr_kv_write_slab_i8(const void* k_slab, const void* v_slab,
                                     const int* pids, const int* offs,
                                     void* k_codes, void* v_codes,
                                     float* k_scales, float* v_scales, int L,
                                     int R, int Hkv, int n_pages, int page,
                                     int D, int dtype, void* stream) {
  return launch_slab<true>(k_slab, v_slab, pids, offs, k_codes, v_codes,
                           k_scales, v_scales, L, R, Hkv, n_pages, page, D,
                           dtype, stream);
}
