// The attention kernel of every shape the tensor-core kernels do not
// hold: any head dim D that is a multiple of 4 from 16 to 256, and
// bf16, float16 or float32 activations (with bf16 at D = 64 / 128 the
// wgmma kernels run, and this one never does). One kernel body serves
// the four functions of the Pallas kernels it stands in for, as the
// mode in its arguments says:
//   FLASH  gofr_tpu/ops/flash_attention.py `_flash_kernel`: q [B, Sq,
//          Hq, D] against dense k/v [B, Skv, Hkv, D], row i sees column
//          c iff c <= i and c < kv_lengths[b];
//   DECODE `_paged_decode_kernel`: q [B, Hq, D] (Sq = 1) against one
//          layer's head-major pool [Hkv, Np, pg, D] through the slot's
//          table, positions < lengths[b];
//   CHUNK  `_paged_chunk_kernel`: q [B, Sq, Hq, D], row i sees p <=
//          history + i and p < history + chunk;
//   TREE   `_paged_tree_kernel`: the chunk layout, node i sees the
//          history and the in-chunk rows its ancestor mask names.
// The pool is in the activations' type, or int8 codes with a float32
// scale per row (value = code * scale in float32, as the plain
// version's slot_view dequantizes it). Table ids clamp to Np - 1, a
// slot walks at most max_pages pages, masked positions weigh exactly
// 0, and a row divides by max(l, 1e-30): a row that sees nothing, and
// every padding row (i >= chunk), writes zeros. (The JAX kernels pad
// the head dim to their 128-lane tiles and run the same masks; the
// Pallas kernels compute in float32 whatever the input type, and so
// does this one.)
//
// What bounds it on the H100: as its wgmma siblings, HBM bytes at
// decode and short chunks, and the products at long prefills. This is
// the simple form: every product in float32 FMAs on the CUDA cores
// (full float32, never TF32, whatever the input type), 67 TFLOP/s at
// best against the 989 of the bf16 tensor cores, with shared-memory
// reads feeding each FMA. The design:
//   - one block per (q tile, KV head, slot): the tile's bq positions x
//     group query heads (at most ROWS = 16 rows) share every K/V tile
//     staged, so the group's heads read K/V once; a warp holds RW = 4
//     rows, and a block has 4 warps whatever its rows (a decode step of
//     an MHA model has one): a walk waits on its loads, not its math,
//     and every warp stages;
//   - K and V tiles of BK = 32 positions are staged in float32 (int8
//     codes dequantized on the way), a thread issuing LD = 4 vectors'
//     loads before it stores any, K at an odd row stride D + 1 so
//     that lane j, scoring position j, reads a distinct bank; q rows are
//     staged once, pre-scaled by scale * log2 e;
//   - scores: lane j computes position j's dot product for the warp's
//     4 rows at once (each K value read once for them); an online
//     softmax in the log2 domain per row (warp max, exp2f, per-lane
//     partial sums reduced at the end); P V: lane l owns output columns
//     l + 32 c, each position's p comes from its lane by shuffle;
//   - the walk stops at the last position a row of the tile can see;
//     q tiles run last-first, so the longest causal walks start first.
// No split-KV and no overlap of copies with math: a block walks its
// positions alone, one staged tile at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_types.cuh"

namespace simt {

constexpr int RW = 4;                  // query rows a warp holds
constexpr int MAX_WARPS = 4;
constexpr int ROWS = RW * MAX_WARPS;   // query rows a block holds at most
constexpr int BK = 32;                 // K/V positions a tile: one a lane
constexpr int LD = 4;                  // K and V vectors a thread loads at once
constexpr int MAX_D = 256;
constexpr int NC = MAX_D / 32;         // output columns a lane holds at most
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

enum Mode { FLASH = 0, DECODE = 1, CHUNK = 2, TREE = 3 };

using act::BF16;
using act::F16;
using act::F32;
using act::from_f;
using act::to_f;

struct Args {
  const void* q;
  const void* k;            // dense k [B, Skv, Hkv, D] or a pool layer
  const void* v;
  const float* k_scales;    // int8 pools: [Hkv, Np, pg, 1]
  const float* v_scales;
  const int* tables;        // paged: [B, max_pages]
  const int* len_a;         // flash: kv_lengths; decode: lengths; else history
  const int* len_b;         // chunk / tree: chunk lengths
  const int* tree_masks;    // tree: [B, Sq]
  void* out;                // q's layout and type
  int B, Sq, Hq, Hkv, D;
  int Skv;                  // flash
  int n_pages, page, max_pages;   // paged
  int mode;
  int bq;                   // query positions a block holds
  float scale;
};

// Four neighbouring elements as floats (exact): 16 bytes of float32, 8
// of a 16-bit type, 4 of int8 codes; p is aligned to four elements.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
}
__device__ __forceinline__ void load4(const __half* p, float (&f)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(w.x << 16);
  f[1] = __uint_as_float(w.x & 0xffff0000u);
  f[2] = __uint_as_float(w.y << 16);
  f[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
}

// Shared floats of one block: q rows [ROWS][D], K [BK][D + 1], V [BK][DV]
// with DV = D rounded up to 32 (the P V lanes' columns).
__host__ __device__ inline size_t smem_floats(int D) {
  const int dv = (D + 31) / 32 * 32;
  return (size_t)ROWS * D + (size_t)BK * (D + 1) + (size_t)BK * dv;
}

// T: q / out (and a plain pool's) type; PT: the pool's element type (T,
// or int8 codes); PAGED: K/V through block tables, else dense (flash).
template <typename T, typename PT, bool PAGED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
attn(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int D = a.D, dv = (D + 31) / 32 * 32, nc = dv / 32;
  float* const qs = sm;                                // [ROWS][D]
  float* const ks = qs + (size_t)ROWS * D;             // [BK][D + 1]
  float* const vs = ks + (size_t)BK * (D + 1);         // [BK][dv]

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;   // longest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int i0 = qt * a.bq;
  const int rows = a.bq * group;   // block row r: position i0 + r / group,
                                   // head hk * group + r % group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;

  // the slot's bounds: live rows are i < n_live; a live row sees
  // positions below kv_end and at or below its own (causal modes)
  int base = 0, n_live = a.Sq, kv_end;
  if (a.mode == FLASH) {
    kv_end = min(max(a.len_a[b], 0), a.Skv);
  } else if (a.mode == DECODE) {
    kv_end = min(max(a.len_a[b], 0), a.max_pages * a.page);
  } else {
    base = max(a.len_a[b], 0);
    n_live = min(max(a.len_b[b], 0), a.Sq);
    kv_end = min(base + n_live, a.max_pages * a.page);
  }
  // the last position any row of the tile can see, plus one
  const int lim = a.mode == DECODE
      ? kv_end : min(base + min(i0 + a.bq, n_live), kv_end);

  const size_t q_rs = (size_t)a.Hq * D;   // row stride of q / out
  const size_t head0 = (size_t)b * a.Sq * q_rs + (size_t)hk * group * D;
  const T* qb = static_cast<const T*>(a.q) + head0;
  T* ob = static_cast<T*>(a.out) + head0;

  if (i0 >= n_live) {   // the whole tile is padding: zeros
    for (int e = tid; e < rows * D; e += nthreads) {
      const int r = e / D, i = i0 + r / group;
      if (i < a.Sq) ob[(size_t)i * q_rs + (r % group) * D + e % D] = from_f<T>(0.f);
    }
    return;
  }

  // q rows, pre-scaled into log2 units; rows past the block's or the
  // slot's live rows are zeros
  const float qscale = a.scale * LOG2E;
  for (int e = tid; e < ROWS * (D / 4); e += nthreads) {
    const int r = e / (D / 4), d = 4 * (e % (D / 4)), i = i0 + r / group;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows && i < n_live)
      load4(qb + (size_t)i * q_rs + (r % group) * D + d, f);
    *reinterpret_cast<float4*>(qs + (size_t)r * D + d) =
        make_float4(f[0] * qscale, f[1] * qscale, f[2] * qscale, f[3] * qscale);
  }

  // this warp's rows: what each sees
  int qpos[RW], mask[RW];
  bool live[RW];
  bool any = false;
#pragma unroll
  for (int t = 0; t < RW; ++t) {
    const int r = warp * RW + t, i = i0 + r / group;
    live[t] = r < rows && i < n_live;
    any |= live[t];
    qpos[t] = a.mode == FLASH ? i : a.mode == CHUNK ? base + i : 0x7fffffff;
    mask[t] = a.mode == TREE && live[t] ? a.tree_masks[(size_t)b * a.Sq + i] : 0;
  }

  float m[RW], l[RW], acc[RW][NC];
#pragma unroll
  for (int t = 0; t < RW; ++t) {
    m[t] = NEG_INF;
    l[t] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[t][c] = 0.f;
  }

  const PT* kp = static_cast<const PT*>(a.k);
  const PT* vp = static_cast<const PT*>(a.v);
  constexpr bool Q8 = sizeof(PT) == 1;
  const size_t kv_rs = (size_t)a.Hkv * D;   // flash: row stride of k / v

  const int nv = D / 4;                     // 4-element vectors of a row
  for (int c0 = 0; c0 < lim; c0 += BK) {
    __syncthreads();   // every warp is done with the previous tile
    // LD vectors of K and of V a thread per round, every load of the
    // round issued before the first store waits on one
    for (int e0 = tid; e0 < BK * nv; e0 += LD * nthreads) {
      float fk[LD][4], fv[LD][4];
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int e = e0 + u * nthreads, j = e / nv, pos = c0 + j;
#pragma unroll
        for (int x = 0; x < 4; ++x) fk[u][x] = fv[u][x] = 0.f;
        if (e < BK * nv && pos < lim) {
          const int d = 4 * (e % nv);
          size_t off, srow = 0;
          if (PAGED) {
            const int pid = min(max(a.tables[(size_t)b * a.max_pages + pos / a.page], 0),
                                a.n_pages - 1);
            srow = ((size_t)hk * a.n_pages + pid) * a.page + pos % a.page;
            off = srow * D + d;
          } else {
            off = ((size_t)b * a.Skv + pos) * kv_rs + (size_t)hk * D + d;
          }
          load4(kp + off, fk[u]);
          load4(vp + off, fv[u]);
          if (Q8) {
            const float sk = a.k_scales[srow], sv = a.v_scales[srow];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              fk[u][x] *= sk;
              fv[u][x] *= sv;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int e = e0 + u * nthreads;
        if (e < BK * nv) {
          const int j = e / nv, d = 4 * (e % nv);
          float* kd = ks + (size_t)j * (D + 1) + d;
          kd[0] = fk[u][0]; kd[1] = fk[u][1]; kd[2] = fk[u][2]; kd[3] = fk[u][3];
          *reinterpret_cast<float4*>(vs + (size_t)j * dv + d) =
              make_float4(fv[u][0], fv[u][1], fv[u][2], fv[u][3]);
        }
      }
    }
    __syncthreads();   // the tile (and, at the first, the q rows) staged
    if (!any) continue;

    // lane j scores position c0 + j for the warp's rows
    float s[RW];
#pragma unroll
    for (int t = 0; t < RW; ++t) s[t] = 0.f;
    const float* kr = ks + (size_t)lane * (D + 1);
    const float* qw = qs + (size_t)warp * RW * D;
    for (int d = 0; d < D; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
      for (int t = 0; t < RW; ++t) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + (size_t)t * D + d);
        s[t] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
      }
    }

    const int pos = c0 + lane;
    const int jn = min(BK, lim - c0);
    float p[RW];
#pragma unroll
    for (int t = 0; t < RW; ++t) {
      bool vis = live[t] && lane < jn && pos < kv_end && pos <= qpos[t];
      if (a.mode == TREE) {
        const int rel = pos - base;
        vis = vis && (rel < 0 || ((mask[t] >> rel) & 1));
      }
      const float x = vis ? s[t] : NEG_INF;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[t], mx);
      const float alpha = exp2f(m[t] - m_new);
      // p masked explicitly: with nothing visible yet, x == m_new ==
      // NEG_INF and exp2(x - m_new) would be 1
      p[t] = vis ? exp2f(x - m_new) : 0.f;
      l[t] = l[t] * alpha + p[t];
      m[t] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[t][c] *= alpha;
    }

    // P V: lane l owns columns l + 32 c; position j's p from lane j
    for (int j = 0; j < jn; ++j) {
      float pj[RW];
#pragma unroll
      for (int t = 0; t < RW; ++t) pj[t] = __shfl_sync(0xffffffffu, p[t], j);
      const float* vr = vs + (size_t)j * dv + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          const float vv = vr[32 * c];
#pragma unroll
          for (int t = 0; t < RW; ++t) acc[t][c] += pj[t] * vv;
        }
      }
    }
  }

  // out = o / max(l, 1e-30); rows past the live ones write zeros
#pragma unroll
  for (int t = 0; t < RW; ++t) {
    const int r = warp * RW + t, i = i0 + r / group;
    float lt = l[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
    if (r >= rows || i >= a.Sq) continue;
    const float inv = live[t] ? 1.f / fmaxf(lt, 1e-30f) : 0.f;
    T* orow = ob + (size_t)i * q_rs + (r % group) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (c < nc && d < D) orow[d] = from_f<T>(acc[t][c] * inv);
    }
  }
}

// Launch the kernel for the arguments' shapes on `stream`: bq = ROWS /
// group query positions a block (at most Sq), MAX_WARPS warps.
// Returns the cudaError_t of the attribute call or the launch.
template <typename T, typename PT, bool PAGED>
int launch(Args a, cudaStream_t stream) {
  const int group = a.Hq / a.Hkv;
  a.bq = max(1, min(ROWS / group, a.Sq));
  const dim3 grid((a.Sq + a.bq - 1) / a.bq, a.Hkv, a.B);
  const size_t smem = smem_floats(a.D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn<T, PT, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attn<T, PT, PAGED><<<grid, MAX_WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The head dims and shapes this kernel takes.
inline bool takes(const Args& a) {
  return a.D >= 16 && a.D <= MAX_D && a.D % 4 == 0 && a.B > 0 && a.Sq > 0 &&
         a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.Hq / a.Hkv <= ROWS &&
         a.Hkv <= 65535 && a.B <= 65535;
}

// Dispatch on the activation type (and, paged, on the pool's form:
// k_scales set for int8 codes; a dense K/V is always in q's type).
template <bool PAGED>
int run(const Args& a, int dtype, cudaStream_t stream) {
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  const bool q8 = PAGED && a.k_scales != nullptr;
  switch (dtype) {
    case BF16:
      if constexpr (PAGED)
        if (q8) return launch<__nv_bfloat16, int8_t, true>(a, stream);
      return launch<__nv_bfloat16, __nv_bfloat16, PAGED>(a, stream);
    case F16:
      if constexpr (PAGED)
        if (q8) return launch<__half, int8_t, true>(a, stream);
      return launch<__half, __half, PAGED>(a, stream);
    case F32:
      if constexpr (PAGED)
        if (q8) return launch<float, int8_t, true>(a, stream);
      return launch<float, float, PAGED>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace simt
