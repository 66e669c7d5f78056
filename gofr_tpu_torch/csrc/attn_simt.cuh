// The float32 attention kernel: flash prefill and paged chunk / tree at
// any head dim D that is a multiple of 4 from 16 to 256, for float32
// activations (bf16 and float16 run the wgmma kernels, float32 decode the
// split-KV kernel of paged_decode.cu). Kept in float32 FMAs: the tensor
// cores' TF32 keeps about three decimal digits, and JAX's float32 kernel
// computes in full float32. One kernel body serves the three functions
// of the Pallas kernels it stands in for, as the mode in its arguments
// says:
//   FLASH  gofr_tpu/ops/flash_attention.py `_flash_kernel`: q [B, Sq,
//          Hq, D] against dense k/v [B, Skv, Hkv, D], row i sees column
//          c iff c <= i and c < kv_lengths[b];
//   CHUNK  `_paged_chunk_kernel`: q [B, Sq, Hq, D] against one layer's
//          head-major pool [Hkv, Np, pg, D] through the slot's table, row
//          i sees p <= history + i and p < history + chunk;
//   TREE   `_paged_tree_kernel`: the chunk layout, node i sees the
//          history and the in-chunk rows its ancestor mask names.
// The pool is float32, or int8 codes with a float32 scale per row (value
// = code * scale in float32, as the plain version's slot_view
// dequantizes it). Table ids clamp to Np - 1, a slot walks at most
// max_pages pages, masked positions weigh exactly 0, and a row divides
// by max(l, 1e-30): a row that sees nothing, and every padding row (i >=
// chunk), writes zeros. (The JAX kernels pad the head dim to their
// 128-lane tiles and run the same masks.)
//
// What bounds it on the H100: as its wgmma siblings, HBM bytes at short
// chunks, and the products at long prefills: here float32 FMAs on the
// CUDA cores, 67 TFLOP/s at best, with shared-memory reads feeding each
// FMA. The design:
//   - one block per (q tile, KV head, slot): the tile's bq positions x
//     group query heads (at most ROWS = 16 rows) share every K/V tile
//     staged, so the group's heads read K/V once; a group above 16 heads
//     is cut into sub-groups of the same KV head, one block each
//     (paged_common.cuh `sub_groups`); a warp holds RW = 4 rows, and a
//     block has 4 warps whatever its rows: every warp stages;
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_common.cuh"

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

enum Mode { FLASH = 0, CHUNK = 2, TREE = 3 };

struct Args {
  const void* q;
  const void* k;            // dense k [B, Skv, Hkv, D] or a pool layer
  const void* v;
  const float* k_scales;    // int8 pools: [Hkv, Np, pg, 1]
  const float* v_scales;
  const int* tables;        // paged: [B, max_pages]
  const int* len_a;         // flash: kv_lengths; else history
  const int* len_b;         // chunk / tree: chunk lengths
  const int* tree_masks;    // tree: [B, Sq]
  void* out;                // q's layout and type
  int B, Sq, Hq, Hkv, D;
  int Skv;                  // flash
  int n_pages, page, max_pages;   // paged
  int mode;
  int bq;                   // query positions a block holds
  int n_sub;                // sub-groups of a group (one block each)
  float scale;
};

// Four neighbouring elements as floats (exact): 16 bytes of float32, 4
// of int8 codes; p is aligned to four elements.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
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

// q / out (and a plain pool) are float32; PT: the pool's element type
// (float, or int8 codes); PAGED: K/V through block tables, else dense
// (flash).
template <typename PT, bool PAGED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
attn(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int D = a.D, dv = (D + 31) / 32 * 32, nc = dv / 32;
  float* const qs = sm;                                // [ROWS][D]
  float* const ks = qs + (size_t)ROWS * D;             // [BK][D + 1]
  float* const vs = ks + (size_t)BK * (D + 1);         // [BK][dv]

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;   // longest first
  const int hk = blockIdx.y / a.n_sub, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const SubGroups sg = sub_groups(group, ROWS);
  const int head0 = blockIdx.y % a.n_sub * sg.size;
  const int gs = min(sg.size, group - head0);   // this block's query heads
  const int i0 = qt * a.bq;
  const int rows = a.bq * sg.size;   // block row r: position i0 + r / size,
                                     // head head0 + r % size (if < gs)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;

  // the slot's bounds: live rows are i < n_live; a live row sees
  // positions below kv_end and at or below its own (causal modes)
  int base = 0, n_live = a.Sq, kv_end;
  if (a.mode == FLASH) {
    kv_end = min(max(a.len_a[b], 0), a.Skv);
  } else {
    base = max(a.len_a[b], 0);
    n_live = min(max(a.len_b[b], 0), a.Sq);
    kv_end = min(base + n_live, a.max_pages * a.page);
  }
  // the last position any row of the tile can see, plus one
  const int lim = min(base + min(i0 + a.bq, n_live), kv_end);
  // block row r holds a query row of this block's heads below `bound`
  auto holds = [&](int r, int bound) {
    return r < rows && r % sg.size < gs && i0 + r / sg.size < bound;
  };

  const size_t q_rs = (size_t)a.Hq * D;   // row stride of q / out
  const size_t qo0 = (size_t)b * a.Sq * q_rs + ((size_t)hk * group + head0) * D;
  const float* qb = static_cast<const float*>(a.q) + qo0;
  float* ob = static_cast<float*>(a.out) + qo0;

  if (i0 >= n_live) {   // the whole tile is padding: zeros
    for (int e = tid; e < rows * D; e += nthreads) {
      const int r = e / D, i = i0 + r / sg.size;
      if (holds(r, a.Sq)) ob[(size_t)i * q_rs + (r % sg.size) * D + e % D] = 0.f;
    }
    return;
  }

  // q rows, pre-scaled into log2 units; rows past the block's or the
  // slot's live rows are zeros
  const float qscale = a.scale * LOG2E;
  for (int e = tid; e < ROWS * (D / 4); e += nthreads) {
    const int r = e / (D / 4), d = 4 * (e % (D / 4)), i = i0 + r / sg.size;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (holds(r, n_live))
      load4(qb + (size_t)i * q_rs + (r % sg.size) * D + d, f);
    *reinterpret_cast<float4*>(qs + (size_t)r * D + d) =
        make_float4(f[0] * qscale, f[1] * qscale, f[2] * qscale, f[3] * qscale);
  }

  // this warp's rows: what each sees
  int qpos[RW], mask[RW];
  bool live[RW];
  bool any = false;
#pragma unroll
  for (int t = 0; t < RW; ++t) {
    const int r = warp * RW + t, i = i0 + r / sg.size;
    live[t] = holds(r, n_live);
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
    const int r = warp * RW + t, i = i0 + r / sg.size;
    float lt = l[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
    if (!holds(r, a.Sq)) continue;
    const float inv = live[t] ? 1.f / fmaxf(lt, 1e-30f) : 0.f;
    float* orow = ob + (size_t)i * q_rs + (r % sg.size) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (c < nc && d < D) orow[d] = acc[t][c] * inv;
    }
  }
}

// Launch the kernel for the arguments' shapes on `stream`: bq = ROWS /
// (sub-)group query positions a block (at most Sq), MAX_WARPS warps.
// Returns the cudaError_t of the attribute call or the launch.
template <typename PT, bool PAGED>
int launch(Args a, cudaStream_t stream) {
  const SubGroups sg = sub_groups(a.Hq / a.Hkv, ROWS);
  a.n_sub = sg.n;
  a.bq = max(1, min(ROWS / sg.size, a.Sq));
  if ((long)a.Hkv * sg.n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Sq + a.bq - 1) / a.bq, a.Hkv * sg.n, a.B);
  const size_t smem = smem_floats(a.D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn<PT, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attn<PT, PAGED><<<grid, MAX_WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The head dims and shapes this kernel takes.
inline bool takes(const Args& a) {
  return a.D >= 16 && a.D <= MAX_D && a.D % 4 == 0 && a.B > 0 && a.Sq > 0 &&
         a.Hkv > 0 && a.Hq > 0 && a.Hq % a.Hkv == 0 && a.B <= 65535;
}

// Launch for float32 activations (paged: on the pool's form, k_scales
// set for int8 codes; a dense K/V is always float32).
template <bool PAGED>
int run(const Args& a, cudaStream_t stream) {
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  if constexpr (PAGED)
    if (a.k_scales != nullptr) return launch<int8_t, true>(a, stream);
  return launch<float, PAGED>(a, stream);
}

}  // namespace simt
