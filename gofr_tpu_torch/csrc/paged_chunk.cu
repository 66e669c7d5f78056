// Paged chunk and draft-tree verify attention for Hopper (sm_90a), bf16
// and int8 pools.
//
// Replaces the Pallas TPU kernels gofr_tpu/ops/paged_attention.py
// `_paged_chunk_kernel` (wrapper `paged_chunk_attention_pallas`) and
// `_paged_tree_kernel` (wrapper `paged_tree_attention_pallas`), both
// branches of each: a bf16 pool, and the quantized {q: int8, s: f32
// [.., 1]} pool (`quantized=True`, C entries gofr_paged_chunk_i8 and
// gofr_paged_tree_i8). The two are one kernel body templated on its
// visibility rule (and on the pool's form), with one C entry point each:
//
// chunk (gofr_paged_chunk): slot b holds history[b] rows in the pool and
// has just written chunk[b] new rows after them; chunk row i (absolute
// position history + i) attends to every pool position p with
//   p <= history + i  and  p < history + chunk
// tree (gofr_paged_tree): the chunk[b] <= 32 rows are the nodes of a
// draft tree packed topologically (every parent index below its
// child's); node i attends every history row and in-chunk row j iff
// bit j of tree_masks[b, i] (its ancestor-or-self set) is set:
//   rel = p - history;  rel < 0  or  (rel < chunk  and  mask >> rel & 1)
// Because a node's ancestors all sit at lower rows, the chunk rule's
// ragged walk bound still holds exactly: a block of query rows never
// needs a position past history + min(end of its tile, chunk).
//
// Both read K/V in place through the slot's block table from one layer's
// head-major pool [Hkv, Np, pg, hd], query head h reading KV head
// h / group. Table ids are clamped to Np - 1, masked logits are
// NEG_INF with p = 0 set explicitly, and the output divides by
// max(l, 1e-30). Rows past chunk[b] are padding and are written as
// zeros (so a zero-length slot is exact zeros, and no row is left
// unwritten). A slot walks at most max_pages pages, as the plain
// version's [Mp * pg] view does; positions past the table are masked.
//
// What bounds it on the H100. Per (slot, KV head) the work is
// 4 * hd * group flops per visible (row, position) pair against the q
// and out rows (2 * group * hd * 2 bytes per chunk row) and the K/V
// rows walked (2 * hd * 2 bytes each). At the serving shapes, group 4
// and hd 64: a full 1024-row chunk over a 1024-row history sees ~1.5M
// pairs per head group, ~1.6 GFLOP against ~1.5 MiB, about 1,000
// flops per byte, above the card's ~295 balance point, so it is
// bound by the tensor cores (989 TFLOP/s bf16); a short prefix-cache
// suffix (a few rows over ~900 history rows) and a tree verify (at
// most 32 rows over the history) do ~25-130 flops per byte and are
// bound by HBM (3.35 TB/s), reading the history once. So the
// design puts both products on the tensor cores and reads each input
// once per group of query heads:
//   - one block of 4 warps per (tile of BQ query positions, KV head,
//     slot); the tile's BQ x group query rows are packed into the 64
//     rows of the block (BQ = 64 / group: 16 positions x 4 heads for
//     Llama-3.2-1B), so every K/V row brought on chip serves all the
//     query heads of its KV head, as the decode kernel does;
//   - the block loads its own table entries and walks 64-row K/V tiles
//     only up to history + min(end of its tile, chunk), the last
//     position any of its rows can see; a tile wholly past chunk[b]
//     writes zeros and exits without reading the pool;
//   - Q K^T and P V run on mma.sync m16n8k16 (bf16 in, f32 accumulate)
//     with the fragment layouts of flash_attention.cu (mma_bf16.cuh):
//     Q fragments stay in registers, V is staged transposed with rows
//     padded by 8 against bank conflicts, and the S fragment re-packs
//     in registers as the A fragment of P V; online softmax state is
//     float32 in registers;
//   - the visibility test is one device function (`visible`): each of a
//     thread's two query rows carries its history, horizon and, for a
//     tree, its 32-bit ancestor mask, loaded once per block row.
// The q tiles of one slot re-read its history: the K/V of a slot at
// 2048 rows is 4 MiB per layer, so the re-reads come from the 50 MB
// L2, not HBM. A tree verify at Sq <= 64 / group is one q tile, so it
// launches only B x Hkv blocks, which under-fills the 132 SMs at small
// batch.
//
// The int8 pool. A row stands for codes * scale, one float32 scale per
// row, and the function is the TPU kernel's: k = codes * s_k and v =
// codes * s_v in float32, then both products. Its bound is the same
// kind, with hd + 4 bytes per row per side instead of 2 * hd (about
// 0.53x the bytes at hd 64), so the short suffixes and tree verifies
// that HBM bounds move about half the bytes. The design keeps the bf16
// tensor-core path and folds the scales out of both products instead
// of dequantizing into bf16, which would round every c * s to 8 bits of
// mantissa (an error neither the float32 plain version nor the TPU
// kernel has):
//   - |code| <= 127 < 2^8, so a code converts to bf16 exactly; a tile's
//     codes (one 16-byte load = 16 codes) go into the same `ks` / `vt`
//     shared tiles as bf16 K and V, and mma.sync runs unchanged;
//   - S[i, j] = s_k[j] * sum_d q[i, d] c_k[j, d]: each S column is
//     multiplied by scale * s_k[pos] where the bf16 kernel multiplies
//     by scale; P V packs p * s_v[pos] into the A fragment, while l
//     sums the unscaled p;
//   - each tile's 64 K and 64 V scales are staged in shared memory from
//     the same clamped page id and offset as the codes; positions past
//     the walk limit get codes 0 and scale 0, so a masked position adds
//     0 * 0 and never 0 * a garbage scale (0 * inf = NaN).
// Not yet: cp.async / TMA double buffering of the next K/V tile, wgmma,
// splitting long histories across blocks (split-KV, what a tree verify
// at small batch needs most) — the later work toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int ROWS = 64;     // query rows per block: 4 warps x 16 rows
constexpr int BK = 64;       // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_GROUP = 16;   // BQ = ROWS / group >= 4
constexpr float NEG_INF = -1e30f;

// One query row of a chunk or tree: what it may see.
struct RowView {
  int q_pos;      // its absolute position, history + i; -1 for a padding row
  int kv_end;     // positions at or past this are not visible (0: padding)
  int hist;       // the slot's history length
  unsigned mask;  // tree only: bit j set iff in-chunk row j is an ancestor
                  // of this node or the node itself
};

// Code e (0..15) of a 16-byte load of int8 codes, as a float (exact).
__device__ __forceinline__ float code(const uint4& w, int e) {
  const uint32_t word = e < 4 ? w.x : e < 8 ? w.y : e < 12 ? w.z : w.w;
  return static_cast<float>(static_cast<int8_t>(word >> (8 * (e & 3))));
}

// Position `pos` of the slot is visible to the row. Chunk: its history
// and the chunk's causal prefix up to and including itself. Tree: its
// history and its ancestors (rel < chunk follows from pos < kv_end,
// and chunk <= 32 keeps the shift in range).
template <bool TREE>
__device__ __forceinline__ bool visible(const RowView& r, int pos) {
  if (TREE) {
    const int rel = pos - r.hist;
    return pos < r.kv_end && (rel < 0 || ((r.mask >> rel) & 1u));
  }
  return pos <= r.q_pos && pos < r.kv_end;
}

// Q8: the pages are int8 codes with a float32 scale per row
// (k_scales / v_scales [Hkv, Np, page, 1]); else bf16, scales unused.
template <int D, bool TREE, bool Q8>
__global__ void __launch_bounds__(NTHREADS)
paged_chunk(const __nv_bfloat16* __restrict__ q,
            const std::conditional_t<Q8, int8_t, __nv_bfloat16>* __restrict__ k_pool,
            const std::conditional_t<Q8, int8_t, __nv_bfloat16>* __restrict__ v_pool,
            const float* __restrict__ k_scales,
            const float* __restrict__ v_scales,
            const int* __restrict__ tables,
            const int* __restrict__ history,
            const int* __restrict__ chunk,
            const int* __restrict__ tree_masks,   // [B, Sq]; unused for a chunk
            __nv_bfloat16* __restrict__ out,
            int Sq, int Hq, int Hkv, int n_pages, int page, int max_pages,
            float scale) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  constexpr int KP = D + 8;    // padded row stride of the Q/K tile
  constexpr int VP = BK + 8;   // padded row stride of the transposed V tile
  constexpr int CPR = D / 8;   // 16-byte chunks per bf16 row
  constexpr int EPL = 16 / sizeof(T);          // pool elements per 16-byte load
  constexpr int LPR = D / EPL;                 // 16-byte loads per pool row
  constexpr int KC = D / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;   // n-tiles of S
  constexpr int NO = D / 8;    // n-tiles of O
  static_assert(ROWS == BK, "the Q tile is staged through the K buffer");
  __shared__ __align__(16) __nv_bfloat16 ks[BK * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];
  // Q8: the tile's row scales (0 past the walk limit)
  __shared__ float kss[Q8 ? BK : 1], vss[Q8 ? BK : 1];

  const int qt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int bq = ROWS / group;          // query positions per block
  const int live_rows = bq * group;     // block rows holding a query row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int i0 = qt * bq;               // first query index of the tile
  const int hist = max(history[b], 0);
  const int clen = min(max(chunk[b], 0), Sq);

  // block row r is query index i0 + r / group, head hk * group + r % group;
  // the heads of one query index are contiguous in q and out
  const size_t q_rs = (size_t)Hq * D;
  const size_t head0 = (size_t)b * Sq * q_rs + (size_t)hk * group * D;
  const __nv_bfloat16* qb = q + head0;
  __nv_bfloat16* ob = out + head0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if (i0 >= clen) {   // the whole tile is padding
    for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
      const int r = i / CPR, c = i % CPR, qi = i0 + r / group;
      if (r < live_rows && qi < Sq)
        *reinterpret_cast<uint4*>(ob + (size_t)qi * q_rs + (r % group) * D + c * 8) = zero;
    }
    return;
  }

  // stage the Q tile through the K buffer, keep its A fragments
  for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR, qi = i0 + r / group;
    uint4 val = zero;
    if (r < live_rows && qi < clen)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)qi * q_rs + (r % group) * D + c * 8);
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

  // this thread's two rows (c0,c1 and c2,c3 of every fragment)
  const int kv_end = min(hist + clen, max_pages * page);
  RowView rows[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = wr + gid + 8 * t, qi = i0 + r / group;
    const bool live = r < live_rows && qi < clen;
    rows[t].q_pos = live ? hist + qi : -1;
    rows[t].kv_end = live ? kv_end : 0;
    rows[t].hist = hist;
    rows[t].mask = (TREE && live)
        ? static_cast<unsigned>(tree_masks[(size_t)b * Sq + qi]) : 0u;
  }
  // the last position any row of the tile can see, plus one
  const int kv_limit = min(hist + min(i0 + bq, clen), max_pages * page);
  const int n_tiles = (kv_limit + BK - 1) / BK;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  const size_t page_elems = (size_t)page * D;
  const T* kh = k_pool + (size_t)hk * n_pages * page_elems;
  const T* vh = v_pool + (size_t)hk * n_pages * page_elems;
  const int* table = tables + (size_t)b * max_pages;

  for (int j = 0; j < n_tiles; ++j) {
    const int c0 = j * BK;
    for (int i = tid; i < BK * LPR; i += NTHREADS) {
      const int r = i / LPR, c = i % LPR, pos = c0 + r;
      uint4 kval = zero, vval = zero;
      if (pos < kv_limit) {
        const int pid = min(max(table[pos / page], 0), n_pages - 1);
        const size_t off = (size_t)pid * page_elems + (size_t)(pos % page) * D + c * EPL;
        kval = *reinterpret_cast<const uint4*>(kh + off);
        vval = *reinterpret_cast<const uint4*>(vh + off);
      }
      if (Q8) {
        // 16 codes -> 16 exact bf16 values: two 16-byte K stores, 16 V
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint4*>(&ks[r * KP + c * 16 + 8 * h]) = make_uint4(
              pack_bf16x2(code(kval, 8 * h), code(kval, 8 * h + 1)),
              pack_bf16x2(code(kval, 8 * h + 2), code(kval, 8 * h + 3)),
              pack_bf16x2(code(kval, 8 * h + 4), code(kval, 8 * h + 5)),
              pack_bf16x2(code(kval, 8 * h + 6), code(kval, 8 * h + 7)));
#pragma unroll
        for (int e = 0; e < 16; ++e)
          vt[(c * 16 + e) * VP + r] = __float2bfloat16_rn(code(vval, e));
      } else {
        *reinterpret_cast<uint4*>(&ks[r * KP + c * 8]) = kval;
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
        for (int e = 0; e < 8; ++e) vt[(c * 8 + e) * VP + r] = ve[e];
      }
    }
    if (Q8 && tid < BK) {
      const int pos = c0 + tid;
      float ksv = 0.f, vsv = 0.f;
      if (pos < kv_limit) {
        const int pid = min(max(table[pos / page], 0), n_pages - 1);
        const size_t srow = ((size_t)hk * n_pages + pid) * page + pos % page;
        ksv = k_scales[srow];
        vsv = v_scales[srow];
      }
      kss[tid] = ksv;
      vss[tid] = vsv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 positions
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

    // mask, then the online-softmax update
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig * 2 + (e & 1), pos = c0 + col;
        const float sc = Q8 ? scale * kss[col] : scale;
        const float val = visible<TREE>(rows[e >> 1], pos) ? s[n][e] * sc : NEG_INF;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], 1));
      mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], 2));
      const float m_new = fmaxf(m[t], mx[t]);
      alpha[t] = __expf(m[t] - m_new);
      m[t] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // p masked explicitly: a row with nothing visible yet has
        // s == m == NEG_INF, and exp(s - m) would be 1
        // the A fragment of P V takes column col of S: it carries
        // p * s_v[col] for an int8 tile, while l sums p
        const int col = n * 8 + tig * 2 + (e & 1), pos = c0 + col;
        const float p = visible<TREE>(rows[e >> 1], pos) ? __expf(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = Q8 ? p * vss[col] : p;
        rs[e >> 1] += p;
      }
    }
    // l stays a per-thread partial sum (the quad shares m and alpha);
    // the quad reduction happens once, after the walk
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
  for (int t = 0; t < 2; ++t) {
    l[t] += __shfl_xor_sync(0xffffffffu, l[t], 1);
    l[t] += __shfl_xor_sync(0xffffffffu, l[t], 2);
    const int r = wr + gid + 8 * t, qi = i0 + r / group;
    if (r >= live_rows || qi >= Sq) continue;
    // padding rows (q_pos -1) write zeros; a live row divides by max(l, 1e-30)
    const float inv = rows[t].q_pos >= 0 ? 1.f / fmaxf(l[t], 1e-30f) : 0.f;
    __nv_bfloat16* orow = ob + (size_t)qi * q_rs + (r % group) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(orow + d) =
          pack_bf16x2(o[n][2 * t] * inv, o[n][2 * t + 1] * inv);
    }
  }
}

template <int D, bool TREE, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* history, const int* chunk, const int* tree_masks,
           void* out, int B, int Sq, int Hq, int Hkv, int n_pages, int page,
           int max_pages, float scale, cudaStream_t s) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  const int bq = ROWS / (Hq / Hkv);
  const dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  paged_chunk<D, TREE, Q8><<<grid, dim3(NTHREADS), 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), k_scales, v_scales, tables, history,
      chunk, tree_masks, static_cast<__nv_bfloat16*>(out), Sq, Hq, Hkv,
      n_pages, page, max_pages, scale);
  return (int)cudaGetLastError();
}

template <bool TREE, bool Q8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scales, const float* v_scales, const int* tables,
             const int* history, const int* chunk, const int* tree_masks,
             void* out, int B, int Sq, int Hq, int Hkv, int n_pages, int page,
             int max_pages, int D, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_GROUP ||
      n_pages <= 0 || page <= 0 || max_pages <= 0 || B > 65535 || Hkv > 65535 ||
      (TREE && Sq > 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, TREE, Q8>(q, k_pool, v_pool, k_scales, v_scales, tables,
                                history, chunk, tree_masks, out, B, Sq, Hq,
                                Hkv, n_pages, page, max_pages, scale, s);
  if (D == 128)
    return launch<128, TREE, Q8>(q, k_pool, v_pool, k_scales, v_scales, tables,
                                 history, chunk, tree_masks, out, B, Sq, Hq,
                                 Hkv, n_pages, page, max_pages, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). q [B, Sq, Hq, D], pools [Hkv, Np, page,
// D] (one layer, contiguous), tables int32 [B, max_pages], history and
// chunk int32 [B], out [B, Sq, Hq, D]; all 16-byte aligned. Returns the
// launch's cudaError_t (0 = launched), or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int gofr_paged_chunk(const void* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* history, const int* chunk,
                                void* out, int B, int Sq, int Hq, int Hkv,
                                int n_pages, int page, int max_pages, int D,
                                float scale, void* stream) {
  return dispatch<false, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                history, chunk, nullptr, out, B, Sq, Hq, Hkv,
                                n_pages, page, max_pages, D, scale, stream);
}

// The same, for draft-tree verify: tree_masks int32 [B, Sq] packs each
// node's ancestor-or-self set over the in-chunk node index; Sq <= 32.
extern "C" int gofr_paged_tree(const void* q, const void* k_pool,
                               const void* v_pool, const int* tables,
                               const int* history, const int* chunk,
                               const int* tree_masks, void* out, int B,
                               int Sq, int Hq, int Hkv, int n_pages, int page,
                               int max_pages, int D, float scale,
                               void* stream) {
  return dispatch<true, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                               history, chunk, tree_masks, out, B, Sq, Hq,
                               Hkv, n_pages, page, max_pages, D, scale, stream);
}

// The chunk and tree entries over an int8 pool: k_codes / v_codes int8
// [Hkv, Np, page, D] (16-byte aligned), k_scales / v_scales float32
// [Hkv, Np, page, 1].
extern "C" int gofr_paged_chunk_i8(const void* q, const void* k_codes,
                                   const void* v_codes, const float* k_scales,
                                   const float* v_scales, const int* tables,
                                   const int* history, const int* chunk,
                                   void* out, int B, int Sq, int Hq, int Hkv,
                                   int n_pages, int page, int max_pages, int D,
                                   float scale, void* stream) {
  return dispatch<false, true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                               history, chunk, nullptr, out, B, Sq, Hq, Hkv,
                               n_pages, page, max_pages, D, scale, stream);
}

extern "C" int gofr_paged_tree_i8(const void* q, const void* k_codes,
                                  const void* v_codes, const float* k_scales,
                                  const float* v_scales, const int* tables,
                                  const int* history, const int* chunk,
                                  const int* tree_masks, void* out, int B,
                                  int Sq, int Hq, int Hkv, int n_pages,
                                  int page, int max_pages, int D, float scale,
                                  void* stream) {
  return dispatch<true, true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                              history, chunk, tree_masks, out, B, Sq, Hq, Hkv,
                              n_pages, page, max_pages, D, scale, stream);
}
