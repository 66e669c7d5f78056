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
//   - one block of 4 warps per (split, tile of BQ query positions, KV
//     head, slot); the tile's BQ x group query rows are packed into the
//     64 rows of the block (BQ = 64 / group: 16 positions x 4 heads for
//     Llama-3.2-1B), so every K/V row brought on chip serves all the
//     query heads of its KV head, as the decode kernel does;
//   - split-KV: the block walks 64-row K/V tiles up to history +
//     min(end of its tile, chunk), the last position any of its rows
//     can see, and with S splits (grid x = q tiles x S) split s takes
//     its share of those tiles. The wrapper picks S from the shapes
//     alone (ops/paged_attention.kv_splits: about two waves of blocks
//     on 132 SMs, S = 1 when the grid is already that large, as at a
//     1024-row chunk). The S splits of a q tile are one thread-block
//     cluster; each leaves its float32 (m, l, o) per row in shared
//     memory, and after a cluster barrier every split merges a share of
//     the rows from all S partials through distributed shared memory,
//     in split order, as the decode kernel does. So a tree verify at
//     small batch (one q tile per slot) spreads its long histories over
//     S blocks, and the chunk and tree modes, seeing the same shapes,
//     take the same S and the same walk. With S = 1 the arithmetic is
//     the unsplit kernel's, bit for bit;
//   - a tile wholly past chunk[b] writes zeros and exits without reading
//     the pool (uniform over its cluster: all its splits share the tile);
//   - K and V tiles are staged row-major with 16-byte cp.async, double
//     buffered: tile j + 1 is in flight while tile j is multiplied, and
//     the table entries of tile j + 2 are read before tile j's math; a
//     position past the walk limit is zero-filled by the copy itself;
//   - Q K^T and P V run on mma.sync m16n8k16 (bf16 in, f32 accumulate)
//     with the fragment layouts of flash_attention.cu (mma_bf16.cuh):
//     Q fragments stay in registers, K is read as B fragments from its
//     row-major tile, P V's B fragments come from the row-major V tile
//     through ldmatrix.x4.trans (rows padded by 8 against bank
//     conflicts), and the S fragment re-packs in registers as the A
//     fragment of P V; online softmax state is float32 in registers;
//   - the visibility test is one device function (`visible`): each of a
//     thread's two query rows carries its history, horizon and, for a
//     tree, its 32-bit ancestor mask, loaded once per block row. A
//     thread tests its 32 elements of a tile once, into a bit mask that
//     both softmax passes read; a tile wholly below the history is seen
//     in full by every live row and skips the test.
// The q tiles of one slot re-read its history: the K/V of a slot at
// 2048 rows is 4 MiB per layer, so the re-reads come from the 50 MB
// L2, not HBM. What bounds it now: at a 1024-row chunk, the mma.sync
// issue rate (no wgmma yet); at a tree verify, a split's few dependent
// tiles and the cluster merge.
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
//   - the raw codes are staged (cp.async, double buffered) and widened
//     in one pass into bf16 K and V tiles: |code| <= 127 < 2^8, so a
//     code converts to bf16 exactly, and mma.sync runs unchanged;
//   - S[i, j] = s_k[j] * sum_d q[i, d] c_k[j, d]: each S column is
//     multiplied by scale * s_k[pos] where the bf16 kernel multiplies
//     by scale; P V packs p * s_v[pos] into the A fragment, while l
//     sums the unscaled p;
//   - each tile's 64 K and 64 V scales are staged beside the codes from
//     the same clamped page id and offset; positions past the walk
//     limit get codes 0 and scale 0, so a masked position adds 0 * 0
//     and never 0 * a garbage scale (0 * inf = NaN).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "paged_common.cuh"

namespace cg = cooperative_groups;

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

// 16 int8 codes (one 16-byte word) -> 16 bf16 values, exactly: |code| <=
// 127 < 2^8 fits bf16's 8-bit significand. lo holds codes 0-7, hi 8-15.
__device__ __forceinline__ void widen_codes(const uint4& w, uint4& lo,
                                            uint4& hi) {
  lo = make_uint4(pack_bf16x2(code(w, 0), code(w, 1)),
                  pack_bf16x2(code(w, 2), code(w, 3)),
                  pack_bf16x2(code(w, 4), code(w, 5)),
                  pack_bf16x2(code(w, 6), code(w, 7)));
  hi = make_uint4(pack_bf16x2(code(w, 8), code(w, 9)),
                  pack_bf16x2(code(w, 10), code(w, 11)),
                  pack_bf16x2(code(w, 12), code(w, 13)),
                  pack_bf16x2(code(w, 14), code(w, 15)));
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

// Shared-memory plan (byte offsets), shared by the kernel and its
// launcher. bf16: K and V tiles [2 stages][BK][KP]. int8: raw code tiles
// [2 stages][K|V][BK * D], one widened bf16 K/V pair [K|V][BK][KP], and
// the row scales [2 stages][K|V][BK]. The Q tile is staged through the
// second stage's K tile (int8: the widened K tile) before the walk, and
// the merge's partials [ROWS][D + 8] + m, l [ROWS] reuse the start of
// the area after it.
template <int D, bool Q8>
struct Plan {
  static constexpr int KP = D + 8;              // padded bf16 row stride
  static constexpr size_t TILE = (size_t)BK * KP * 2;   // bytes, one side
  static constexpr size_t RAW = (size_t)BK * D;         // bytes, one side
  static constexpr size_t WIDE = Q8 ? 4 * RAW : 0;      // bf16 tiles start
  static constexpr size_t SCALES = Q8 ? WIDE + 2 * TILE : 0;
  static constexpr size_t STAGED = Q8 ? SCALES + 4 * BK * 4 : 4 * TILE;
  static constexpr size_t MERGE = (size_t)ROWS * (D + 8) * 4 + 2 * ROWS * 4;
  static constexpr size_t TOTAL = STAGED > MERGE ? STAGED : MERGE;
};

// Q8: the pages are int8 codes with a float32 scale per row
// (k_scales / v_scales [Hkv, Np, page, 1]); else bf16, scales unused.
template <int D, bool TREE, bool Q8>
__global__ void __launch_bounds__(NTHREADS, 1)
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
            int n_splits, float scale) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  using P = Plan<D, Q8>;
  constexpr int KP = P::KP;
  constexpr int CPR = D / 8;   // 16-byte chunks per bf16 row
  constexpr int EPL = 16 / sizeof(T);          // pool elements per 16-byte load
  constexpr int LPR = D / EPL;                 // 16-byte loads per pool row
  constexpr int PER = BK * LPR / NTHREADS;     // loads per thread per side per tile
  constexpr int NPID = PER + (Q8 ? 1 : 0);     // table entries a thread reads per tile
  constexpr int KC = D / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;   // n-tiles of S
  constexpr int NO = D / 8;    // n-tiles of O
  static_assert(ROWS == BK, "the Q tile is staged through a K tile");
  static_assert(NTHREADS == 2 * BK, "one thread per K or V row scale");
  static_assert(NO % 2 == 0, "ldmatrix.x4 covers two n-tiles of O");
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s of a bf16 pool: K at tile(2 s), V at tile(2 s + 1)
  __nv_bfloat16* const tiles = reinterpret_cast<__nv_bfloat16*>(smem + P::WIDE);
  int8_t* const raw = reinterpret_cast<int8_t*>(smem);                // Q8
  float* const scl = reinterpret_cast<float*>(smem + P::SCALES);      // Q8
  auto tile = [&](int i) { return tiles + (size_t)i * BK * KP; };

  const int split = blockIdx.x % n_splits, qt = blockIdx.x / n_splits;
  const int hk = blockIdx.y, b = blockIdx.z;
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

  if (i0 >= clen) {   // the whole tile is padding (every split of it)
    if (split == 0) {
      for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
        const int r = i / CPR, c = i % CPR, qi = i0 + r / group;
        if (r < live_rows && qi < Sq)
          *reinterpret_cast<uint4*>(ob + (size_t)qi * q_rs + (r % group) * D + c * 8) = zero;
      }
    }
    return;
  }

  // the last position any row of the tile can see, plus one, and this
  // split's share of the 64-row tiles below it
  const int kv_limit = min(hist + min(i0 + bq, clen), max_pages * page);
  const int n_tiles = (kv_limit + BK - 1) / BK;
  const int per = (n_tiles + n_splits - 1) / n_splits;
  const int j0 = min(split * per, n_tiles), j1 = min(j0 + per, n_tiles);

  const size_t page_elems = (size_t)page * D;
  const T* kh = k_pool + (size_t)hk * n_pages * page_elems;
  const T* vh = v_pool + (size_t)hk * n_pages * page_elems;
  const int* table = tables + (size_t)b * max_pages;

  // the table ids of this thread's rows of the tile at c0 (-1: past the
  // walk limit): load k covers row (tid + k NTHREADS) / LPR, and for
  // int8 entry PER is the row of this thread's scale, tid % BK
  auto lookup = [&](int c0, int* pid) {
#pragma unroll
    for (int k = 0; k < NPID; ++k) {
      const int r = k < PER ? (tid + k * NTHREADS) / LPR : tid % BK;
      const int pos = c0 + r;
      pid[k] = pos < kv_limit ? min(max(table[pos / page], 0), n_pages - 1) : -1;
    }
  };
  // issue the copies of the tile at c0 into stage st
  auto issue = [&](int c0, const int* pid, int st) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * NTHREADS, r = i / LPR, c = i % LPR, pos = c0 + r;
      const size_t off = pid[k] >= 0
          ? (size_t)pid[k] * page_elems + (size_t)(pos % page) * D + c * EPL : 0;
      const int n = pid[k] >= 0 ? 16 : 0;
      if (Q8) {
        cp_async16(raw + (2 * st) * P::RAW + r * D + c * 16, kh + off, n);
        cp_async16(raw + (2 * st + 1) * P::RAW + r * D + c * 16, vh + off, n);
      } else {
        cp_async16(tile(2 * st) + r * KP + c * 8, kh + off, n);
        cp_async16(tile(2 * st + 1) + r * KP + c * 8, vh + off, n);
      }
    }
    if (Q8) {
      const int r = tid % BK, side = tid / BK, pos = c0 + r;
      const int pid_s = pid[PER];
      const size_t srow = pid_s >= 0
          ? ((size_t)hk * n_pages + pid_s) * page + pos % page : 0;
      cp_async4(scl + (2 * st + side) * BK + r,
                (side ? v_scales : k_scales) + srow, pid_s >= 0 ? 4 : 0);
    }
  };

  // stage the Q tile (padding rows as zeros), and the walk's first tile
  __nv_bfloat16* const qtile = Q8 ? tile(0) : tile(2);
  for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR, qi = i0 + r / group;
    const bool live = r < live_rows && qi < clen;
    cp_async16(qtile + r * KP + c * 8,
               live ? qb + (size_t)qi * q_rs + (r % group) * D + c * 8 : qb,
               live ? 16 : 0);
  }
  cp_async_commit();
  int pid[NPID];
  if (j0 < j1) {
    lookup(j0 * BK, pid);
    issue(j0 * BK, pid, 0);
    if (j0 + 1 < j1) lookup((j0 + 1) * BK, pid);
  }
  cp_async_commit();
  cp_async_wait<1>();   // the Q tile
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int col = kc * 16 + tig * 2;
    qa[kc][0] = ld_u32(&qtile[(wr + gid) * KP + col]);
    qa[kc][1] = ld_u32(&qtile[(wr + gid + 8) * KP + col]);
    qa[kc][2] = ld_u32(&qtile[(wr + gid) * KP + col + 8]);
    qa[kc][3] = ld_u32(&qtile[(wr + gid + 8) * KP + col + 8]);
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

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    if (j + 1 < j1) {
      issue((j + 1) * BK, pid, st ^ 1);
      if (j + 2 < j1) lookup((j + 2) * BK, pid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile j staged by every thread
    const int c0 = j * BK;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* vs;
    const float* kss = scl + (2 * st) * BK;
    const float* vss = kss + BK;
    if (Q8) {
      // widen the raw codes once: 16 codes -> two 16-byte bf16 stores
      const int8_t* kr = raw + (2 * st) * P::RAW;
      const int8_t* vr = kr + P::RAW;
      for (int i = tid; i < BK * D / 16; i += NTHREADS) {
        const int r = i / (D / 16), c = 16 * (i % (D / 16));
        uint4 lo, hi;
        widen_codes(*reinterpret_cast<const uint4*>(kr + 16 * i), lo, hi);
        *reinterpret_cast<uint4*>(tile(0) + r * KP + c) = lo;
        *reinterpret_cast<uint4*>(tile(0) + r * KP + c + 8) = hi;
        widen_codes(*reinterpret_cast<const uint4*>(vr + 16 * i), lo, hi);
        *reinterpret_cast<uint4*>(tile(1) + r * KP + c) = lo;
        *reinterpret_cast<uint4*>(tile(1) + r * KP + c + 8) = hi;
      }
      __syncthreads();
      ks = tile(0);
      vs = tile(1);
    } else {
      ks = tile(2 * st);
      vs = tile(2 * st + 1);
    }

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

    // which of this thread's 32 S elements its rows see: bit 4 n + e.
    // A tile wholly below the history and the horizon is seen in full
    // by every live row, in both modes (the same bits either way)
    uint32_t vis = 0;
    if (c0 + BK <= min(hist, kv_end)) {
      vis = (rows[0].q_pos >= 0 ? 0x33333333u : 0u)
          | (rows[1].q_pos >= 0 ? 0xccccccccu : 0u);
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (visible<TREE>(rows[e >> 1], c0 + n * 8 + tig * 2 + (e & 1)))
            vis |= 1u << (4 * n + e);
    }

    // mask, then the online-softmax update
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig * 2 + (e & 1);
        const float sc = Q8 ? scale * kss[col] : scale;
        const float val = (vis >> (4 * n + e)) & 1u ? s[n][e] * sc : NEG_INF;
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
        const int col = n * 8 + tig * 2 + (e & 1);
        const float p = (vis >> (4 * n + e)) & 1u ? __expf(s[n][e] - m[e >> 1]) : 0.f;
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

    // O += P V: the S fragments re-packed as A fragments; the B
    // fragments of two n-tiles per ldmatrix.x4.trans from the row-major
    // V tile (lane l addresses kv row 16 kk + l % 16, columns 8 (n + l / 16))
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &vs[(kk * 16 + (lane & 15)) * KP + (n + (lane >> 4)) * 8]);
        mma_16816(o[n], pa, vb[0], vb[1]);
        mma_16816(o[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // stage st (and the widened tiles) free again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int t = 0; t < 2; ++t) {
    l[t] += __shfl_xor_sync(0xffffffffu, l[t], 1);
    l[t] += __shfl_xor_sync(0xffffffffu, l[t], 2);
  }
  if (n_splits == 1) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
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
    return;
  }

  // split-KV: leave this split's partial (o unnormalized, m, l per row)
  // in shared memory, then merge the S partials of the q tile in split
  // order; split r writes every S-th group of NTHREADS column pairs
  __syncthreads();   // every warp is done with the staged tiles
  constexpr int OP = D + 8;   // padded float row stride of the partial o
  float* const po = reinterpret_cast<float*>(smem);
  float* const pm = po + ROWS * OP;
  float* const pl = pm + ROWS;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = wr + gid + 8 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(po + r * OP + n * 8 + tig * 2) =
          make_float2(o[n][2 * t], o[n][2 * t + 1]);
    if (tig == 0) {
      pm[r] = m[t];
      pl[r] = l[t];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial is in its shared memory
  const int rank = (int)cluster.block_rank();
  for (int e = rank * NTHREADS + tid; e < ROWS * (D / 2); e += n_splits * NTHREADS) {
    const int r = e / (D / 2), d = 2 * (e % (D / 2)), qi = i0 + r / group;
    if (r >= live_rows || qi >= Sq) continue;
    float o0 = 0.f, o1 = 0.f;
    if (qi < clen) {   // a padding row writes zeros
      float M = NEG_INF;
      for (int sp = 0; sp < n_splits; ++sp)
        M = fmaxf(M, cluster.map_shared_rank(pm, sp)[r]);
      float L = 0.f;
      for (int sp = 0; sp < n_splits; ++sp) {
        const float w = __expf(cluster.map_shared_rank(pm, sp)[r] - M);
        L += w * cluster.map_shared_rank(pl, sp)[r];
        const float2 part = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(po, sp) + r * OP + d);
        o0 += w * part.x;
        o1 += w * part.y;
      }
      const float inv = 1.f / fmaxf(L, 1e-30f);
      o0 *= inv;
      o1 *= inv;
    }
    *reinterpret_cast<uint32_t*>(ob + (size_t)qi * q_rs + (r % group) * D + d) =
        pack_bf16x2(o0, o1);
  }
  cluster.sync();   // no split leaves while another still reads it
}

template <int D, bool TREE, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* history, const int* chunk, const int* tree_masks,
           void* out, int B, int Sq, int Hq, int Hkv, int n_pages, int page,
           int max_pages, int n_splits, float scale, cudaStream_t s) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  const int bq = ROWS / (Hq / Hkv);
  const dim3 grid((Sq + bq - 1) / bq * n_splits, Hkv, B);
  return launch_split(
      paged_chunk<D, TREE, Q8>, grid, NTHREADS, Plan<D, Q8>::TOTAL, n_splits,
      s, static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), k_scales, v_scales, tables, history,
      chunk, tree_masks, static_cast<__nv_bfloat16*>(out), Sq, Hq, Hkv,
      n_pages, page, max_pages, n_splits, scale);
}

template <bool TREE, bool Q8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scales, const float* v_scales, const int* tables,
             const int* history, const int* chunk, const int* tree_masks,
             void* out, int B, int Sq, int Hq, int Hkv, int n_pages, int page,
             int max_pages, int D, int n_splits, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_GROUP ||
      n_pages <= 0 || page <= 0 || max_pages <= 0 || B > 65535 || Hkv > 65535 ||
      (TREE && Sq > 32) || n_splits < 1 || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, TREE, Q8>(q, k_pool, v_pool, k_scales, v_scales, tables,
                                history, chunk, tree_masks, out, B, Sq, Hq,
                                Hkv, n_pages, page, max_pages, n_splits,
                                scale, s);
  if (D == 128)
    return launch<128, TREE, Q8>(q, k_pool, v_pool, k_scales, v_scales, tables,
                                 history, chunk, tree_masks, out, B, Sq, Hq,
                                 Hkv, n_pages, page, max_pages, n_splits,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). q [B, Sq, Hq, D], pools [Hkv, Np, page,
// D] (one layer, contiguous), tables int32 [B, max_pages], history and
// chunk int32 [B], out [B, Sq, Hq, D]; all 16-byte aligned; n_splits
// (1-8) blocks share each q tile's walk. Returns the launch's
// cudaError_t (0 = launched), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int gofr_paged_chunk(const void* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* history, const int* chunk,
                                void* out, int B, int Sq, int Hq, int Hkv,
                                int n_pages, int page, int max_pages, int D,
                                int n_splits, float scale, void* stream) {
  return dispatch<false, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                history, chunk, nullptr, out, B, Sq, Hq, Hkv,
                                n_pages, page, max_pages, D, n_splits, scale,
                                stream);
}

// The same, for draft-tree verify: tree_masks int32 [B, Sq] packs each
// node's ancestor-or-self set over the in-chunk node index; Sq <= 32.
extern "C" int gofr_paged_tree(const void* q, const void* k_pool,
                               const void* v_pool, const int* tables,
                               const int* history, const int* chunk,
                               const int* tree_masks, void* out, int B,
                               int Sq, int Hq, int Hkv, int n_pages, int page,
                               int max_pages, int D, int n_splits, float scale,
                               void* stream) {
  return dispatch<true, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                               history, chunk, tree_masks, out, B, Sq, Hq,
                               Hkv, n_pages, page, max_pages, D, n_splits,
                               scale, stream);
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
                                   int n_splits, float scale, void* stream) {
  return dispatch<false, true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                               history, chunk, nullptr, out, B, Sq, Hq, Hkv,
                               n_pages, page, max_pages, D, n_splits, scale,
                               stream);
}

extern "C" int gofr_paged_tree_i8(const void* q, const void* k_codes,
                                  const void* v_codes, const float* k_scales,
                                  const float* v_scales, const int* tables,
                                  const int* history, const int* chunk,
                                  const int* tree_masks, void* out, int B,
                                  int Sq, int Hq, int Hkv, int n_pages,
                                  int page, int max_pages, int D,
                                  int n_splits, float scale, void* stream) {
  return dispatch<true, true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                              history, chunk, tree_masks, out, B, Sq, Hq, Hkv,
                              n_pages, page, max_pages, D, n_splits, scale,
                              stream);
}
