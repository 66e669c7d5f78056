// Paged chunk and draft-tree verify attention for Hopper (sm_90a), plain
// and int8 pools: the bf16 wgmma kernel at head dims 64 and 128 below,
// and attn_simt.cuh's float32 kernel for every other head dim and for
// float16 and float32.
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
// design puts both products on wgmma and reads each input once per
// group of query heads:
//   - one block = one warpgroup (4 warps) per (split, tile of BQ query
//     positions, KV head, slot); the tile's BQ x group query rows are
//     packed into the 64 rows of the block (BQ = 64 / group: 16
//     positions x 4 heads for Llama-3.2-1B, 21 x 3 = 63 live rows at
//     group 3), exactly the M of wgmma.m64nNk16, so every K/V row brought
//     on chip serves all the query heads of its KV head;
//   - both products on the warpgroup core of wgmma_attn.cuh: S = Q K^T
//     with Q and K from shared memory, O += P V with P from registers
//     (the S accumulator re-packed) and V read MN-major from its
//     row-major tile; online softmax state float32 in registers, in
//     the log2 domain;
//   - split-KV: the block walks 64-row K/V tiles up to history +
//     min(end of its tile, chunk), the last position any of its rows
//     can see, and with S splits (grid x = S) split s takes
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
//     take the same S and the same walk: on causal masks the tree
//     kernel is the chunk kernel bit for bit;
//   - a tile wholly past chunk[b] writes zeros and exits without reading
//     the pool (uniform over its cluster: all its splits share the tile);
//     the grid is (split, slot x KV head, q tile) with the q tiles
//     last-first, so the longest walks of every slot start first;
//   - the Q tile and the K and V tiles are staged by 16-byte cp.async
//     into the 128-byte-swizzled layout wgmma reads (each copy writes
//     chunk c of row r at chunk c ^ (r & 7)); the K/V tiles are double
//     buffered (tile j + 1 in flight while tile j is multiplied) with one
//     block barrier a tile, and the table entries of a tile are read one
//     tile before its copies are issued; a thread's rows and staging offsets are the
//     same in every tile and computed once (page sizes are powers of
//     two: shifts, no division); a position past the walk limit is
//     zero-filled by the copy itself;
//   - the visibility test is one device function (`visible`): each of a
//     thread's two query rows carries its history, horizon and, for a
//     tree, its 32-bit ancestor mask, loaded once per block row. A
//     thread tests its 32 elements of a tile once, into a bit mask that
//     both softmax passes read; a tile that every live row sees in full
//     (below the history, or for a chunk below its first query
//     position) skips the test and the masking;
//   - up to 3 blocks share an SM at hd 64 (2 at hd 128), so one block's
//     softmax overlaps another's products and loads.
// The q tiles of one slot re-read its history: the K/V of a slot at
// 2048 rows is 4 MiB per layer, so the re-reads come from the 50 MB
// L2, not HBM. What bounds it now, at a 1024-row chunk: instruction
// issue, not the tensor cores — per tile and block, the softmax's
// per-element work (its exponentials on the SM's 16-wide
// special-function units among it) and the issue of 16 bytes of cp.async
// per thread and instruction take several times the two products'
// time, and the int8 form adds its widening pass; inside a block
// nothing overlaps one tile's softmax with the next tile's products.
// At a tree verify: a split's few dependent tiles and the cluster merge.
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
//   - the raw codes are staged (cp.async, through the same ring) and
//     widened in one pass into the swizzled bf16 K and V tiles: |code| <= 127 <
//     2^8, so a code converts to bf16 exactly (with integer and add
//     instructions, not the quarter-rate conversion units), and the
//     products run unchanged;
//   - S[i, j] = s_k[j] * sum_d q[i, d] c_k[j, d]: each S column is
//     multiplied by scale * s_k[pos] in the accumulator registers where
//     the bf16 kernel multiplies by scale; P V packs p * s_v[pos] into
//     its register A operand, while l sums the unscaled p;
//   - each tile's 64 K and 64 V scales are staged beside the codes from
//     the same clamped page id and offset; positions past the walk
//     limit get codes 0 and scale 0, so a masked position adds 0 * 0
//     and never 0 * a garbage scale (0 * inf = NaN).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_simt.cuh"
#include "paged_common.cuh"
#include "wgmma_attn.cuh"

namespace cg = cooperative_groups;

namespace {

using wgattn::BK;
using wgattn::NEG_INF;
using wgattn::NTHREADS;
using wgattn::ROWS;
using wgattn::STAGES;
using wgattn::swz;

constexpr int MAX_GROUP = 16;   // BQ = ROWS / group >= 4

// One query row of a chunk or tree: what it may see.
struct RowView {
  int q_pos;      // its absolute position, history + i; -1 for a padding row
  int kv_end;     // positions at or past this are not visible (0: padding)
  int hist;       // the slot's history length
  unsigned mask;  // tree only: bit j set iff in-chunk row j is an ancestor
                  // of this node or the node itself
};

// 16 int8 codes (one 16-byte word) -> 16 bf16 values, exactly: each
// byte b, biased to b + 128 >= 0, becomes the low byte of the float
// 2^23 + (b + 128), and subtracting 2^23 + 128 leaves b exactly; a
// float that is a small integer (|b| <= 128, at most 8 significant
// bits) is its own bf16, the upper half of its bits. lo holds codes
// 0-7, hi 8-15.
__device__ __forceinline__ void widen_codes(const uint4& w, uint4& lo,
                                            uint4& hi) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = in[i] ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __float_as_uint(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)) - 8388736.f);
    out[2 * i] = __byte_perm(f[0], f[1], 0x7632);
    out[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
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

// Shared-memory plan (byte offsets from the 1024-byte aligned base),
// shared by the kernel and its launcher. Swizzled bf16 [64][D] tiles:
// tile 0 is Q; bf16 pool: tiles 1 + 2 s and 2 + 2 s are stage s's K and V;
// int8 pool: tiles 1 and 2 are the widened K and V, then the raw code
// tiles [STAGES][K|V][BK * D] and the row scales [STAGES][K|V][BK].
// The merge's partials [ROWS][D + 8] + m, l [ROWS] reuse the start of
// the area after the walk. TOTAL adds the alignment slack.
template <int D, bool Q8>
struct Plan {
  static constexpr size_t TILE = (size_t)BK * D * 2;    // bytes, one tile
  static constexpr size_t RAW = (size_t)BK * D;         // bytes, one side
  static constexpr size_t RAW0 = 3 * TILE;
  static constexpr size_t SCALES = RAW0 + 2 * STAGES * RAW;
  static constexpr size_t STAGED = Q8 ? SCALES + 2 * STAGES * BK * 4
                                      : (1 + 2 * STAGES) * TILE;
  static constexpr size_t MERGE = (size_t)ROWS * (D + 8) * 4 + 2 * ROWS * 4;
  static constexpr size_t TOTAL = (STAGED > MERGE ? STAGED : MERGE) + 1024;
};

// Q8: the pages are int8 codes with a float32 scale per row
// (k_scales / v_scales [Hkv, Np, page, 1]); else bf16, scales unused.
template <int D, bool TREE, bool Q8>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 2)
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
            int Sq, int Hq, int Hkv, int n_pages, int page_shift,
            int max_pages, int n_splits, float scale) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  using P = Plan<D, Q8>;
  constexpr int CPR = D / 8;   // 16-byte chunks per bf16 row
  constexpr int EPL = 16 / sizeof(T);          // pool elements per 16-byte load
  constexpr int LPR = D / EPL;                 // 16-byte loads per pool row
  constexpr int PER = BK * LPR / NTHREADS;     // loads per thread per side per tile
  constexpr int NPID = PER + (Q8 ? 1 : 0);     // table entries a thread reads per tile
  constexpr int NH = D / 64;   // 64-column blocks of O (one wgmma each)
  static_assert(NTHREADS == 2 * BK, "one thread per K or V row scale");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = wgattn::align1024(smem_raw);
  auto tile = [&](int i) { return smem + (size_t)i * P::TILE; };
  int8_t* const raw = reinterpret_cast<int8_t*>(smem + P::RAW0);      // Q8
  float* const scl = reinterpret_cast<float*>(smem + P::SCALES);      // Q8

  const int group = Hq / Hkv;
  const int bq = ROWS / group;          // query positions per block
  // grid (split, slot x KV head, q tile): the q tiles run last-first
  // across every slot, so the longest walks start first
  const int split = blockIdx.x;
  const int qt = (int)gridDim.z - 1 - (int)blockIdx.z;
  const int hk = blockIdx.y % Hkv, b = blockIdx.y / Hkv;
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
  const int page = 1 << page_shift, in_page = page - 1;
  const int kv_limit = min(hist + min(i0 + bq, clen), max_pages * page);
  const int n_tiles = (kv_limit + BK - 1) / BK;
  const int per = (n_tiles + n_splits - 1) / n_splits;
  const int j0 = min(split * per, n_tiles), j1 = min(j0 + per, n_tiles);

  const size_t page_elems = (size_t)page * D;
  const T* kh = k_pool + (size_t)hk * n_pages * page_elems;
  const T* vh = v_pool + (size_t)hk * n_pages * page_elems;
  const int* table = tables + (size_t)b * max_pages;

  // this thread's share of every K/V tile, the same rows each time: load
  // k covers row rr[k] = (tid + k NTHREADS) / LPR at 16-byte column
  // tid % LPR, and for int8 entry PER is the row of its scale, tid % BK.
  // Tiles start at multiples of 64 rows, so a row's page is the tile's
  // first page plus rr >> page_shift, and its row in that page the
  // tile's first row in its page plus rr & in_page (one of the two terms
  // is 0 for any power-of-two page). Precomputed: the page step, the
  // element offset in the page, and the staging offset of each load.
  int rr[NPID], rpg[NPID], roff[NPID], sdst[PER];
#pragma unroll
  for (int k = 0; k < NPID; ++k) {
    const int c = k < PER ? tid % LPR : 0;
    rr[k] = k < PER ? (tid + k * NTHREADS) / LPR : tid % BK;
    rpg[k] = rr[k] >> page_shift;
    roff[k] = (rr[k] & in_page) * (k < PER ? D : 1) + c * EPL;
    if (k < PER) sdst[k] = Q8 ? rr[k] * D + c * 16 : swz(rr[k], c);
  }
  // the table ids of this thread's rows of the tile at c0 (-1: past the
  // walk limit)
  auto lookup = [&](int c0, int* pid) {
#pragma unroll
    for (int k = 0; k < NPID; ++k)
      pid[k] = c0 + rr[k] < kv_limit
          ? min(max(table[(c0 >> page_shift) + rpg[k]], 0), n_pages - 1) : -1;
  };
  // issue the copies of the tile at c0 into stage st: bf16 rows straight
  // into the swizzled tiles, int8 codes into the raw tiles
  auto issue = [&](int c0, const int* pid, int st) {
    const int first = c0 & in_page;   // the tile's first row in its page
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const size_t off = pid[k] >= 0
          ? (size_t)pid[k] * page_elems + (size_t)first * D + roff[k] : 0;
      const int n = pid[k] >= 0 ? 16 : 0;
      if (Q8) {
        cp_async16(raw + (2 * st) * P::RAW + sdst[k], kh + off, n);
        cp_async16(raw + (2 * st + 1) * P::RAW + sdst[k], vh + off, n);
      } else {
        cp_async16(tile(1 + 2 * st) + sdst[k], kh + off, n);
        cp_async16(tile(2 + 2 * st) + sdst[k], vh + off, n);
      }
    }
    if (Q8) {
      const int side = tid / BK, pid_s = pid[PER];
      const size_t srow = pid_s >= 0
          ? (((size_t)hk * n_pages + pid_s) << page_shift) + first + roff[PER] : 0;
      cp_async4(scl + (2 * st + side) * BK + rr[PER],
                (side ? v_scales : k_scales) + srow, pid_s >= 0 ? 4 : 0);
    }
  };

  // stage the Q tile (padding rows as zeros), and the walk's first
  // STAGES - 1 tiles, one commit group each (empty past the walk)
  for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR, qi = i0 + r / group;
    const bool live = r < live_rows && qi < clen;
    cp_async16(tile(0) + swz(r, c),
               live ? qb + (size_t)qi * q_rs + (r % group) * D + c * 8 : qb,
               live ? 16 : 0);
  }
  cp_async_commit();
  int pid[NPID];
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (j0 + t < j1) {
      lookup((j0 + t) * BK, pid);
      issue((j0 + t) * BK, pid, t);
    }
    cp_async_commit();
  }
  if (j0 + STAGES - 1 < j1) lookup((j0 + STAGES - 1) * BK, pid);

  // this thread's two rows (e >> 1 of every accumulator n-tile)
  const int wr = warp * 16;
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

  float o[NH][8][4], s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h) o[h][n][e] = 0.f;
    }
  }
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  const float lg2 = scale * wgattn::LOG2E;

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) % STAGES;
    cp_async_wait<STAGES - 2>();
    wgattn::fence_proxy_async();
    // tile j (and the Q tile) staged by every thread, and every warp done
    // with tile j - 1: its stage takes tile j + STAGES - 1, whose table
    // entries were read a tile ago
    __syncthreads();
    if (j + STAGES - 1 < j1) {
      issue((j + STAGES - 1) * BK, pid, (st + STAGES - 1) % STAGES);
      if (j + STAGES < j1) lookup((j + STAGES) * BK, pid);
    }
    cp_async_commit();
    const int c0 = j * BK;
    const unsigned char* ks;
    const unsigned char* vs;
    const float* kss = scl + (2 * st) * BK;
    const float* vss = kss + BK;
    if (Q8) {
      // widen the raw codes once: 16 codes -> two 16-byte bf16 chunks
      const int8_t* kr = raw + (2 * st) * P::RAW;
      const int8_t* vr = kr + P::RAW;
#pragma unroll
      for (int t = 0; t < BK * D / 16 / NTHREADS; ++t) {
        const int i = tid + t * NTHREADS, r = i / (D / 16), c = 2 * (i % (D / 16));
        uint4 lo, hi;
        widen_codes(*reinterpret_cast<const uint4*>(kr + 16 * i), lo, hi);
        *reinterpret_cast<uint4*>(tile(1) + swz(r, c)) = lo;
        *reinterpret_cast<uint4*>(tile(1) + swz(r, c + 1)) = hi;
        widen_codes(*reinterpret_cast<const uint4*>(vr + 16 * i), lo, hi);
        *reinterpret_cast<uint4*>(tile(2) + swz(r, c)) = lo;
        *reinterpret_cast<uint4*>(tile(2) + swz(r, c + 1)) = hi;
      }
      wgattn::fence_proxy_async();
      __syncthreads();   // the widened tiles, read by this tile's products
      ks = tile(1);
      vs = tile(2);
    } else {
      ks = tile(1 + 2 * st);
      vs = tile(2 + 2 * st);
    }

    // S = Q K^T for the block's 64 rows x 64 positions
    wgattn::qk<D>(s, tile(0), ks);

    // which of this thread's 32 S elements its rows see: bit 4 n + e.
    // A tile wholly below the horizon and below the history (a tree) or
    // at or below the tile's first query position (a chunk) is seen in
    // full by every live row and skips the test and the masking (padding
    // rows then carry junk that is never written: the same live rows, bit
    // for bit, as the test would give)
    // the online-softmax update; an int8 tile scales S column col by
    // scale * s_k[col] and carries p * s_v[col] into P V
    auto lg = [&](int col) { return Q8 ? lg2 * kss[col] : lg2; };
    auto pw = [&](int col) { return Q8 ? vss[col] : 1.f; };
    uint32_t pa[4][4];
    if (c0 + BK <= min(TREE ? hist : hist + i0 + 1, kv_end)) {
      wgattn::softmax_tile<true>(s, 0u, lg, pw, m, l, o, pa);
    } else {
      uint32_t vis = 0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (visible<TREE>(rows[e >> 1], c0 + n * 8 + tig * 2 + (e & 1)))
            vis |= 1u << (4 * n + e);
      wgattn::softmax_tile<false>(s, vis, lg, pw, m, l, o, pa);
    }

    // O += P V from the row-major V tile
    wgattn::pv<D>(o, pa, vs);
  }
  cp_async_wait<0>();

  wgattn::reduce_rows(l);
  if (n_splits == 1) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = wr + gid + 8 * t, qi = i0 + r / group;
      if (r >= live_rows || qi >= Sq) continue;
      // padding rows (q_pos -1) write zeros; a live row divides by max(l, 1e-30)
      const float inv = rows[t].q_pos >= 0 ? 1.f / fmaxf(l[t], 1e-30f) : 0.f;
      __nv_bfloat16* orow = ob + (size_t)qi * q_rs + (r % group) * D;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int d = h * 64 + n * 8 + tig * 2;
          *reinterpret_cast<uint32_t*>(orow + d) = wgattn::pack_bf16x2(
              o[h][n][2 * t] * inv, o[h][n][2 * t + 1] * inv);
        }
    }
    return;
  }

  // split-KV: leave this split's partial (o unnormalized, m in log2
  // units, l per row) in shared memory, then merge the S partials of the
  // q tile in split order; split r writes every S-th group of NTHREADS
  // column pairs
  __syncthreads();   // every warp is done with the staged tiles
  constexpr int OP = D + 8;   // padded float row stride of the partial o
  float* const po = reinterpret_cast<float*>(smem);
  float* const pm = po + ROWS * OP;
  float* const pl = pm + ROWS;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = wr + gid + 8 * t;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(po + r * OP + h * 64 + n * 8 + tig * 2) =
            make_float2(o[h][n][2 * t], o[h][n][2 * t + 1]);
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
        const float w = wgattn::ex2(cluster.map_shared_rank(pm, sp)[r] - M);
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
        wgattn::pack_bf16x2(o0, o1);
  }
  cluster.sync();   // no split leaves while another still reads it
}

template <int D, bool TREE, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* history, const int* chunk, const int* tree_masks,
           void* out, int B, int Sq, int Hq, int Hkv, int n_pages,
           int page_shift, int max_pages, int n_splits, float scale,
           cudaStream_t s) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  const int bq = ROWS / (Hq / Hkv);
  const dim3 grid(n_splits, Hkv * B, (Sq + bq - 1) / bq);
  return launch_split(
      paged_chunk<D, TREE, Q8>, grid, NTHREADS, Plan<D, Q8>::TOTAL, n_splits,
      s, static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), k_scales, v_scales, tables, history,
      chunk, tree_masks, static_cast<__nv_bfloat16*>(out), Sq, Hq, Hkv,
      n_pages, page_shift, max_pages, n_splits, scale);
}

template <bool TREE, bool Q8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scales, const float* v_scales, const int* tables,
             const int* history, const int* chunk, const int* tree_masks,
             void* out, int B, int Sq, int Hq, int Hkv, int n_pages, int page,
             int max_pages, int D, int dtype, int n_splits, float scale,
             void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > MAX_GROUP || n_pages <= 0 || page <= 0 ||
      (page & (page - 1)) != 0 || max_pages <= 0 ||
      (long)B * Hkv > 65535 || (Sq + ROWS / (Hq / Hkv) - 1) / (ROWS / (Hq / Hkv)) > 65535 ||
      (TREE && Sq > 32) || n_splits < 1 || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype != simt::BF16 || (D != 64 && D != 128)) {
    // every other type and head dim: one block walks a q tile's
    // positions alone (n_splits is not read)
    simt::Args a = {};
    a.q = q;
    a.k = k_pool;
    a.v = v_pool;
    a.k_scales = Q8 ? k_scales : nullptr;
    a.v_scales = Q8 ? v_scales : nullptr;
    a.tables = tables;
    a.len_a = history;
    a.len_b = chunk;
    a.tree_masks = tree_masks;
    a.out = out;
    a.B = B;
    a.Sq = Sq;
    a.Hq = Hq;
    a.Hkv = Hkv;
    a.D = D;
    a.n_pages = n_pages;
    a.page = page;
    a.max_pages = max_pages;
    a.mode = TREE ? simt::TREE : simt::CHUNK;
    a.scale = scale;
    return simt::run<true>(a, dtype, s);
  }
  const int page_shift = __builtin_ctz((unsigned)page);   // page = 2^shift
  if (D == 64)
    return launch<64, TREE, Q8>(q, k_pool, v_pool, k_scales, v_scales, tables,
                                history, chunk, tree_masks, out, B, Sq, Hq,
                                Hkv, n_pages, page_shift, max_pages, n_splits,
                                scale, s);
  return launch<128, TREE, Q8>(q, k_pool, v_pool, k_scales, v_scales, tables,
                               history, chunk, tree_masks, out, B, Sq, Hq,
                               Hkv, n_pages, page_shift, max_pages, n_splits,
                               scale, s);
}

}  // namespace

// C interface (bound with ctypes). q [B, Sq, Hq, D] and out [B, Sq, Hq, D]
// of the activation type `dtype` (0 bf16, 1 float16, 2 float32), pools
// [Hkv, Np, page, D] of the same type (one layer, contiguous), tables
// int32 [B, max_pages], history and chunk int32 [B]; all aligned as the
// kernels read them; n_splits (1-8) blocks share each q tile's walk. bf16
// at D = 64 or 128 runs the wgmma kernel above; every other type and
// head dim (a multiple of 4 from 16 to 256) the float32 kernel of
// attn_simt.cuh, unsplit. Returns the launch's cudaError_t (0 =
// launched), or cudaErrorInvalidValue for a shape the kernels do not
// take.
extern "C" int gofr_paged_chunk(const void* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* history, const int* chunk,
                                void* out, int B, int Sq, int Hq, int Hkv,
                                int n_pages, int page, int max_pages, int D,
                                int dtype, int n_splits, float scale,
                                void* stream) {
  return dispatch<false, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                history, chunk, nullptr, out, B, Sq, Hq, Hkv,
                                n_pages, page, max_pages, D, dtype, n_splits,
                                scale, stream);
}

// The same, for draft-tree verify: tree_masks int32 [B, Sq] packs each
// node's ancestor-or-self set over the in-chunk node index; Sq <= 32.
extern "C" int gofr_paged_tree(const void* q, const void* k_pool,
                               const void* v_pool, const int* tables,
                               const int* history, const int* chunk,
                               const int* tree_masks, void* out, int B,
                               int Sq, int Hq, int Hkv, int n_pages, int page,
                               int max_pages, int D, int dtype, int n_splits,
                               float scale, void* stream) {
  return dispatch<true, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                               history, chunk, tree_masks, out, B, Sq, Hq,
                               Hkv, n_pages, page, max_pages, D, dtype,
                               n_splits, scale, stream);
}

// The chunk and tree entries over an int8 pool: k_codes / v_codes int8
// [Hkv, Np, page, D], k_scales / v_scales float32 [Hkv, Np, page, 1].
extern "C" int gofr_paged_chunk_i8(const void* q, const void* k_codes,
                                   const void* v_codes, const float* k_scales,
                                   const float* v_scales, const int* tables,
                                   const int* history, const int* chunk,
                                   void* out, int B, int Sq, int Hq, int Hkv,
                                   int n_pages, int page, int max_pages, int D,
                                   int dtype, int n_splits, float scale,
                                   void* stream) {
  return dispatch<false, true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                               history, chunk, nullptr, out, B, Sq, Hq, Hkv,
                               n_pages, page, max_pages, D, dtype, n_splits,
                               scale, stream);
}

extern "C" int gofr_paged_tree_i8(const void* q, const void* k_codes,
                                  const void* v_codes, const float* k_scales,
                                  const float* v_scales, const int* tables,
                                  const int* history, const int* chunk,
                                  const int* tree_masks, void* out, int B,
                                  int Sq, int Hq, int Hkv, int n_pages,
                                  int page, int max_pages, int D, int dtype,
                                  int n_splits, float scale, void* stream) {
  return dispatch<true, true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                              history, chunk, tree_masks, out, B, Sq, Hq, Hkv,
                              n_pages, page, max_pages, D, dtype, n_splits,
                              scale, stream);
}
