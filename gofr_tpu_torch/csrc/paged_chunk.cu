// Paged chunk and draft-tree verify attention for Hopper (sm_90a), plain
// and int8 pools: the wgmma kernel below for bf16 and float16 at every
// head dim the kernels take (a multiple of 4 from 16 to 256), and
// attn_simt.cuh's float32 kernel for float32 (kept in float32: TF32 is
// not JAX's float32).
//
// Replaces the Pallas TPU kernels gofr_tpu/ops/paged_attention.py
// `_paged_chunk_kernel` (wrapper `paged_chunk_attention_pallas`) and
// `_paged_tree_kernel` (wrapper `paged_tree_attention_pallas`), both
// branches of each: a pool in the activation type, and the quantized {q:
// int8, s: f32 [.., 1]} pool (`quantized=True`, C entries
// gofr_paged_chunk_i8 and gofr_paged_tree_i8). The two are one kernel
// body templated on its visibility rule (and on the pool's form, the
// 16-bit type and the padded head dim), with one C entry point each:
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
// bound by the tensor cores (989 TFLOP/s bf16 and float16); a short
// prefix-cache suffix (a few rows over ~900 history rows) and a tree
// verify (at most 32 rows over the history) do ~25-130 flops per byte
// and are bound by HBM (3.35 TB/s), reading the history once. So the
// design puts both products on wgmma and reads each input once per
// group of query heads:
//   - one block = one warpgroup (4 warps) per (split, tile of BQ query
//     positions, KV head, slot); the tile's BQ x group query rows are
//     packed into the 64 rows of the block (BQ = 64 / group: 16
//     positions x 4 heads for Llama-3.2-1B, 21 x 3 = 63 live rows at
//     group 3), exactly the M of wgmma.m64nNk16, so every K/V row brought
//     on chip serves all the query heads of its KV head. A group above
//     16 heads (BQ >= 4) is cut into sub-groups of the same KV head
//     (paged_common.cuh `sub_groups`), one block each;
//   - both products on the warpgroup core of wgmma_attn.cuh in the
//     activations' 16-bit type: S = Q K^T with Q and K from shared
//     memory, O += P V with P from registers (the S accumulator re-packed,
//     P rounded to that type) and V read MN-major from its row-major tile;
//     online softmax state float32 in registers, in the log2 domain. A
//     head dim that is not a multiple of 64 is staged at DP, the next
//     multiple (100 -> 128): the zero columns of Q and K leave S as it
//     is, V's extra output columns are never stored, and HBM still reads
//     only the D real columns; the padding costs tensor work (28 % at
//     D 100), not bytes, and these kernels are issue-bound (below);
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
//     the grid is (split, slot x KV head x sub-group, q tile) with the q
//     tiles last-first, so the longest walks of every slot start first;
//   - the Q tile and the K and V tiles are staged by cp.async into the
//     128-byte-swizzled layout wgmma reads (each copy writes chunk c of
//     row r at chunk c ^ (r & 7)), 16 bytes a copy, or 8 where a row's
//     bytes are not a multiple of 16 (D 100: 200 bytes), columns past D
//     zero-filled by the copy itself; the K/V tiles are double
//     buffered (tile j + 1 in flight while tile j is multiplied) with one
//     block barrier a tile. At D 64 / 128 with 16-byte copies (EXACT) a
//     thread's rows and staging offsets are the same in every tile and
//     computed once, and the table entries of its copies are read one
//     tile before they are issued, into registers; at the other widths
//     (up to 32 copies a thread a tile) the table entries of a tile's 64
//     rows are read two tiles ahead, by one thread a row, held in a
//     register over a tile's math and published to shared memory (two
//     slots) before the next barrier, so a thread holds no per-copy
//     state across the tile. Page sizes are powers of two (shifts, no
//     division); a position past the walk limit is zero-filled by the
//     copy itself;
//   - the visibility test is one device function (`visible`): each of a
//     thread's two query rows carries its history, horizon and, for a
//     tree, its 32-bit ancestor mask, loaded once per block row. A
//     thread tests its 32 elements of a tile once, into a bit mask that
//     both softmax passes read; a tile that every live row sees in full
//     (below the history, or for a chunk below its first query
//     position) skips the test and the masking;
//   - up to 3 blocks share an SM at DP 64 (2 at DP 128, 1 above, where
//     a thread holds DP / 2 floats of O), so one block's softmax overlaps
//     another's products and loads.
// The q tiles of one slot re-read its history: the K/V of a slot at
// 2048 rows is 4 MiB per layer, so the re-reads come from the 50 MB
// L2, not HBM. What bounds it now, at a 1024-row chunk: instruction
// issue, not the tensor cores — per tile and block, the softmax's
// per-element work (its exponentials on the SM's 16-wide
// special-function units among it) and the issue of the cp.async
// copies take several times the two products' time, and the int8 form
// adds its widening pass; inside a block nothing overlaps one tile's
// softmax with the next tile's products. At a tree verify: a split's few
// dependent tiles and the cluster merge.
//
// The int8 pool. A row stands for codes * scale, one float32 scale per
// row, and the function is the TPU kernel's: k = codes * s_k and v =
// codes * s_v in float32, then both products. Its bound is the same
// kind, with hd + 4 bytes per row per side instead of 2 * hd (about
// 0.53x the bytes at hd 64), so the short suffixes and tree verifies
// that HBM bounds move about half the bytes. The design keeps the 16-bit
// tensor-core path and folds the scales out of both products instead
// of dequantizing into the 16-bit type, which would round every c * s
// (an error neither the float32 plain version nor the TPU kernel has):
//   - the raw codes are staged (cp.async, through the same ring, 16, 8
//     or 4 bytes a copy) and widened in one pass into the swizzled K and
//     V tiles: |code| <= 127, so a code converts to bf16 or float16
//     exactly (with integer and add instructions, not the quarter-rate
//     conversion units), and the products run unchanged;
//   - S[i, j] = s_k[j] * sum_d q[i, d] c_k[j, d]: each S column is
//     multiplied by scale * s_k[pos] in the accumulator registers where
//     the plain-pool kernel multiplies by scale; P V packs p * s_v[pos]
//     into its register A operand, while l sums the unscaled p;
//   - each tile's 64 K and 64 V scales are staged beside the codes from
//     the same clamped page id and offset; positions past the walk
//     limit get codes 0 and scale 0, so a masked position adds 0 * 0
//     and never 0 * a garbage scale (0 * inf = NaN).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "act_types.cuh"
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

constexpr int MAX_GROUP = 16;   // heads a block holds: BQ = ROWS / group >= 4
static_assert(STAGES == 2, "the table slots and the ring assume two stages");

// the bytes of one staging copy, as a type (the copy loops unroll on it)
template <int V>
struct Vec {
  static constexpr int value = V;
};

// One query row of a chunk or tree: what it may see.
struct RowView {
  int q_pos;      // its absolute position, history + i; -1 for a padding row
  int kv_end;     // positions at or past this are not visible (0: padding)
  int hist;       // the slot's history length
  unsigned mask;  // tree only: bit j set iff in-chunk row j is an ancestor
                  // of this node or the node itself
};

// 16 int8 codes (one 16-byte word) -> 16 values of T, exactly; lo holds
// codes 0-7, hi 8-15. bf16: each byte b, biased to b + 128 >= 0, becomes
// the low byte of the float 2^23 + (b + 128), and subtracting 2^23 + 128
// leaves b exactly; a float that is a small integer (|b| <= 128, at most
// 8 significant bits) is its own bf16, the upper half of its bits.
// float16: the biased byte is the low byte of the half 1024 + (b + 128)
// (exponent 10, ulp 1), and subtracting 1152 leaves b exactly.
template <typename T>
__device__ __forceinline__ void widen_codes(const uint4& w, uint4& lo,
                                            uint4& hi) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = in[i] ^ 0x80808080u;
    if constexpr (std::is_same<T, __half>::value) {
      const __half2 bias = __floats2half2_rn(1152.f, 1152.f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t h = __byte_perm(u, 0x64646464u, e ? 0x4342 : 0x4140);
        __half2 v = __hsub2(*reinterpret_cast<__half2*>(&h), bias);
        out[2 * i + e] = *reinterpret_cast<uint32_t*>(&v);
      }
    } else {
      uint32_t f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = __float_as_uint(
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)) - 8388736.f);
      out[2 * i] = __byte_perm(f[0], f[1], 0x7632);
      out[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
    }
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
// shared by the kernel and its launcher. Swizzled 16-bit [64][DP] tiles:
// tile 0 is Q; plain pool: tiles 1 + 2 s and 2 + 2 s are stage s's K and
// V; int8 pool: tiles 1 and 2 are the widened K and V, then the raw code
// tiles [STAGES][K|V][BK][DP] and the row scales [STAGES][K|V][BK]. Then
// the two slots of table entries [2][BK]. The merge's partials [ROWS][DP
// + 8] + m, l [ROWS] reuse the start of the area after the walk. TOTAL
// adds the alignment slack.
template <int DP, bool Q8>
struct Plan {
  static constexpr size_t TILE = (size_t)BK * DP * 2;   // bytes, one tile
  static constexpr size_t RAW = (size_t)BK * DP;        // bytes, one side
  static constexpr size_t RAW0 = 3 * TILE;
  static constexpr size_t SCALES = RAW0 + 2 * STAGES * RAW;
  static constexpr size_t PIDS = Q8 ? SCALES + 2 * STAGES * BK * 4
                                    : (1 + 2 * STAGES) * TILE;
  static constexpr size_t STAGED = PIDS + 2 * BK * 4;
  static constexpr size_t MERGE = (size_t)ROWS * (DP + 8) * 4 + 2 * ROWS * 4;
  static constexpr size_t TOTAL = (STAGED > MERGE ? STAGED : MERGE) + 1024;
};

// T: q / out (and a plain pool's) type, bf16 or float16. Q8: the pages
// are int8 codes with a float32 scale per row (k_scales / v_scales [Hkv,
// Np, page, 1]); else of type T, scales unused. DP: the staged head dim
// (D rounded up to 64); d_in: the call's head dim; vec_q_in / vec_kv_in:
// the bytes of one staging copy of a q row and of a pool row; n_sub: the
// sub-groups of a group. EXACT: d_in is DP and every copy is 16 bytes,
// all fixed when compiled, and a thread's copies of a tile keep their
// rows, offsets and table ids in registers (the 16-bit types at D 64 /
// 128: the kernel as it was before it took other head dims).
template <typename T, int DP, bool TREE, bool Q8, bool EXACT>
__global__ void __launch_bounds__(NTHREADS, DP == 64 ? 3 : DP == 128 ? 2 : 1)
paged_chunk(const T* __restrict__ q,
            const std::conditional_t<Q8, int8_t, T>* __restrict__ k_pool,
            const std::conditional_t<Q8, int8_t, T>* __restrict__ v_pool,
            const float* __restrict__ k_scales,
            const float* __restrict__ v_scales,
            const int* __restrict__ tables,
            const int* __restrict__ history,
            const int* __restrict__ chunk,
            const int* __restrict__ tree_masks,   // [B, Sq]; unused for a chunk
            T* __restrict__ out,
            int Sq, int Hq, int Hkv, int d_in, int n_pages, int page_shift,
            int max_pages, int n_splits, int n_sub, int vec_q_in,
            int vec_kv_in, float scale) {
  using PT = std::conditional_t<Q8, int8_t, T>;
  const int D = EXACT ? DP : d_in;
  const int vec_q = EXACT ? 16 : vec_q_in;
  const int vec_kv = EXACT ? 16 : vec_kv_in;
  using P = Plan<DP, Q8>;
  constexpr int NH = DP / 64;   // 64-column blocks of O (one wgmma each)
  static_assert(NTHREADS == 2 * BK, "one thread per K or V row scale");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = wgattn::align1024(smem_raw);
  auto tile = [&](int i) { return smem + (size_t)i * P::TILE; };
  int8_t* const raw = reinterpret_cast<int8_t*>(smem + P::RAW0);      // Q8
  float* const scl = reinterpret_cast<float*>(smem + P::SCALES);      // Q8
  int* const tpid = reinterpret_cast<int*>(smem + P::PIDS);           // [2][BK]

  const int group = Hq / Hkv;
  const SubGroups sg = sub_groups(group, MAX_GROUP);
  const int bq = ROWS / sg.size;        // query positions per block
  // grid (split, (slot x KV head) x sub-group, q tile): the q tiles run
  // last-first across every slot, so the longest walks start first
  const int split = blockIdx.x;
  const int qt = (int)gridDim.z - 1 - (int)blockIdx.z;
  // (slot x KV head) and sub-group of this block; one sub-group: no division
  const int item = n_sub == 1 ? (int)blockIdx.y : (int)blockIdx.y / n_sub;
  const int hk = item % Hkv, b = item / Hkv;
  const int head0 = n_sub == 1 ? 0 : (int)blockIdx.y % n_sub * sg.size;
  const int gs = min(sg.size, group - head0);   // this block's query heads
  const int live_rows = bq * sg.size;   // block rows holding a query row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int i0 = qt * bq;               // first query index of the tile
  const int hist = max(history[b], 0);
  const int clen = min(max(chunk[b], 0), Sq);
  // block row r is query index i0 + r / sg.size, head head0 + r % sg.size
  // of the KV head's group; the heads of one query index are contiguous
  // in q and out
  auto row_live = [&](int r, int qi, int lim) {
    return r < live_rows && (n_sub == 1 || r % sg.size < gs) && qi < lim;
  };

  const size_t q_rs = (size_t)Hq * D;
  const size_t head_base = (size_t)b * Sq * q_rs + ((size_t)hk * group + head0) * D;
  const T* qb = q + head_base;
  T* ob = out + head_base;

  if (i0 >= clen) {   // the whole tile is padding (every split of it)
    if (split == 0) {
      // zeros in 16-byte stores where q's rows take 16-byte copies (out
      // is aligned as q is), else in 8-byte ones
      auto zero_rows = [&](auto word) {
        using W = decltype(word);
        constexpr int EPW = sizeof(W) / 2;   // elements a store
        for (int i = tid; i < ROWS * (D / EPW); i += NTHREADS) {
          const int r = i / (D / EPW), c = i % (D / EPW), qi = i0 + r / sg.size;
          if (row_live(r, qi, Sq))
            *reinterpret_cast<W*>(ob + (size_t)qi * q_rs + (r % sg.size) * D + c * EPW) =
                word;
        }
      };
      if (vec_q == 16)
        zero_rows(make_uint4(0u, 0u, 0u, 0u));
      else
        zero_rows(make_uint2(0u, 0u));
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
  const PT* kh = k_pool + (size_t)hk * n_pages * page_elems;
  const PT* vh = v_pool + (size_t)hk * n_pages * page_elems;
  const int* table = tables + (size_t)b * max_pages;

  // the table id of row tid (< BK) of tile j (-1: past the walk limit);
  // slot j & 1 of tpid holds tile j's
  auto fetch = [&](int j) {
    const int pos = j * BK + tid;
    return pos < kv_limit ? min(max(table[pos >> page_shift], 0), n_pages - 1)
                          : -1;
  };
  // issue the copies of tile j into stage st: VEC-byte copies, PW of them
  // covering a staged row of DP columns, of which those past D are
  // zero-filled; plain rows straight into the swizzled tiles, int8 codes
  // into the raw tiles
  auto issue_vec = [&](auto vec_tag, int j, int st) {
    constexpr int VEC = decltype(vec_tag)::value;
    constexpr int PW = DP * (int)sizeof(PT) / VEC;
    constexpr int EPV = VEC / (int)sizeof(PT);
    const int np = D / EPV;   // copies holding real columns
    const int* pids = tpid + (j & 1) * BK;
    const int first = (j * BK) & in_page;   // the tile's first row in its page
    wgattn::for_each<BK * PW / NTHREADS, DP <= 128>([&](int k) {
      const int i = tid + k * NTHREADS, r = i / PW, p = i % PW;
      const int pid = pids[r];
      const bool ok = pid >= 0 && p < np;
      const size_t off = ok
          ? (size_t)pid * page_elems + (size_t)((first + r) & in_page) * D + p * EPV
          : 0;
      const int n = ok ? VEC : 0;
      if (Q8) {
        cp_async_vec(raw + (2 * st) * P::RAW + r * DP + p * VEC, kh + off, VEC, n);
        cp_async_vec(raw + (2 * st + 1) * P::RAW + r * DP + p * VEC, vh + off, VEC, n);
      } else {
        const int dst = swz(r, p * VEC / 16) + p * VEC % 16;
        cp_async_vec(tile(1 + 2 * st) + dst, kh + off, VEC, n);
        cp_async_vec(tile(2 + 2 * st) + dst, vh + off, VEC, n);
      }
    });
    if (Q8) {
      const int side = tid / BK, r = tid % BK, pid_s = pids[r];
      const size_t srow = pid_s >= 0
          ? (((size_t)hk * n_pages + pid_s) << page_shift) + ((first + r) & in_page) : 0;
      cp_async4(scl + (2 * st + side) * BK + r,
                (side ? v_scales : k_scales) + srow, pid_s >= 0 ? 4 : 0);
    }
  };
  auto issue = [&](int j, int st) {
    if (vec_kv == 16) {
      issue_vec(Vec<16>(), j, st);
    } else if constexpr (Q8) {
      if (vec_kv == 8)
        issue_vec(Vec<8>(), j, st);
      else
        issue_vec(Vec<4>(), j, st);
    } else {
      issue_vec(Vec<8>(), j, st);
    }
  };
  // stage the Q tile (padding rows and columns past D as zeros)
  auto stage_q = [&](auto vec_tag) {
    constexpr int VEC = decltype(vec_tag)::value;
    constexpr int PW = DP * 2 / VEC, EPV = VEC / 2;
    const int np = D / EPV;
    for (int i = tid; i < ROWS * PW; i += NTHREADS) {
      const int r = i / PW, p = i % PW, qi = i0 + r / sg.size;
      const bool live = row_live(r, qi, clen) && p < np;
      cp_async_vec(tile(0) + swz(r, p * VEC / 16) + p * VEC % 16,
                   live ? qb + (size_t)qi * q_rs + (r % sg.size) * D + p * EPV : qb,
                   VEC, live ? VEC : 0);
    }
  };

  // EXACT: this thread's share of every K/V tile, the same rows each time:
  // load k covers row rr[k] = (tid + k NTHREADS) / LPR at 16-byte column
  // tid % LPR, and for int8 entry PER is the row of its scale, tid % BK.
  // Tiles start at multiples of 64 rows, so a row's page is the tile's
  // first page plus rr >> page_shift, and its row in that page the tile's
  // first row in its page plus rr & in_page (one of the two terms is 0
  // for any power-of-two page). Precomputed: the page step, the element
  // offset in the page, and the staging offset of each load; the table
  // ids of a tile are read a tile before its copies, into registers.
  constexpr int LPR = DP * (int)sizeof(PT) / 16;   // 16-byte loads a row
  constexpr int PER = BK * LPR / NTHREADS;
  constexpr int NPID = EXACT ? PER + (Q8 ? 1 : 0) : 1;
  int rr[NPID], rpg[NPID], roff[NPID], sdst[NPID], pid[NPID];
  if constexpr (EXACT) {
#pragma unroll
    for (int k = 0; k < NPID; ++k) {
      const int c = k < PER ? tid % LPR : 0;
      rr[k] = k < PER ? (tid + k * NTHREADS) / LPR : tid % BK;
      rpg[k] = rr[k] >> page_shift;
      roff[k] = (rr[k] & in_page) * (k < PER ? DP : 1) + c * (16 / (int)sizeof(PT));
      if (k < PER) sdst[k] = Q8 ? rr[k] * DP + c * 16 : swz(rr[k], c);
    }
  }
  auto lookup_x = [&](int c0) {
#pragma unroll
    for (int k = 0; k < NPID; ++k)
      pid[k] = c0 + rr[k] < kv_limit
          ? min(max(table[(c0 >> page_shift) + rpg[k]], 0), n_pages - 1) : -1;
  };
  auto issue_x = [&](int c0, int st) {
    const int first = c0 & in_page;   // the tile's first row in its page
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const size_t off = pid[k] >= 0
          ? (size_t)pid[k] * page_elems + (size_t)first * DP + roff[k] : 0;
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
      const int side = tid / BK, pid_s = pid[NPID - 1];
      const size_t srow = pid_s >= 0
          ? (((size_t)hk * n_pages + pid_s) << page_shift) + first + roff[NPID - 1] : 0;
      cp_async4(scl + (2 * st + side) * BK + rr[NPID - 1],
                (side ? v_scales : k_scales) + srow, pid_s >= 0 ? 4 : 0);
    }
  };

  // the Q tile, the first tiles' table entries and the first tile, one
  // commit group each
  if (vec_q == 16)
    stage_q(Vec<16>());
  else
    stage_q(Vec<8>());
  cp_async_commit();
  if constexpr (EXACT) {
    if (j0 < j1) {
      lookup_x(j0 * BK);
      issue_x(j0 * BK, 0);
    }
    cp_async_commit();
    if (j0 + 1 < j1) lookup_x((j0 + 1) * BK);
  } else {
    if (tid < BK) {
      if (j0 < j1) tpid[(j0 & 1) * BK + tid] = fetch(j0);
      if (j0 + 1 < j1) tpid[((j0 + 1) & 1) * BK + tid] = fetch(j0 + 1);
    }
    __syncthreads();   // the table slots
    if (j0 < j1) issue(j0, 0);
    cp_async_commit();
  }

  // this thread's two rows (e >> 1 of every accumulator n-tile)
  const int wr = warp * 16;
  const int kv_end = min(hist + clen, max_pages * page);
  RowView rows[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = wr + gid + 8 * t, qi = i0 + r / sg.size;
    const bool live = row_live(r, qi, clen);
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
  // tile j + 2's table entry of row tid, read at tile j (its load waits
  // out the tile's math in a register) and published at tile j + 1
  int pending = -1;

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) % STAGES;
    cp_async_wait<STAGES - 2>();
    wgattn::fence_proxy_async();
    // slot (j + 1) & 1 was last read by tile j - 1's copies, issued
    // before the previous barrier
    if (!EXACT && tid < BK && j > j0 && j + 1 < j1)
      tpid[((j + 1) & 1) * BK + tid] = pending;
    // tile j (and the Q tile) staged by every thread, every warp done
    // with tile j - 1 (its stage takes tile j + 1), tile j + 1's table
    // entries published
    __syncthreads();
    if constexpr (EXACT) {
      if (j + 1 < j1) {
        issue_x((j + 1) * BK, (st + 1) % STAGES);
        if (j + 2 < j1) lookup_x((j + 2) * BK);
      }
      cp_async_commit();
    } else {
      if (j + 1 < j1) issue(j + 1, (st + 1) % STAGES);
      cp_async_commit();
      if (tid < BK && j + 2 < j1) pending = fetch(j + 2);
    }
    const int c0 = j * BK;
    const unsigned char* ks;
    const unsigned char* vs;
    const float* kss = scl + (2 * st) * BK;
    const float* vss = kss + BK;
    if (Q8) {
      // widen the raw codes once: 16 codes -> two 16-byte chunks of T
      const int8_t* kr = raw + (2 * st) * P::RAW;
      const int8_t* vr = kr + P::RAW;
      wgattn::for_each<BK * DP / 16 / NTHREADS, DP <= 128>([&](int t) {
        const int i = tid + t * NTHREADS, r = i / (DP / 16), c = 2 * (i % (DP / 16));
        uint4 lo, hi;
        widen_codes<T>(*reinterpret_cast<const uint4*>(kr + 16 * i), lo, hi);
        *reinterpret_cast<uint4*>(tile(1) + swz(r, c)) = lo;
        *reinterpret_cast<uint4*>(tile(1) + swz(r, c + 1)) = hi;
        widen_codes<T>(*reinterpret_cast<const uint4*>(vr + 16 * i), lo, hi);
        *reinterpret_cast<uint4*>(tile(2) + swz(r, c)) = lo;
        *reinterpret_cast<uint4*>(tile(2) + swz(r, c + 1)) = hi;
      });
      wgattn::fence_proxy_async();
      __syncthreads();   // the widened tiles, read by this tile's products
      ks = tile(1);
      vs = tile(2);
    } else {
      ks = tile(1 + 2 * st);
      vs = tile(2 + 2 * st);
    }

    // S = Q K^T for the block's 64 rows x 64 positions
    wgattn::qk<T, DP>(s, tile(0), ks);

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
      wgattn::softmax_tile<T, true>(s, 0u, lg, pw, m, l, o, pa);
    } else {
      uint32_t vis = 0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (visible<TREE>(rows[e >> 1], c0 + n * 8 + tig * 2 + (e & 1)))
            vis |= 1u << (4 * n + e);
      wgattn::softmax_tile<T, false>(s, vis, lg, pw, m, l, o, pa);
    }

    // O += P V from the row-major V tile
    wgattn::pv<T, DP>(o, pa, vs);
  }
  cp_async_wait<0>();

  wgattn::reduce_rows(l);
  if (n_splits == 1) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = wr + gid + 8 * t, qi = i0 + r / sg.size;
      if (!row_live(r, qi, Sq)) continue;
      // padding rows (q_pos -1) write zeros; a live row divides by max(l, 1e-30)
      const float inv = rows[t].q_pos >= 0 ? 1.f / fmaxf(l[t], 1e-30f) : 0.f;
      T* orow = ob + (size_t)qi * q_rs + (r % sg.size) * D;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int d = h * 64 + n * 8 + tig * 2;
          if (d < D)
            *reinterpret_cast<uint32_t*>(orow + d) = wgattn::pack2<T>(
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
  constexpr int OP = DP + 8;   // padded float row stride of the partial o
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
    const int r = e / (D / 2), d = 2 * (e % (D / 2)), qi = i0 + r / sg.size;
    if (!row_live(r, qi, Sq)) continue;
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
    *reinterpret_cast<uint32_t*>(ob + (size_t)qi * q_rs + (r % sg.size) * D + d) =
        wgattn::pack2<T>(o0, o1);
  }
  cluster.sync();   // no split leaves while another still reads it
}

template <typename T, int DP, bool TREE, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* history, const int* chunk, const int* tree_masks,
           void* out, int B, int Sq, int Hq, int Hkv, int D, int n_pages,
           int page_shift, int max_pages, int n_splits, int vec_q, int vec_kv,
           float scale, cudaStream_t s) {
  using PT = std::conditional_t<Q8, int8_t, T>;
  const SubGroups sg = sub_groups(Hq / Hkv, MAX_GROUP);
  const int bq = ROWS / sg.size;
  if ((long)B * Hkv * sg.n > 65535 || (Sq + bq - 1) / bq > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_splits, B * Hkv * sg.n, (Sq + bq - 1) / bq);
  auto go = [&](auto kernel) {
    return launch_split(
        kernel, grid, NTHREADS, Plan<DP, Q8>::TOTAL, n_splits, s,
        static_cast<const T*>(q), static_cast<const PT*>(k_pool),
        static_cast<const PT*>(v_pool), k_scales, v_scales, tables, history,
        chunk, tree_masks, static_cast<T*>(out), Sq, Hq, Hkv, D, n_pages,
        page_shift, max_pages, n_splits, sg.n, vec_q, vec_kv, scale);
  };
  if constexpr (DP <= 128)
    if (D == DP && vec_q == 16 && vec_kv == 16)
      return go(paged_chunk<T, DP, TREE, Q8, true>);
  return go(paged_chunk<T, DP, TREE, Q8, false>);
}

// the head-dim class: D rounded up to a multiple of 64
template <typename T, bool TREE, bool Q8>
int launch_dim(const void* q, const void* k_pool, const void* v_pool,
               const float* k_scales, const float* v_scales, const int* tables,
               const int* history, const int* chunk, const int* tree_masks,
               void* out, int B, int Sq, int Hq, int Hkv, int D, int n_pages,
               int page_shift, int max_pages, int n_splits, int vec_q,
               int vec_kv, float scale, cudaStream_t s) {
#define GOFR_CHUNK_LAUNCH(DP)                                               \
  return launch<T, DP, TREE, Q8>(q, k_pool, v_pool, k_scales, v_scales,     \
                                 tables, history, chunk, tree_masks, out, B, \
                                 Sq, Hq, Hkv, D, n_pages, page_shift,        \
                                 max_pages, n_splits, vec_q, vec_kv, scale, s)
  if (D <= 64) GOFR_CHUNK_LAUNCH(64);
  if (D <= 128) GOFR_CHUNK_LAUNCH(128);
  if (D <= 192) GOFR_CHUNK_LAUNCH(192);
  GOFR_CHUNK_LAUNCH(256);
#undef GOFR_CHUNK_LAUNCH
}

}  // namespace

// The build compiles this file in four parts at once (ops/_build.py
// PARTS): part 2 t + f instantiates the wgmma kernels of 16-bit type t (0
// bf16, 1 float16) over pool form f (0 plain, 1 int8), and part 0 also
// holds the C entries and the float32 kernel; built whole (GOFR_PART
// undefined), one translation unit holds them all.
#ifndef GOFR_PART
#define GOFR_PART -1
#endif
#define GOFR_IN_PART(p) (GOFR_PART < 0 || GOFR_PART == (p))
#define GOFR_CHUNK_PARAMS                                                    \
  bool tree, const void *q, const void *k_pool, const void *v_pool,         \
      const float *k_scales, const float *v_scales, const int *tables,      \
      const int *history, const int *chunk, const int *tree_masks,          \
      void *out, int B, int Sq, int Hq, int Hkv, int D, int n_pages,        \
      int page_shift, int max_pages, int n_splits, int vec_q, int vec_kv,   \
      float scale, cudaStream_t s
#define GOFR_CHUNK_ARGS                                                      \
  q, k_pool, v_pool, k_scales, v_scales, tables, history, chunk,            \
      tree_masks, out, B, Sq, Hq, Hkv, D, n_pages, page_shift, max_pages,   \
      n_splits, vec_q, vec_kv, scale, s

// each (type, pool form)'s launcher, chunk or tree, defined in its part
namespace paged_chunk_parts {
int bf16_plain(GOFR_CHUNK_PARAMS);
int bf16_int8(GOFR_CHUNK_PARAMS);
int f16_plain(GOFR_CHUNK_PARAMS);
int f16_int8(GOFR_CHUNK_PARAMS);
#if GOFR_IN_PART(0)
int bf16_plain(GOFR_CHUNK_PARAMS) {
  return tree ? launch_dim<__nv_bfloat16, true, false>(GOFR_CHUNK_ARGS)
              : launch_dim<__nv_bfloat16, false, false>(GOFR_CHUNK_ARGS);
}
#endif
#if GOFR_IN_PART(1)
int bf16_int8(GOFR_CHUNK_PARAMS) {
  return tree ? launch_dim<__nv_bfloat16, true, true>(GOFR_CHUNK_ARGS)
              : launch_dim<__nv_bfloat16, false, true>(GOFR_CHUNK_ARGS);
}
#endif
#if GOFR_IN_PART(2)
int f16_plain(GOFR_CHUNK_PARAMS) {
  return tree ? launch_dim<__half, true, false>(GOFR_CHUNK_ARGS)
              : launch_dim<__half, false, false>(GOFR_CHUNK_ARGS);
}
#endif
#if GOFR_IN_PART(3)
int f16_int8(GOFR_CHUNK_PARAMS) {
  return tree ? launch_dim<__half, true, true>(GOFR_CHUNK_ARGS)
              : launch_dim<__half, false, true>(GOFR_CHUNK_ARGS);
}
#endif
}  // namespace paged_chunk_parts

#if GOFR_IN_PART(0)
namespace {

template <bool TREE, bool Q8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scales, const float* v_scales, const int* tables,
             const int* history, const int* chunk, const int* tree_masks,
             void* out, int B, int Sq, int Hq, int Hkv, int n_pages, int page,
             int max_pages, int D, int dtype, int n_splits, float scale,
             void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
      n_pages <= 0 || page <= 0 || (page & (page - 1)) != 0 ||
      max_pages <= 0 || D < 16 || D > 256 || D % 4 != 0 ||
      (TREE && Sq > 32) || n_splits < 1 || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == act::F32) {
    // float32: one block walks a q tile's positions alone (n_splits is
    // not read), in float32 FMAs
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
    return simt::run<true>(a, s);
  }
  // 16-bit rows move in 16- or 8-byte copies, int8 rows in 16, 8 or 4
  const int vec_q = copy_width(D * 2, {q, out});
  const int vec_kv = Q8 ? copy_width(D, {k_pool, v_pool})
                        : copy_width(D * 2, {k_pool, v_pool});
  if (vec_q < 8 || vec_kv < (Q8 ? 4 : 8)) return (int)cudaErrorInvalidValue;
  const int page_shift = __builtin_ctz((unsigned)page);   // page = 2^shift
  namespace parts = paged_chunk_parts;
  if (dtype == act::BF16)
    return Q8 ? parts::bf16_int8(TREE, GOFR_CHUNK_ARGS)
              : parts::bf16_plain(TREE, GOFR_CHUNK_ARGS);
  if (dtype == act::F16)
    return Q8 ? parts::f16_int8(TREE, GOFR_CHUNK_ARGS)
              : parts::f16_plain(TREE, GOFR_CHUNK_ARGS);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). q [B, Sq, Hq, D] and out [B, Sq, Hq, D]
// of the activation type `dtype` (0 bf16, 1 float16, 2 float32), pools
// [Hkv, Np, page, D] of the same type (one layer, contiguous), tables
// int32 [B, max_pages], history and chunk int32 [B]; q, out and the pages
// aligned to four elements; n_splits (1-8) blocks share each q tile's
// walk. D: a multiple of 4 from 16 to 256; any group Hq / Hkv. bf16 and
// float16 run the wgmma kernel above; float32 the float32 kernel of
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
#endif  // GOFR_IN_PART(0)
