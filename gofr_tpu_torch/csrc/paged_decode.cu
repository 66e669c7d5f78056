// Paged decode attention for Hopper (sm_90a), plain and int8 pools, at
// every activation type (bf16, float16, float32) and every head dim the
// kernels take (a multiple of 4 from 16 to 256): one split-KV kernel,
// templated on the type and on a padded head-dim class DP (64, 128 or
// 256), with the call's head dim D masking its loads and stores.
//
// Replaces the Pallas TPU kernel gofr_tpu/ops/paged_attention.py
// `_paged_decode_kernel` (wrapper `paged_decode_attention_pallas`), both
// of its branches: a pool in the activation type (C entry
// gofr_paged_decode) and the quantized {q: int8, s: f32 [.., 1]} pool
// (`quantized=True`, C entry gofr_paged_decode_i8). It computes the same
// function: one new token per slot b attends to the first lengths[b]
// rows of that slot, read in place through its block table from one
// layer's head-major pool [Hkv, Np, pg, hd]. Table ids are clamped to
// Np - 1 on read, positions >= lengths[b] are masked (logit NEG_INF and
// p = 0 explicitly), and the output divides by max(l, 1e-30), so a
// zero-length slot writes exact zeros. An int8 row stands for codes *
// scale (scale per row), in float32, as the TPU kernel's in-register
// `k * ks_buf` dequantizes it. Everything is computed in float32, as the
// Pallas kernel does whatever its input type.
//
// What bounds it on the H100: HBM bytes. Per (slot, KV head) per layer
// it must read 2 * len * hd * sizeof(T) bytes of K and V (int8: 2 * len
// * (hd + 4), about 0.53x bf16's at hd 64) and does only 4 * group * hd
// flops per row read — about group / 1 flop per byte (int8: twice that),
// two orders of magnitude under the card's ~295 flop/byte balance point.
// At serving batch sizes, though, it is the latency of the longest
// slot's walk that sets the time: B x Hkv work items (64 at B = 8)
// under-fill the 132 SMs, and one item's pages come one after another.
// So the design cuts that walk and every step of it:
//   - split-KV: the grid is (S, Hkv x sub-groups, B); split s walks its
//     share of ITS slot's pages, worked out on the card from lengths[b]
//     (the wrapper picks S from the shapes alone,
//     ops/paged_attention.kv_splits, so the host never reads a length).
//     The S splits of one (slot, KV head) are one thread-block cluster:
//     each leaves its float32 partial (m, l, o) per query head in its
//     shared memory, and after a cluster barrier every split merges a
//     share of the outputs from all S partials through distributed shared
//     memory, in split order (deterministic): out = sum_s e^(m_s - M) o_s
//     / max(sum_s e^(m_s - M) l_s, 1e-30). A second barrier keeps every
//     block alive until the others have read it. An empty split's partial
//     is (NEG_INF, 0, 0) and weighs exactly 0; with S = 1 there is no
//     cluster and the block divides its own o by max(l, 1e-30). No extra
//     launch;
//   - inside a block, warp w owns a quarter of every page's rows (at
//     group 1 too: every warp computes) and walks the split's pages on
//     its own: it stages its rows, scores them, keeps its own
//     online-softmax state (m, l and o for all the block's query heads)
//     and never waits for the other warps until the walk is done, when
//     the four warp partials merge in warp order (the same formula). One
//     block per (split, KV head, slot) serves the whole group, so a page
//     is read once for the group; a group above the block's register
//     arrays (16 heads, 8 at DP 256) is cut into sub-groups of the same
//     KV head, one block each (paged_common.cuh `sub_groups`);
//   - each warp keeps a ring of STAGES pages of its rows in flight with
//     cp.async (rows past the length are zero-filled, not read) and reads
//     the table entry of the page it will issue next before the current
//     page's math, so no lane waits on a table load. A row moves in the
//     widest copy that divides its bytes (16, else 8, else 4: D 100 in
//     float16 is 200 bytes, 8-byte copies), so HBM reads only the D real
//     columns; columns D .. DP of every staged row are zeroed once, and
//     q's too, so they add exact zeros to every score. Where the ring of
//     whole pages would not fit in shared memory (float32 rows at DP 256,
//     or large pages) the walk's unit is a fixed share of a page's rows
//     instead (`sub` rows, chosen on the host);
//   - an int8 page is staged as raw codes (half the bytes) with its row
//     scales beside it (0 for rows past the length); each code is read
//     and converted to float exactly once, in registers, for all the
//     heads of the group (the score lanes own whole rows, the P V lanes
//     whole columns), and the scales fold out of both products: s =
//     scale_k[r] * (q . codes_k[r]) and acc += (p * scale_v[r]) *
//     codes_v[r], while l sums the unscaled p;
//   - scores: two lanes per row, each over half of the DP columns, for up
//     to 4 heads at a time (the row's K values are read once for them);
//     P V: lane l owns column pair l (and l + 32, l + 64, l + 96 at DP
//     128 and 256) of every head and takes each row's p from the row's
//     lane by shuffle, so each V value is read once for the group;
//   - staged rows are padded so that the score loop's 16-byte reads of
//     the 8 lanes of a phase (4 rows, two lanes each) hit distinct bank
//     groups: bf16 at DP 64 / 128 by 16 bytes, a lane reading half a row
//     (the layout, and so the arithmetic, of the kernel before it took
//     other types); every other case by 32 bytes, a lane reading every
//     other 16-byte chunk.
// What bounds it now: per split, one warp's few dependent pages and the
// two merges; still far from the byte bound at these sizes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "act_types.cuh"
#include "paged_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_GROUP = 16;    // query heads a block holds at most
constexpr int HPP = 4;           // query heads per score pass
constexpr int PASS = 16;         // rows a warp scores at once: two lanes each
constexpr int STAGES = 3;        // pages of a warp's ring in flight or in use
constexpr size_t MAX_SMEM = 232448;   // dynamic shared bytes a block may take
constexpr float NEG_INF = -1e30f;

// the query heads a block holds at DP: its register arrays (o: 2 DP / 64
// floats a head) stay within a thread's registers
template <int DP>
__host__ __device__ constexpr int group_cap() {
  return DP > 128 ? 8 : MAX_GROUP;
}

// The staged row of pool element type PT (the activation type, or int8
// codes) at DP columns. bf16 at DP 64 / 128 is padded by 16 bytes and a
// score lane reads one half of its row (the layout the kernel had before
// it took other types); every other case is padded by 32 bytes and a
// score lane reads every other 16-byte chunk. Either way the 16-byte
// reads of the 8 lanes of a phase (4 rows, two lanes each) fall in
// distinct bank groups.
template <typename PT, int DP>
struct Layout {
  static constexpr bool HALVES =
      std::is_same<PT, __nv_bfloat16>::value && DP <= 128;
  static constexpr int EPC = 16 / sizeof(PT);      // elements per 16-byte chunk
  static constexpr int RS = HALVES ? DP + 8 : DP + 32 / (int)sizeof(PT);
  static constexpr int CPL = DP / 2 / EPC;         // chunks per score lane
  // chunk c (0 .. CPL-1) of score lane h: its index in the row
  __device__ static constexpr int chunk(int h, int c) {
    return HALVES ? h * CPL + c : 2 * c + h;
  }
};

// Shared-memory plan of one block (byte offsets), shared by the kernel
// and its launcher: STAGES units of `sub` K and V rows [STAGES][K|V][sub]
// [RS] (int8: plus their row scales [STAGES][K|V][sub]), of which warp w
// only touches its own rows; the query [gs][2][QS] in the order the
// score lanes read it; the warps' softmax statistics. After the walk the
// stage area holds the warps' partial outputs [NWARPS][gs][DP] (then the
// block's [gs][DP]). `gs`: the query heads of a block.
template <typename PT, int DP>
struct Plan {
  using L = Layout<PT, DP>;
  static constexpr int QS = DP / 2 + 4;        // padded float stride of a q half
  size_t side, stages, qs, scales, stats, total;
  __host__ __device__ Plan(int sub, int gs) {
    constexpr bool Q8 = sizeof(PT) == 1;
    side = (size_t)sub * L::RS * sizeof(PT);   // one stage, one side
    stages = 2 * STAGES * side;
    const size_t red = (size_t)NWARPS * gs * DP * 4;
    qs = stages > red ? stages : red;
    scales = qs + (size_t)gs * 2 * QS * 4;
    stats = scales + (Q8 ? (size_t)2 * STAGES * sub * 4 : 0);
    total = stats + (2 * NWARPS + 2) * MAX_GROUP * 4;
  }
};

// a staged 16-byte chunk as floats (every conversion exact): 8 bf16
// values (a bf16 is the top half of a float), 8 float16, 4 float32, or
// 16 int8 codes
__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8],
                                       __nv_bfloat16) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(word(w, i) << 16);
    f[2 * i + 1] = __uint_as_float(word(w, i) & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8], __half) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = word(w, i);
    const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&u));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4], float) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(word(w, i));
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[16], int8_t) {
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = code(w, i);
}

// two neighbouring elements of a staged row, as floats
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

// T: q / out (and a plain pool's) type. Q8: the pages are int8 codes
// with a float32 scale per row (k_scales / v_scales [Hkv, Np, page, 1]);
// else of type T, scales unused. GMAX >= the block's query heads bounds
// the per-head register arrays (4, 8 or 16). d_in (<= DP) is the call's
// head dim, sub_in the rows of a walk unit (a page, or a share of one),
// vec_in the bytes of one staging copy, n_sub the sub-groups of a group.
// EXACT: d_in is DP, the copies are 16 bytes and a unit is a whole page,
// all fixed when compiled (the 16-bit types at D 64 / 128: the kernel as
// it was before it took other head dims, arithmetic and speed).
template <typename T, int DP, bool Q8, int GMAX, bool EXACT>
__global__ void __launch_bounds__(NTHREADS, 1)
paged_decode(const T* __restrict__ q,
             const std::conditional_t<Q8, int8_t, T>* __restrict__ k_pool,
             const std::conditional_t<Q8, int8_t, T>* __restrict__ v_pool,
             const float* __restrict__ k_scales,
             const float* __restrict__ v_scales,
             const int* __restrict__ tables,
             const int* __restrict__ lengths,
             T* __restrict__ out,
             int Hq, int Hkv, int d_in, int n_pages, int page, int max_pages,
             int n_splits, int n_sub, int sub_in, int vec_in, float scale) {
  using PT = std::conditional_t<Q8, int8_t, T>;
  const int D = EXACT ? DP : d_in;
  const int sub = EXACT ? page : sub_in;
  const int vec = EXACT ? 16 : vec_in;
  using Ly = Layout<PT, DP>;
  using P = Plan<PT, DP>;
  constexpr int EPC = Ly::EPC, RS = Ly::RS, CPL = Ly::CPL, QS = P::QS;
  constexpr int NPL = DP / 64;     // column pairs per lane in P V
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = Hq / Hkv;
  const SubGroups sg = sub_groups(group, group_cap<DP>());
  const P plan(sub, sg.size);
  // stage st: K rows at rows(2 st), V rows at rows(2 st + 1)
  auto rows_of = [&](int i) {
    return reinterpret_cast<PT*>(smem + (size_t)i * plan.side);
  };
  float* const red = reinterpret_cast<float*>(smem);            // after the walk
  float* const qs = reinterpret_cast<float*>(smem + plan.qs);   // [gs][2][QS]
  float* const scl = reinterpret_cast<float*>(smem + plan.scales);  // [STAGES][K|V][sub]
  float* const wm = reinterpret_cast<float*>(smem + plan.stats);    // [NWARPS][16]
  float* const wl = wm + NWARPS * MAX_GROUP;
  float* const st_m = wl + NWARPS * MAX_GROUP;                      // [16]
  float* const st_l = st_m + MAX_GROUP;

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = n_sub == 1 ? (int)blockIdx.y : (int)blockIdx.y / n_sub;
  const int head0 = n_sub == 1 ? 0 : (int)blockIdx.y % n_sub * sg.size;
  const int gs = min(sg.size, group - head0);   // this block's query heads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int length = max(lengths[b], 0);
  // the walk: n_walk pages of `upp` units each (a unit's first row at or
  // past the length is not walked), this split's share of the units
  const int upp = EXACT ? 1 : (page + sub - 1) / sub;
  const int n_walk = min((length + page - 1) / page, max_pages);
  const int n_units = n_walk == 0 ? 0
      : (n_walk - 1) * upp
        + min(upp, (min(length, n_walk * page) - (n_walk - 1) * page + sub - 1) / sub);
  const int per = (n_units + n_splits - 1) / n_splits;
  const int u0 = min(split * per, n_units), u1 = min(u0 + per, n_units);
  // this warp's share of every unit's rows (of a unit of `rows` rows)
  const int rpw = (sub + NWARPS - 1) / NWARPS;
  auto unit_rows = [&](int u) { return min(sub, page - u % upp * sub); };

  // columns D .. DP of every staged row are zeros, written once (the
  // copies below fill columns 0 .. D only)
  if (D < DP) {
    const int pad_words = (DP - D) * (int)sizeof(PT) / 4;
    for (int i = tid; i < 2 * STAGES * sub * pad_words; i += NTHREADS) {
      const int row = i / pad_words, w = i % pad_words;
      reinterpret_cast<uint32_t*>(rows_of(0) + (size_t)row * RS + D)[w] = 0u;
    }
  }
  // q, pre-scaled, in the order score lane h reads its chunks (zeros
  // past D)
  const T* qb = q + ((size_t)b * Hq + (size_t)hk * group + head0) * D;
  for (int i = tid; i < gs * DP; i += NTHREADS) {
    const int g = i / DP, d = i % DP, ci = d / EPC;
    const int h = Ly::HALVES ? ci / CPL : ci & 1;
    const int c = Ly::HALVES ? ci % CPL : ci >> 1;
    qs[g * 2 * QS + h * QS + c * EPC + d % EPC] =
        d < D ? act::to_f(qb[g * D + d]) * scale : 0.f;
  }
  __syncthreads();

  const size_t page_elems = (size_t)page * D;
  const PT* kh = k_pool + (size_t)hk * n_pages * page_elems;
  const PT* vh = v_pool + (size_t)hk * n_pages * page_elems;
  const int* table = tables + (size_t)b * max_pages;
  auto page_id = [&](int u) {
    return min(max(table[u / upp], 0), n_pages - 1);
  };
  // a lane's copies of a row: `cpr` copies of `vec` bytes cover its D
  // columns; lane l takes copy lc of row lr (+ rpi k), and with more than
  // 32 copies a row, copies lc + 32 j
  const int cpr = D * (int)sizeof(PT) / vec, epv = vec / (int)sizeof(PT);
  const int rpi = cpr < 32 ? 32 / cpr : 1;
  const int lr = cpr < 32 ? lane / cpr : 0, lc = cpr < 32 ? lane % cpr : lane;
  const int cstep = cpr < 32 ? cpr : 32;

  // issue this warp's rows of unit u (table id pid) into stage st; rows
  // at or past the length are zero-filled without a read
  auto issue = [&](int u, int pid, int st) {
    const int row0 = u % upp * sub;   // the unit's first row in its page
    const int live = length - u / upp * page - row0;
    const int rows = unit_rows(u);
    const int rbeg = min(warp * rpw, rows), rend = min(rbeg + rpw, rows);
    const PT* ksrc = kh + (size_t)pid * page_elems + (size_t)row0 * D;
    const PT* vsrc = vh + (size_t)pid * page_elems + (size_t)row0 * D;
    PT* kd = rows_of(2 * st);
    PT* vd = rows_of(2 * st + 1);
    if (lr < rpi) {
      for (int r = rbeg + lr; r < rend; r += rpi) {
        const int n = r < live ? vec : 0;
        for (int c = lc; c < cpr; c += cstep) {
          const int o = c * epv;
          cp_async_vec(kd + r * RS + o, ksrc + (size_t)r * D + o, vec, n);
          cp_async_vec(vd + r * RS + o, vsrc + (size_t)r * D + o, vec, n);
        }
      }
    }
    if (Q8) {
      const size_t srow = ((size_t)hk * n_pages + pid) * page + row0;
      float* ks = scl + (size_t)(2 * st) * sub;
      for (int r = rbeg + lane; r < rend; r += 32) {
        const int n = r < live ? 4 : 0;
        cp_async4(ks + r, k_scales + srow + r, n);
        cp_async4(ks + sub + r, v_scales + srow + r, n);
      }
    }
  };

  // this warp's online-softmax state, per head; lane l holds o's column
  // pairs l + 32 k
  float m[GMAX], l[GMAX], acc[GMAX][2 * NPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NPL; ++j) acc[g][j] = 0.f;
  }

  // the ring: units u0 .. u0 + STAGES - 2 in flight before the walk
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (u0 + k < u1) issue(u0 + k, page_id(u0 + k), k);
    cp_async_commit();
  }
  int pid_next = u0 + STAGES - 1 < u1 ? page_id(u0 + STAGES - 1) : 0;

  for (int u = u0; u < u1; ++u) {
    const int st = (u - u0) % STAGES;
    if (u + STAGES - 1 < u1) {
      issue(u + STAGES - 1, pid_next, (u - u0 + STAGES - 1) % STAGES);
      if (u + STAGES < u1) pid_next = page_id(u + STAGES);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();   // this warp's rows of unit u are staged
    const int rows = unit_rows(u);
    const int rbeg = min(warp * rpw, rows), rend = min(rbeg + rpw, rows);
    const int nlive = min(rend, length - u / upp * page - u % upp * sub) - rbeg;
    if (nlive > 0) {   // warp-uniform
      const PT* kbuf = rows_of(2 * st);
      const PT* vbuf = rows_of(2 * st + 1);
      const float* kss = scl + (size_t)(2 * st) * sub;
      const float* vss = kss + sub;
      for (int rr0 = 0; rr0 < nlive; rr0 += PASS) {
        // lanes 2 j and 2 j + 1 score row rbeg + rr0 + j, halves 0 and 1
        const int h = lane & 1;
        const bool live = rr0 + (lane >> 1) < nlive;
        const int r = min(rbeg + rr0 + (lane >> 1), rend - 1);
        const PT* kr = kbuf + (size_t)r * RS;
        const float ksc = Q8 ? kss[r] : 1.f;
        const float vsc = Q8 ? vss[r] : 1.f;
        float p[GMAX], alpha[GMAX];
#pragma unroll
        for (int g0 = 0; g0 < GMAX; g0 += HPP) {
          if (g0 >= gs) break;
          float dot[HPP];
#pragma unroll
          for (int gi = 0; gi < HPP; ++gi) dot[gi] = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float kf[EPC];
            unpack(*reinterpret_cast<const uint4*>(kr + EPC * Ly::chunk(h, c)), kf,
                   PT());
#pragma unroll
            for (int gi = 0; gi < HPP; ++gi) {
              if (g0 + gi >= gs) continue;
              const float* qg = qs + (g0 + gi) * 2 * QS + h * QS + EPC * c;
#pragma unroll
              for (int e = 0; e < EPC; e += 4) {
                const float4 a = *reinterpret_cast<const float4*>(qg + e);
                dot[gi] += a.x * kf[e] + a.y * kf[e + 1] + a.z * kf[e + 2]
                         + a.w * kf[e + 3];
              }
            }
          }
          // each head's online-softmax step over the pass's rows: the
          // xor-1 shuffle joins a row's halves, xor 2-16 spans the rows
#pragma unroll
          for (int gi = 0; gi < HPP; ++gi) {
            const int g = g0 + gi;
            if (g >= gs) continue;
            const float full = dot[gi] + __shfl_xor_sync(0xffffffffu, dot[gi], 1);
            const float s = live ? full * ksc : NEG_INF;
            float mx = s;
#pragma unroll
            for (int o = 2; o < 32; o <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[g], mx);
            // p masked explicitly: with every row masked, s == m_new
            // == NEG_INF and exp(s - m_new) would be 1
            const float pv = live ? __expf(s - m_new) : 0.f;
            float sum = pv;
#pragma unroll
            for (int o = 2; o < 32; o <<= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, o);
            alpha[g] = __expf(m[g] - m_new);
            l[g] = l[g] * alpha[g] + sum;
            m[g] = m_new;
            p[g] = Q8 ? pv * vsc : pv;   // P V takes p * scale_v; l takes p
          }
        }
        // P V over the pass's rows: row j's p comes from lane 2 j
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= gs) continue;
#pragma unroll
          for (int j = 0; j < 2 * NPL; ++j) acc[g][j] *= alpha[g];
        }
        const int nr = min(PASS, nlive - rr0);
        for (int j = 0; j < nr; ++j) {
          const PT* vr = vbuf + (size_t)(rbeg + rr0 + j) * RS + 2 * lane;
          float2 v[NPL];
#pragma unroll
          for (int k = 0; k < NPL; ++k) v[k] = pair(vr + 64 * k);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g >= gs) continue;
            const float pg = __shfl_sync(0xffffffffu, p[g], 2 * j);
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
              acc[g][2 * k] += pg * v[k].x;
              acc[g][2 * k + 1] += pg * v[k].y;
            }
          }
        }
      }
    }
    __syncwarp();   // stage st free for reuse
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stage area

  // the four warp partials, merged in warp order into the block's
  // partial: red [gs][DP] (o), st_m, st_l
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= gs) continue;
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      *reinterpret_cast<float2*>(red + ((size_t)warp * gs + g) * DP + 64 * k + 2 * lane) =
          make_float2(acc[g][2 * k], acc[g][2 * k + 1]);
    if (lane == 0) {
      wm[warp * MAX_GROUP + g] = m[g];
      wl[warp * MAX_GROUP + g] = l[g];
    }
  }
  __syncthreads();
  for (int e = tid; e < gs * DP; e += NTHREADS) {
    const int g = e / DP;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, wm[w * MAX_GROUP + g]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float wt = __expf(wm[w * MAX_GROUP + g] - M);
      L += wt * wl[w * MAX_GROUP + g];
      o += wt * red[(size_t)w * gs * DP + e];
    }
    red[e] = o;   // only this thread reads element e of warp 0's partial
    if (e % DP == 0) {
      st_m[g] = M;
      st_l[g] = L;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * Hq + (size_t)hk * group + head0) * D;
  if (n_splits == 1) {
    for (int e = tid; e < gs * D / 2; e += NTHREADS) {
      const int g = (2 * e) / D, d = (2 * e) % D;
      const float inv = 1.f / fmaxf(st_l[g], 1e-30f);
      act::store2(ob + g * D + d, red[g * DP + d] * inv, red[g * DP + d + 1] * inv);
    }
    return;
  }

  // merge the S partials of this (slot, KV head) in split order; split
  // r writes every S-th group of NTHREADS column pairs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial is in its shared memory
  const int rank = (int)cluster.block_rank();
  for (int e = rank * NTHREADS + tid; e < gs * D / 2; e += n_splits * NTHREADS) {
    const int g = (2 * e) / D, d = (2 * e) % D;
    float M = NEG_INF;
    for (int s = 0; s < n_splits; ++s)
      M = fmaxf(M, cluster.map_shared_rank(st_m, s)[g]);
    float L = 0.f, o0 = 0.f, o1 = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = __expf(cluster.map_shared_rank(st_m, s)[g] - M);
      L += w * cluster.map_shared_rank(st_l, s)[g];
      const float2 o = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(red, s) + g * DP + d);
      o0 += w * o.x;
      o1 += w * o.y;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    act::store2(ob + g * D + d, o0 * inv, o1 * inv);
  }
  cluster.sync();   // no split leaves while another still reads it
}

template <typename T, int DP, bool Q8, int GMAX>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* lengths, void* out, int B, int Hq, int Hkv, int D,
           int n_pages, int page, int max_pages, int n_splits, int vec,
           float scale, cudaStream_t s) {
  using PT = std::conditional_t<Q8, int8_t, T>;
  const SubGroups sg = sub_groups(Hq / Hkv, group_cap<DP>());
  if ((long)Hkv * sg.n > 65535) return (int)cudaErrorInvalidValue;
  // a walk unit: the whole page where the ring fits, else the largest
  // share of it that does
  int sub = page;
  for (int n = 2; Plan<PT, DP>(sub, sg.size).total > MAX_SMEM; ++n) {
    if (sub == 1) return (int)cudaErrorInvalidValue;
    sub = (page + n - 1) / n;
  }
  auto go = [&](auto kernel) {
    return launch_split(
        kernel, dim3(n_splits, Hkv * sg.n, B), NTHREADS,
        Plan<PT, DP>(sub, sg.size).total, n_splits, s,
        static_cast<const T*>(q), static_cast<const PT*>(k_pool),
        static_cast<const PT*>(v_pool), k_scales, v_scales, tables, lengths,
        static_cast<T*>(out), Hq, Hkv, D, n_pages, page, max_pages, n_splits,
        sg.n, sub, vec, scale);
  };
  if constexpr (DP <= 128 && !std::is_same<T, float>::value)
    if (D == DP && vec == 16 && sub == page)
      return go(paged_decode<T, DP, Q8, GMAX, true>);
  return go(paged_decode<T, DP, Q8, GMAX, false>);
}

// the register arrays' bound: 4 heads where the block holds at most 4,
// else the class's cap
template <typename T, int DP, bool Q8>
int launch_group(const void* q, const void* k_pool, const void* v_pool,
                 const float* k_scales, const float* v_scales,
                 const int* tables, const int* lengths, void* out, int B,
                 int Hq, int Hkv, int D, int n_pages, int page, int max_pages,
                 int n_splits, int vec, float scale, cudaStream_t s) {
  if (sub_groups(Hq / Hkv, group_cap<DP>()).size <= 4)
    return launch<T, DP, Q8, 4>(q, k_pool, v_pool, k_scales, v_scales, tables,
                                lengths, out, B, Hq, Hkv, D, n_pages, page,
                                max_pages, n_splits, vec, scale, s);
  return launch<T, DP, Q8, group_cap<DP>()>(
      q, k_pool, v_pool, k_scales, v_scales, tables, lengths, out, B, Hq, Hkv,
      D, n_pages, page, max_pages, n_splits, vec, scale, s);
}

// the head-dim class: D padded up to 64, 128 or 256 columns
template <typename T, bool Q8>
int launch_dim(const void* q, const void* k_pool, const void* v_pool,
               const float* k_scales, const float* v_scales, const int* tables,
               const int* lengths, void* out, int B, int Hq, int Hkv, int D,
               int n_pages, int page, int max_pages, int n_splits, int vec,
               float scale, cudaStream_t s) {
  if (D <= 64)
    return launch_group<T, 64, Q8>(q, k_pool, v_pool, k_scales, v_scales,
                                   tables, lengths, out, B, Hq, Hkv, D,
                                   n_pages, page, max_pages, n_splits, vec,
                                   scale, s);
  if (D <= 128)
    return launch_group<T, 128, Q8>(q, k_pool, v_pool, k_scales, v_scales,
                                    tables, lengths, out, B, Hq, Hkv, D,
                                    n_pages, page, max_pages, n_splits, vec,
                                    scale, s);
  return launch_group<T, 256, Q8>(q, k_pool, v_pool, k_scales, v_scales,
                                  tables, lengths, out, B, Hq, Hkv, D, n_pages,
                                  page, max_pages, n_splits, vec, scale, s);
}

}  // namespace

// The build compiles this file in six parts at once (ops/_build.py
// PARTS): part 2 t + f instantiates the kernels of activation type t (0
// bf16, 1 float16, 2 float32) over pool form f (0 plain, 1 int8), and
// part 0 also holds the C entries; built whole (GOFR_PART undefined), one
// translation unit holds them all.
#ifndef GOFR_PART
#define GOFR_PART -1
#endif
#define GOFR_IN_PART(p) (GOFR_PART < 0 || GOFR_PART == (p))
#define GOFR_DECODE_PARAMS                                                  \
  const void *q, const void *k_pool, const void *v_pool,                   \
      const float *k_scales, const float *v_scales, const int *tables,     \
      const int *lengths, void *out, int B, int Hq, int Hkv, int D,        \
      int n_pages, int page, int max_pages, int n_splits, int vec,         \
      float scale, cudaStream_t s
#define GOFR_DECODE_ARGS                                                    \
  q, k_pool, v_pool, k_scales, v_scales, tables, lengths, out, B, Hq, Hkv, \
      D, n_pages, page, max_pages, n_splits, vec, scale, s

// each (type, pool form)'s launcher, defined in its part
namespace paged_decode_parts {
int bf16_plain(GOFR_DECODE_PARAMS);
int bf16_int8(GOFR_DECODE_PARAMS);
int f16_plain(GOFR_DECODE_PARAMS);
int f16_int8(GOFR_DECODE_PARAMS);
int f32_plain(GOFR_DECODE_PARAMS);
int f32_int8(GOFR_DECODE_PARAMS);
#if GOFR_IN_PART(0)
int bf16_plain(GOFR_DECODE_PARAMS) {
  return launch_dim<__nv_bfloat16, false>(GOFR_DECODE_ARGS);
}
#endif
#if GOFR_IN_PART(1)
int bf16_int8(GOFR_DECODE_PARAMS) {
  return launch_dim<__nv_bfloat16, true>(GOFR_DECODE_ARGS);
}
#endif
#if GOFR_IN_PART(2)
int f16_plain(GOFR_DECODE_PARAMS) {
  return launch_dim<__half, false>(GOFR_DECODE_ARGS);
}
#endif
#if GOFR_IN_PART(3)
int f16_int8(GOFR_DECODE_PARAMS) {
  return launch_dim<__half, true>(GOFR_DECODE_ARGS);
}
#endif
#if GOFR_IN_PART(4)
int f32_plain(GOFR_DECODE_PARAMS) {
  return launch_dim<float, false>(GOFR_DECODE_ARGS);
}
#endif
#if GOFR_IN_PART(5)
int f32_int8(GOFR_DECODE_PARAMS) {
  return launch_dim<float, true>(GOFR_DECODE_ARGS);
}
#endif
}  // namespace paged_decode_parts

#if GOFR_IN_PART(0)
namespace {

template <bool Q8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scales, const float* v_scales, const int* tables,
             const int* lengths, void* out, int B, int Hq, int Hkv, int n_pages,
             int page, int max_pages, int D, int dtype, int n_splits,
             float scale, void* stream) {
  namespace parts = paged_decode_parts;
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || n_pages <= 0 ||
      page <= 0 || max_pages <= 0 || B > 65535 || D < 16 || D > 256 ||
      D % 4 != 0 || n_splits < 1 || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int elem = Q8 ? 1 : dtype == act::F32 ? 4 : 2;
  const int vec = copy_width(D * elem, {k_pool, v_pool});
  if (vec == 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case act::BF16:
      return Q8 ? parts::bf16_int8(GOFR_DECODE_ARGS)
                : parts::bf16_plain(GOFR_DECODE_ARGS);
    case act::F16:
      return Q8 ? parts::f16_int8(GOFR_DECODE_ARGS)
                : parts::f16_plain(GOFR_DECODE_ARGS);
    case act::F32:
      return Q8 ? parts::f32_int8(GOFR_DECODE_ARGS)
                : parts::f32_plain(GOFR_DECODE_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (bound with ctypes). q [B, Hq, D] and out [B, Hq, D] of the
// activation type `dtype` (0 bf16, 1 float16, 2 float32), pools [Hkv, Np,
// page, D] of the same type (one layer, contiguous), tables int32 [B,
// max_pages], lengths int32 [B] (rows valid AFTER this step's write);
// n_splits (1-8) blocks share each slot's walk. D: a multiple of 4 from 16
// to 256; any group Hq / Hkv. Returns the launch's cudaError_t (0 =
// launched), or cudaErrorInvalidValue for a shape the kernel does not
// take.
extern "C" int gofr_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const int* tables,
                                 const int* lengths, void* out, int B, int Hq,
                                 int Hkv, int n_pages, int page, int max_pages,
                                 int D, int dtype, int n_splits, float scale,
                                 void* stream) {
  return dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, tables, lengths,
                         out, B, Hq, Hkv, n_pages, page, max_pages, D, dtype,
                         n_splits, scale, stream);
}

// The same over an int8 pool: k_codes / v_codes int8 [Hkv, Np, page, D]
// (4-byte aligned), k_scales / v_scales float32 [Hkv, Np, page, 1]; q and
// out of the activation type `dtype`.
extern "C" int gofr_paged_decode_i8(const void* q, const void* k_codes,
                                    const void* v_codes, const float* k_scales,
                                    const float* v_scales, const int* tables,
                                    const int* lengths, void* out, int B,
                                    int Hq, int Hkv, int n_pages, int page,
                                    int max_pages, int D, int dtype,
                                    int n_splits, float scale, void* stream) {
  return dispatch<true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                        lengths, out, B, Hq, Hkv, n_pages, page, max_pages, D,
                        dtype, n_splits, scale, stream);
}
#endif  // GOFR_IN_PART(0)
