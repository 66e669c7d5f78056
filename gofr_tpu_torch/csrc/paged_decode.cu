// Paged decode attention for Hopper (sm_90a), plain and int8 pools: the
// bf16 kernel at head dims 64 and 128 below, and attn_simt.cuh's float32
// kernel for every other head dim and for float16 and float32.
//
// Replaces the Pallas TPU kernel gofr_tpu/ops/paged_attention.py
// `_paged_decode_kernel` (wrapper `paged_decode_attention_pallas`), both
// of its branches: a bf16 pool (C entry gofr_paged_decode) and the
// quantized {q: int8, s: f32 [.., 1]} pool (`quantized=True`, C entry
// gofr_paged_decode_i8). It computes the same function: one new token
// per slot b attends to the first lengths[b] rows of that slot, read in
// place through its block table from one layer's head-major pool
// [Hkv, Np, pg, hd]. Table ids are clamped to Np - 1 on read, positions
// >= lengths[b] are masked (logit NEG_INF and p = 0 explicitly), and the
// output divides by max(l, 1e-30), so a zero-length slot writes exact
// zeros. An int8 row stands for codes * scale (scale per row), in
// float32, as the TPU kernel's in-register `k * ks_buf` dequantizes it.
//
// What bounds it on the H100: HBM bytes. Per (slot, KV head) per layer
// it must read 2 * len * hd * 2 bytes of K and V (int8: 2 * len *
// (hd + 4), about 0.53x at hd 64) and does only 4 * group * hd flops
// per row read — about group / 1 flop per byte (int8: twice that), two
// orders of magnitude under the card's ~295 flop/byte balance point.
// At serving batch sizes, though, it is the latency of the longest
// slot's walk that sets the time: B x Hkv work items (64 at B = 8)
// under-fill the 132 SMs, and one item's pages come one after another.
// So the design cuts that walk and every step of it:
//   - split-KV: the grid is (S, Hkv, B); split s walks its share of ITS
//     slot's pages, worked out on the card from lengths[b] (the wrapper
//     picks S from the shapes alone, ops/paged_attention.kv_splits, so
//     the host never reads a length). The S splits of one (slot, KV
//     head) are one thread-block cluster: each leaves its float32
//     partial (m, l, o) per query head in its shared memory, and after
//     a cluster barrier every split merges a share of the outputs from
//     all S partials through distributed shared memory, in split order
//     (deterministic): out = sum_s e^(m_s - M) o_s / max(sum_s e^(m_s -
//     M) l_s, 1e-30). A second barrier keeps every block alive until
//     the others have read it. An empty split's partial is (NEG_INF, 0,
//     0) and weighs exactly 0; with S = 1 there is no cluster and the
//     block divides its own o by max(l, 1e-30). No extra launch;
//   - inside a block, warp w owns a quarter of every page's rows and
//     walks the split's pages on its own: it stages its rows, scores
//     them, keeps its own online-softmax state (m, l and o for all
//     `group` query heads) and never waits for the other warps until
//     the walk is done, when the four warp partials merge in warp order
//     (the same formula). One block per (split, KV head, slot) serves
//     the whole group, so a page is read once for the group;
//   - each warp keeps a ring of STAGES pages of its rows in flight with
//     16-byte cp.async (rows past the length are zero-filled, not read)
//     and reads the table entry of the page it will issue next before
//     the current page's math, so no lane waits on a table load;
//   - an int8 page is staged as raw codes (half the bytes) with its row
//     scales beside it (0 for rows past the length); each code is read
//     and converted to float exactly once, in registers, for all the
//     heads of the group (the score lanes own whole rows, the P V lanes
//     whole columns), and the scales fold out of both products: s =
//     scale_k[r] * (q . codes_k[r]) and acc += (p * scale_v[r]) *
//     codes_v[r], while l sums the unscaled p;
//   - scores: two lanes per row, each over half of hd, for up to 4 heads
//     at a time (the row's K values are read once for them); P V: lane
//     l owns column pair l (and l + 32 at hd 128) of every head and
//     takes each row's p from the row's lane by shuffle, so each V value
//     is read once for the whole group. All of it in float32;
//   - staged rows are padded (bf16 by 16 bytes, a lane reading half a
//     row; int8 by 32 bytes, a lane reading every other 16-byte chunk),
//     so the score loop's 16-byte reads hit distinct bank groups.
// What bounds it now: per split, one warp's few dependent pages and the
// two merges; still far from the byte bound at these sizes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_simt.cuh"
#include "paged_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_GROUP = 16;
constexpr int HPP = 4;           // query heads per score pass
constexpr int PASS = 16;         // rows a warp scores at once: two lanes each
constexpr int STAGES = 3;        // pages of a warp's ring in flight or in use
constexpr float NEG_INF = -1e30f;

// The pool element type and its staged row stride. bf16 rows are padded
// by 16 bytes and a score lane reads one half of its row; int8 rows are
// padded by 32 bytes and a score lane reads every other 16-byte chunk.
// Either way the 16-byte reads of the 8 lanes of a phase (4 rows, two
// lanes each) fall in distinct bank groups.
template <int D, bool Q8>
struct Layout {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  static constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte chunk
  static constexpr int RS = Q8 ? D + 32 : D + 8;   // staged row stride, elements
  static constexpr int CPL = D / 2 / EPC;          // chunks per score lane
  // chunk c (0 .. CPL-1) of score lane h: its index in the row
  __device__ static constexpr int chunk(int h, int c) {
    return Q8 ? 2 * c + h : h * CPL + c;
  }
};

// Shared-memory plan of one block (byte offsets), shared by the kernel
// and its launcher: STAGES pages of K and V rows [STAGES][K|V][page][RS]
// (int8: plus their row scales [STAGES][K|V][page]), of which warp w
// only touches its own rows; the query [group][2][QS] in the order the
// score lanes read it; the warps' softmax statistics. After the walk the
// stage area holds the warps' partial outputs [NWARPS][group][D] (then
// the block's [group][D]).
template <int D, bool Q8>
struct Plan {
  using L = Layout<D, Q8>;
  static constexpr int QS = D / 2 + 4;        // padded float stride of a q half
  size_t side, stages, qs, scales, stats, total;
  __host__ __device__ Plan(int page, int group) {
    side = (size_t)page * L::RS * sizeof(typename L::T);   // one stage, one side
    stages = 2 * STAGES * side;
    const size_t red = (size_t)NWARPS * group * D * 4;
    qs = stages > red ? stages : red;
    scales = qs + (size_t)group * 2 * QS * 4;
    stats = scales + (Q8 ? (size_t)2 * STAGES * page * 4 : 0);
    total = stats + (2 * NWARPS + 2) * MAX_GROUP * 4;
  }
};

// a staged 16-byte chunk as floats: 8 bf16 values (exact: a bf16 is the
// top half of a float) or 16 int8 codes (exact)
__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(word(w, i) << 16);
    f[2 * i + 1] = __uint_as_float(word(w, i) & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = code(w, i);
}

// two neighbouring elements of a staged row, as floats
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

// Q8: the pages are int8 codes with a float32 scale per row
// (k_scales / v_scales [Hkv, Np, page, 1]); else bf16, scales unused.
// GMAX >= group bounds the per-head register arrays (4 or 16).
template <int D, bool Q8, int GMAX>
__global__ void __launch_bounds__(NTHREADS, 1)
paged_decode(const __nv_bfloat16* __restrict__ q,
             const std::conditional_t<Q8, int8_t, __nv_bfloat16>* __restrict__ k_pool,
             const std::conditional_t<Q8, int8_t, __nv_bfloat16>* __restrict__ v_pool,
             const float* __restrict__ k_scales,
             const float* __restrict__ v_scales,
             const int* __restrict__ tables,
             const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out,
             int Hq, int Hkv, int n_pages, int page, int max_pages,
             int n_splits, float scale) {
  using Ly = Layout<D, Q8>;
  using T = typename Ly::T;
  using P = Plan<D, Q8>;
  constexpr int EPC = Ly::EPC, RS = Ly::RS, CPL = Ly::CPL, QS = P::QS;
  constexpr int NPL = D / 64;      // column pairs per lane in P V
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = Hq / Hkv;
  const P plan(page, group);
  // stage st: K rows at rows(2 st), V rows at rows(2 st + 1)
  auto rows_of = [&](int i) {
    return reinterpret_cast<T*>(smem + (size_t)i * plan.side);
  };
  float* const red = reinterpret_cast<float*>(smem);            // after the walk
  float* const qs = reinterpret_cast<float*>(smem + plan.qs);   // [group][2][QS]
  float* const scl = reinterpret_cast<float*>(smem + plan.scales);  // [STAGES][K|V][page]
  float* const wm = reinterpret_cast<float*>(smem + plan.stats);    // [NWARPS][16]
  float* const wl = wm + NWARPS * MAX_GROUP;
  float* const st_m = wl + NWARPS * MAX_GROUP;                      // [16]
  float* const st_l = st_m + MAX_GROUP;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int length = max(lengths[b], 0);
  const int n_walk = min((length + page - 1) / page, max_pages);
  const int per = (n_walk + n_splits - 1) / n_splits;
  const int p0 = min(split * per, n_walk), p1 = min(p0 + per, n_walk);
  // this warp's rows of every page
  const int rpw = (page + NWARPS - 1) / NWARPS;
  const int rbeg = min(warp * rpw, page), rend = min(rbeg + rpw, page);

  // q, pre-scaled, in the order score lane h reads its chunks
  const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)hk * group) * D;
  for (int i = tid; i < group * D; i += NTHREADS) {
    const int g = i / D, d = i % D, ci = d / EPC;
    const int h = Q8 ? ci & 1 : ci / CPL, c = Q8 ? ci >> 1 : ci % CPL;
    qs[g * 2 * QS + h * QS + c * EPC + d % EPC] = __bfloat162float(qb[i]) * scale;
  }
  __syncthreads();

  const size_t page_elems = (size_t)page * D;
  const T* kh = k_pool + (size_t)hk * n_pages * page_elems;
  const T* vh = v_pool + (size_t)hk * n_pages * page_elems;
  const int* table = tables + (size_t)b * max_pages;
  auto page_id = [&](int pi) { return min(max(table[pi], 0), n_pages - 1); };

  // issue this warp's rows of page pi (table id pid) into stage st; rows
  // at or past the length are zero-filled without a read
  auto issue = [&](int pi, int pid, int st) {
    const int live = length - pi * page;
    const T* ksrc = kh + (size_t)pid * page_elems;
    const T* vsrc = vh + (size_t)pid * page_elems;
    T* kd = rows_of(2 * st);
    T* vd = rows_of(2 * st + 1);
    for (int c = lane; c < (rend - rbeg) * (D / EPC); c += 32) {
      const int r = rbeg + c / (D / EPC), o = EPC * (c % (D / EPC));
      const int n = r < live ? 16 : 0;
      cp_async16(kd + r * RS + o, ksrc + (size_t)r * D + o, n);
      cp_async16(vd + r * RS + o, vsrc + (size_t)r * D + o, n);
    }
    if (Q8) {
      const size_t srow = ((size_t)hk * n_pages + pid) * page;
      float* ks = scl + (size_t)(2 * st) * page;
      for (int r = rbeg + lane; r < rend; r += 32) {
        const int n = r < live ? 4 : 0;
        cp_async4(ks + r, k_scales + srow + r, n);
        cp_async4(ks + page + r, v_scales + srow + r, n);
      }
    }
  };

  // this warp's online-softmax state, per head; lane l holds o's column
  // pairs l and l + 32
  float m[GMAX], l[GMAX], acc[GMAX][2 * NPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NPL; ++j) acc[g][j] = 0.f;
  }

  // the ring: pages p0 .. p0 + STAGES - 2 in flight before the walk
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (p0 + k < p1) issue(p0 + k, page_id(p0 + k), k);
    cp_async_commit();
  }
  int pid_next = p0 + STAGES - 1 < p1 ? page_id(p0 + STAGES - 1) : 0;

  for (int pi = p0; pi < p1; ++pi) {
    const int st = (pi - p0) % STAGES;
    if (pi + STAGES - 1 < p1) {
      issue(pi + STAGES - 1, pid_next, (pi - p0 + STAGES - 1) % STAGES);
      if (pi + STAGES < p1) pid_next = page_id(pi + STAGES);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();   // this warp's rows of page pi are staged
    const int nlive = min(rend, length - pi * page) - rbeg;   // warp-uniform
    if (nlive > 0) {
      const T* kbuf = rows_of(2 * st);
      const T* vbuf = rows_of(2 * st + 1);
      const float* kss = scl + (size_t)(2 * st) * page;
      const float* vss = kss + page;
      for (int rr0 = 0; rr0 < nlive; rr0 += PASS) {
        // lanes 2 j and 2 j + 1 score row rbeg + rr0 + j, halves 0 and 1
        const int h = lane & 1;
        const bool live = rr0 + (lane >> 1) < nlive;
        const int r = min(rbeg + rr0 + (lane >> 1), rend - 1);
        const T* kr = kbuf + (size_t)r * RS;
        const float ksc = Q8 ? kss[r] : 1.f;
        const float vsc = Q8 ? vss[r] : 1.f;
        float p[GMAX], alpha[GMAX];
#pragma unroll
        for (int g0 = 0; g0 < GMAX; g0 += HPP) {
          if (g0 >= group) break;
          float dot[HPP];
#pragma unroll
          for (int gi = 0; gi < HPP; ++gi) dot[gi] = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float kf[EPC];
            unpack(*reinterpret_cast<const uint4*>(kr + EPC * Ly::chunk(h, c)), kf);
#pragma unroll
            for (int gi = 0; gi < HPP; ++gi) {
              if (g0 + gi >= group) continue;
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
            if (g >= group) continue;
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
          if (g >= group) continue;
#pragma unroll
          for (int j = 0; j < 2 * NPL; ++j) acc[g][j] *= alpha[g];
        }
        const int nr = min(PASS, nlive - rr0);
        for (int j = 0; j < nr; ++j) {
          const T* vr = vbuf + (size_t)(rbeg + rr0 + j) * RS + 2 * lane;
          float2 v[NPL];
#pragma unroll
          for (int k = 0; k < NPL; ++k) v[k] = pair(vr + 64 * k);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g >= group) continue;
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
  // partial: red [group][D] (o), st_m, st_l
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= group) continue;
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      *reinterpret_cast<float2*>(red + ((size_t)warp * group + g) * D + 64 * k + 2 * lane) =
          make_float2(acc[g][2 * k], acc[g][2 * k + 1]);
    if (lane == 0) {
      wm[warp * MAX_GROUP + g] = m[g];
      wl[warp * MAX_GROUP + g] = l[g];
    }
  }
  __syncthreads();
  for (int e = tid; e < group * D; e += NTHREADS) {
    const int g = e / D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, wm[w * MAX_GROUP + g]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float wt = __expf(wm[w * MAX_GROUP + g] - M);
      L += wt * wl[w * MAX_GROUP + g];
      o += wt * red[(size_t)w * group * D + e];
    }
    red[e] = o;   // only this thread reads element e of warp 0's partial
    if (e % D == 0) {
      st_m[g] = M;
      st_l[g] = L;
    }
  }
  __syncthreads();

  __nv_bfloat16* ob = out + ((size_t)b * Hq + (size_t)hk * group) * D;
  if (n_splits == 1) {
    for (int e = tid; e < group * D / 2; e += NTHREADS) {
      const int g = (2 * e) / D, d = (2 * e) % D;
      const float inv = 1.f / fmaxf(st_l[g], 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(ob + g * D + d) =
          __floats2bfloat162_rn(red[g * D + d] * inv, red[g * D + d + 1] * inv);
    }
    return;
  }

  // merge the S partials of this (slot, KV head) in split order; split
  // r writes every S-th group of NTHREADS column pairs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial is in its shared memory
  const int rank = (int)cluster.block_rank();
  for (int e = rank * NTHREADS + tid; e < group * D / 2; e += n_splits * NTHREADS) {
    const int g = (2 * e) / D, d = (2 * e) % D;
    float M = NEG_INF;
    for (int s = 0; s < n_splits; ++s)
      M = fmaxf(M, cluster.map_shared_rank(st_m, s)[g]);
    float L = 0.f, o0 = 0.f, o1 = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = __expf(cluster.map_shared_rank(st_m, s)[g] - M);
      L += w * cluster.map_shared_rank(st_l, s)[g];
      const float2 o = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(red, s) + g * D + d);
      o0 += w * o.x;
      o1 += w * o.y;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(ob + g * D + d) =
        __floats2bfloat162_rn(o0 * inv, o1 * inv);
  }
  cluster.sync();   // no split leaves while another still reads it
}

template <int D, bool Q8, int GMAX>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* lengths, void* out, int B, int Hq, int Hkv, int n_pages,
           int page, int max_pages, int n_splits, float scale,
           cudaStream_t s) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  const Plan<D, Q8> plan(page, Hq / Hkv);
  return launch_split(
      paged_decode<D, Q8, GMAX>, dim3(n_splits, Hkv, B), NTHREADS, plan.total,
      n_splits, s, static_cast<const __nv_bfloat16*>(q),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool), k_scales,
      v_scales, tables, lengths, static_cast<__nv_bfloat16*>(out), Hq, Hkv,
      n_pages, page, max_pages, n_splits, scale);
}

template <int D, bool Q8>
int launch_group(const void* q, const void* k_pool, const void* v_pool,
                 const float* k_scales, const float* v_scales,
                 const int* tables, const int* lengths, void* out, int B,
                 int Hq, int Hkv, int n_pages, int page, int max_pages,
                 int n_splits, float scale, cudaStream_t s) {
  if (Hq / Hkv <= 4)
    return launch<D, Q8, 4>(q, k_pool, v_pool, k_scales, v_scales, tables,
                            lengths, out, B, Hq, Hkv, n_pages, page,
                            max_pages, n_splits, scale, s);
  return launch<D, Q8, MAX_GROUP>(q, k_pool, v_pool, k_scales, v_scales,
                                  tables, lengths, out, B, Hq, Hkv, n_pages,
                                  page, max_pages, n_splits, scale, s);
}

template <bool Q8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scales, const float* v_scales, const int* tables,
             const int* lengths, void* out, int B, int Hq, int Hkv, int n_pages,
             int page, int max_pages, int D, int dtype, int n_splits,
             float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_GROUP ||
      n_pages <= 0 || page <= 0 || max_pages <= 0 || Hkv > 65535 ||
      B > 65535 || n_splits < 1 || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == simt::BF16 && (D == 64 || D == 128)) {
    if ((page * D) % 16 != 0) return (int)cudaErrorInvalidValue;
    if (D == 64)
      return launch_group<64, Q8>(q, k_pool, v_pool, k_scales, v_scales,
                                  tables, lengths, out, B, Hq, Hkv, n_pages,
                                  page, max_pages, n_splits, scale, s);
    return launch_group<128, Q8>(q, k_pool, v_pool, k_scales, v_scales,
                                 tables, lengths, out, B, Hq, Hkv, n_pages,
                                 page, max_pages, n_splits, scale, s);
  }
  // every other type and head dim: one block walks a slot's pages alone
  // (n_splits is not read)
  simt::Args a = {};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.k_scales = Q8 ? k_scales : nullptr;
  a.v_scales = Q8 ? v_scales : nullptr;
  a.tables = tables;
  a.len_a = lengths;
  a.out = out;
  a.B = B;
  a.Sq = 1;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.n_pages = n_pages;
  a.page = page;
  a.max_pages = max_pages;
  a.mode = simt::DECODE;
  a.scale = scale;
  return simt::run<true>(a, dtype, s);
}

}  // namespace

// C interface (bound with ctypes). q [B, Hq, D] and out [B, Hq, D] of the
// activation type `dtype` (0 bf16, 1 float16, 2 float32), pools [Hkv, Np,
// page, D] of the same type (one layer, contiguous), tables int32 [B,
// max_pages], lengths int32 [B] (rows valid AFTER this step's write);
// n_splits (1-8) blocks share each slot's walk. bf16 at D = 64 or 128
// runs the kernel above; every other type and head dim (a multiple of 4
// from 16 to 256) the float32 kernel of attn_simt.cuh, unsplit. Returns
// the launch's cudaError_t (0 = launched), or cudaErrorInvalidValue for
// a shape the kernels do not take.
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
// (aligned as the kernel reads them), k_scales / v_scales float32 [Hkv,
// Np, page, 1]; q and out of the activation type `dtype`.
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
