// Paged decode attention for Hopper (sm_90a), bf16 and int8 pools.
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
// So the design reads each K/V page once and does everything else on
// chip:
//   - one block per (slot, KV head) handles all `group` query heads of
//     that KV head together, so a page is read once for the group
//     (the GQA saving the TPU kernel got from its [group, hd] q block);
//   - it loads its own table entries and walks only
//     ceil(lengths[b] / pg) pages (never past the table), each one
//     contiguous [pg, hd] block of bf16 or int8, copied to shared
//     memory with 16-byte loads (8 bf16 values or 16 codes a load);
//     an int8 page brings its pg float scales per side beside it;
//   - int8 codes are never dequantized into memory: the row scales fold
//     out of both products, s = scale_k[r] * (q . codes_k[r]) and
//     acc += (p * scale_v[r]) * codes_v[r], while l sums the unscaled
//     p. Scales of rows past lengths[b] are staged as 0, so a masked
//     row adds 0, never 0 * garbage;
//   - warp w owns query heads w, w + 4, ...: scores, online-softmax
//     state and the output accumulator stay in registers / shared
//     memory, in float32;
//   - the score loop reads K rows in a lane-rotated order, so the 32
//     lanes of a warp hit 32 different shared-memory banks (an int8
//     row is half as wide, so lanes meet about two to a bank; not
//     tuned).
// Not yet: split-KV (flash-decoding) for small batches, cp.async double
// buffering of the next page — the later work toward the byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_HEADS_PER_WARP = 4;   // group <= 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// two neighbouring elements of a page row, as float
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

// Q8: the pages are int8 codes with a float32 scale per row
// (k_scales / v_scales [Hkv, Np, page, 1]); else bf16, scales unused.
template <int D, bool Q8>
__global__ void __launch_bounds__(NTHREADS)
paged_decode(const __nv_bfloat16* __restrict__ q,
             const std::conditional_t<Q8, int8_t, __nv_bfloat16>* __restrict__ k_pool,
             const std::conditional_t<Q8, int8_t, __nv_bfloat16>* __restrict__ v_pool,
             const float* __restrict__ k_scales,
             const float* __restrict__ v_scales,
             const int* __restrict__ tables,
             const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out,
             int Hq, int Hkv, int n_pages, int page, int max_pages,
             float scale) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  constexpr int DPL = D / 32;   // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = Hq / Hkv;
  T* kbuf = reinterpret_cast<T*>(smem);                           // [page][D]
  T* vbuf = kbuf + (size_t)page * D;                              // [page][D]
  float* qs = reinterpret_cast<float*>(vbuf + (size_t)page * D);  // [group][D]
  float* ps = qs + group * D;                                     // [group][page]
  float* kss = ps + group * page;                                 // [page], Q8
  float* vss = kss + page;                                        // [page], Q8

  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int length = max(lengths[b], 0);
  const int n_walk = min((length + page - 1) / page, max_pages);

  const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)hk * group) * D;
  for (int i = tid; i < group * D; i += NTHREADS)
    qs[i] = __bfloat162float(qb[i]) * scale;

  float m[MAX_HEADS_PER_WARP], l[MAX_HEADS_PER_WARP];
  float acc[MAX_HEADS_PER_WARP][DPL];
#pragma unroll
  for (int gi = 0; gi < MAX_HEADS_PER_WARP; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[gi][j] = 0.f;
  }

  const size_t page_elems = (size_t)page * D;
  const T* kh = k_pool + (size_t)hk * n_pages * page_elems;
  const T* vh = v_pool + (size_t)hk * n_pages * page_elems;
  const int chunks = (int)(page_elems * sizeof(T) / 16);   // uint4 per page

  for (int pi = 0; pi < n_walk; ++pi) {
    const int pid = min(max(tables[(size_t)b * max_pages + pi], 0), n_pages - 1);
    const uint4* ksrc = reinterpret_cast<const uint4*>(kh + (size_t)pid * page_elems);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vh + (size_t)pid * page_elems);
    const int base = pi * page;
    __syncthreads();   // previous page fully consumed (and qs written)
    for (int i = tid; i < chunks; i += NTHREADS) {
      reinterpret_cast<uint4*>(kbuf)[i] = ksrc[i];
      reinterpret_cast<uint4*>(vbuf)[i] = vsrc[i];
    }
    if (Q8) {
      // the page's row scales; rows past the length get 0
      const size_t srow = ((size_t)hk * n_pages + pid) * page;
      for (int r = tid; r < page; r += NTHREADS) {
        const bool live = base + r < length;
        kss[r] = live ? k_scales[srow + r] : 0.f;
        vss[r] = live ? v_scales[srow + r] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int gi = 0; gi < MAX_HEADS_PER_WARP; ++gi) {
      const int g = warp + gi * NWARPS;
      // continue, not break: the loop still unrolls fully, so m / l /
      // acc stay in registers instead of spilling to local memory
      if (g >= group) continue;
      const float* qg = qs + g * D;
      float* pg = ps + g * page;
      // scores: lane r takes rows r, r + 32, ...; the d loop starts at a
      // lane-dependent offset so lanes read distinct banks
      float mx = NEG_INF;
      for (int r = lane; r < page; r += 32) {
        const T* kr = kbuf + (size_t)r * D;
        float dot = 0.f;
#pragma unroll 8
        for (int t = 0; t < D / 2; ++t) {
          const int d = 2 * ((t + lane) % (D / 2));
          const float2 kv = pair(kr + d);
          dot += qg[d] * kv.x + qg[d + 1] * kv.y;
        }
        if (Q8) dot *= kss[r];
        const float sv = (base + r < length) ? dot : NEG_INF;
        pg[r] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[gi], mx);
      const float alpha = __expf(m[gi] - m_new);
      float sum = 0.f;
      for (int r = lane; r < page; r += 32) {
        // p masked explicitly: with every position masked, s == m_new
        // == NEG_INF and exp(s - m_new) would be 1
        const float p = (base + r < length) ? __expf(pg[r] - m_new) : 0.f;
        pg[r] = Q8 ? p * vss[r] : p;   // P V takes p * scale_v; l takes p
        sum += p;
      }
      sum = warp_sum(sum);
      l[gi] = l[gi] * alpha + sum;
      m[gi] = m_new;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[gi][j] *= alpha;
      for (int r = 0; r < page; ++r) {
        const float p = pg[r];
        const T* vr = vbuf + (size_t)r * D + lane * DPL;
#pragma unroll
        for (int j = 0; j < DPL; j += 2) {
          const float2 vv = pair(vr + j);
          acc[gi][j] += p * vv.x;
          acc[gi][j + 1] += p * vv.y;
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int gi = 0; gi < MAX_HEADS_PER_WARP; ++gi) {
    const int g = warp + gi * NWARPS;
    if (g >= group) continue;
    const float inv = 1.f / fmaxf(l[gi], 1e-30f);
    __nv_bfloat16* og = out + ((size_t)b * Hq + (size_t)hk * group + g) * D + lane * DPL;
#pragma unroll
    for (int j = 0; j < DPL; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(og + j) =
          __floats2bfloat162_rn(acc[gi][j] * inv, acc[gi][j + 1] * inv);
  }
}

template <int D, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* lengths, void* out, int B, int Hq, int Hkv, int n_pages,
           int page, int max_pages, float scale, cudaStream_t s) {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  const int group = Hq / Hkv;
  const size_t smem = 2 * (size_t)page * D * sizeof(T)
                      + (size_t)group * D * sizeof(float)
                      + (size_t)group * page * sizeof(float)
                      + (Q8 ? 2 * (size_t)page * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode<D, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_decode<D, Q8><<<dim3(B, Hkv), dim3(NTHREADS), smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), k_scales, v_scales, tables, lengths,
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, n_pages, page, max_pages, scale);
  return (int)cudaGetLastError();
}

template <bool Q8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scales, const float* v_scales, const int* tables,
             const int* lengths, void* out, int B, int Hq, int Hkv, int n_pages,
             int page, int max_pages, int D, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > NWARPS * MAX_HEADS_PER_WARP ||
      n_pages <= 0 || page <= 0 || (page * D) % 16 != 0 || max_pages <= 0 ||
      Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, Q8>(q, k_pool, v_pool, k_scales, v_scales, tables,
                          lengths, out, B, Hq, Hkv, n_pages, page, max_pages,
                          scale, s);
  if (D == 128)
    return launch<128, Q8>(q, k_pool, v_pool, k_scales, v_scales, tables,
                           lengths, out, B, Hq, Hkv, n_pages, page, max_pages,
                           scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). q [B, Hq, D], pools [Hkv, Np, page, D]
// (one layer, contiguous), tables int32 [B, max_pages], lengths int32
// [B] (rows valid AFTER this step's write), out [B, Hq, D]. Returns the
// launch's cudaError_t (0 = launched), or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int gofr_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const int* tables,
                                 const int* lengths, void* out, int B, int Hq,
                                 int Hkv, int n_pages, int page, int max_pages,
                                 int D, float scale, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, tables, lengths,
                         out, B, Hq, Hkv, n_pages, page, max_pages, D, scale,
                         stream);
}

// The same over an int8 pool: k_codes / v_codes int8 [Hkv, Np, page, D]
// (16-byte aligned), k_scales / v_scales float32 [Hkv, Np, page, 1].
extern "C" int gofr_paged_decode_i8(const void* q, const void* k_codes,
                                    const void* v_codes, const float* k_scales,
                                    const float* v_scales, const int* tables,
                                    const int* lengths, void* out, int B,
                                    int Hq, int Hkv, int n_pages, int page,
                                    int max_pages, int D, float scale,
                                    void* stream) {
  return dispatch<true>(q, k_codes, v_codes, k_scales, v_scales, tables,
                        lengths, out, B, Hq, Hkv, n_pages, page, max_pages, D,
                        scale, stream);
}
