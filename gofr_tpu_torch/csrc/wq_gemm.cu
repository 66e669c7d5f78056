// Weight-only quantized GEMM for Hopper (sm_90a): y[M, N] = (x[M, K] @
// dequant(q)) * s[N], with int8 codes or int4 codes packed two per byte,
// read once from device memory and widened to bf16 in registers.
//
// Replaces no Pallas kernel. On the TPU the product is XLA's:
// gofr_tpu/ops/quant.py `qmatmul` computes (x @ q.astype(x.dtype)) * s and
// counts on XLA to fuse the upcast into the matmul's operand read, so the
// narrow codes are what crosses HBM. A plain PyTorch `x @ q.to(bf16) * s`
// writes a bf16 copy of the weight and reads it again: for Llama-3.2-1B
// in int8 about 6.2 GB a decode step against the codes' 1.24 GB. This
// kernel is what keeps the codes narrow on the card.
//
// Layouts (ops/quant.py): codes [K, N] (TRANS = false: the layer
// matrices and an untied head, output channels contiguous) or [N, K]
// (TRANS = true: the tied head, the embedding table read as x @ E^T,
// contraction contiguous). int4 codes are packed along the last axis:
// byte c holds element 2c in its low nibble and 2c + 1 in its high one,
// two's complement. Scales s [N] float32. x bf16 [M, K] row-major.
// Output: float32 acc * s (the LM head) or bf16 bf16(bf16(acc) * bf16(s))
// (the backbone: the plain version's product rounded to bf16, then the
// scale, as JAX's qmatmul with preferred_element_type = bf16).
//
// What bounds it on the H100: bytes. At decode sizes (M <= 16) each code
// is used M times, far below the ~295 operations a byte that the tensor
// cores need to become the limit; the bound is the codes, scales, x and
// y over 3.35 TB/s. The design only has to stream the codes at the HBM
// rate and keep the widening off the critical path:
//   - every product runs on mma.sync m16n8k16 (bf16 in, f32 out), so the
//     verify pass's 128 rows and the head at any M stay on the tensor
//     cores; rows past M are zeros;
//   - each lane copies its codes with 16-byte cp.async (8 for int4
//     [K, N]; its x fragment words too, in [K, N]) into a ring in shared
//     memory, several steps of the contraction ahead of the product,
//     reads them back itself, and the codes are laid into mma fragments
//     with no shuffle: in the [N, K] layout
//     a lane's 16 contiguous bytes of one row are the k positions its
//     fragments hold in four (int8) or eight (int4) consecutive mma
//     k-steps, the x fragments read with the same permutation of k; in
//     the [K, N] layout a lane reads 16 columns of each of its four k
//     rows and the 16 columns become 16 mma n-tiles, output column
//     16 j + i of the block's 128 being logical column j of tile i;
//   - the widening: code ^ 0x80 (int8) or ^ 0x8 (int4) puts the code plus
//     its bias in the mantissa of 2^23 by one byte permute or mask, one
//     float subtraction removes the bias, and the bf16 is the top half of
//     that exact float (|code| <= 128 has at most 8 significant bits), so
//     two codes pack into a bf16x2 register with one more permute — no
//     conversion instruction, which runs at a quarter of the rate;
//   - a block is 4 warps over one stripe of output columns (128 for
//     [K, N], 32 for [N, K]) and up to 16 (or 32) rows, splitting the
//     contraction between the warps; S blocks of one thread-block
//     cluster split it further (ops/quant.py wq_splits: S from the
//     shapes, so that narrow products such as wk, 512 columns, still
//     fill the card). The warps' partial tiles are summed in shared
//     memory, the S blocks' through distributed shared memory, in a
//     fixed order: the result is deterministic, no atomics, no second
//     launch. The launch neither allocates nor synchronises, so a CUDA
//     graph of the decode step holds it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_common.cuh"

namespace cg = cooperative_groups;

namespace {


__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte i of a word whose int8 codes were xor-ed with 0x80 (code + 128 in
// [0, 255]), as an exact float: 2^23 + (code + 128) - (2^23 + 128).
__device__ __forceinline__ float i8f(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) -
         8388736.0f;
}

// Nibble n of a word whose int4 codes were xor-ed with 0x8 (code + 8 in
// [0, 15]), as an exact float: 2^23 + (code + 8) - (2^23 + 8).
__device__ __forceinline__ float i4f(uint32_t w, int n) {
  return __uint_as_float(0x4B000000u | ((w >> (4 * n)) & 0xFu)) -
         8388616.0f;
}

// Two floats holding small integers, as a bf16x2 register (lo in the low
// half): their top halves, exact since each has at most 8 significant
// bits.
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <bool TRANS, bool INT4, int MT>
struct Tile {
  // warps a block, each on its own share of the contraction
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NW = TRANS ? 32 : 128;     // output columns a block
  static constexpr int R = 16 * MT;               // rows a block
  // one step of the contraction: a k16 row group ([K, N]) or a lane's
  // 16 bytes of a row ([N, K]: 16 int8 or 32 int4 k positions, x 4 lanes)
  static constexpr int STEP = TRANS ? (INT4 ? 128 : 64) : 16;
  // partial-tile row stride in floats; [K, N] also skews a float every 32
  // columns, so that the 32 lanes' stores fall in 32 banks
  static constexpr int RS = TRANS ? 36 : 132;
  static constexpr int ACC = TRANS ? 4 * MT : 16;  // mma tiles a warp
  // the ring of copies in flight: STAGES steps of every warp's chunks
  // (more stages measured no faster on the H100: the [K, N] stream is
  // bound by its access pattern, not by the bytes in flight)
  static constexpr int STAGES = TRANS ? 8 : 4;
  static constexpr int CHUNK = (!TRANS && INT4) ? 8 : 16;
  static constexpr int CODE_SLOT = 4 * 32 * CHUNK;
  // [K, N]: the step's x fragment words ride in the ring with the codes
  static constexpr int X_SLOT = TRANS ? 0 : 4 * 32 * 4;
  static constexpr int WARP_SLOT = CODE_SLOT + X_SLOT;
  static constexpr int STAGE_BYTES = WARPS * WARP_SLOT;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int RED = WARPS * R * RS * 4;   // the partial tiles
  static constexpr int SMEM = RING > RED ? RING : RED;
  __device__ static int idx(int row, int col) {
    return row * RS + col + (TRANS ? 0 : (col >> 5));
  }
};

// One step's codes of this lane, copied into its slot of the ring:
// [K, N], rows k0 + {2t, 2t + 1, 2t + 8, 2t + 9}, 16 columns from 16 g
// (16 bytes, int4 8); [N, K], one 16-byte run of each of the 4 n-tiles'
// row n0 + 8 nt + g. Chunk r of lane l sits at (r * 32 + l) * CHUNK of
// the warp's slot, so a lane reads its own bytes back and the 32 lanes'
// reads of one chunk fall in consecutive banks. Codes past N are zeros.
template <bool TRANS, bool INT4>
__device__ __forceinline__ void copy_step(unsigned char* slot,
                                           const uint8_t* __restrict__ q,
                                           const __nv_bfloat16* __restrict__ x,
                                           int step, int M, int N, int K,
                                           int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (!TRANS) {
    // the mma A fragment of this lane: x[m0 + g (+8)][k0 + 2t (+8)], two
    // bf16 a word; rows past M are zeros
    unsigned char* xs = slot + 4 * 32 * (INT4 ? 8 : 16);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = m0 + g + 8 * (a & 1);
      const int col = step * 16 + 2 * t + 8 * (a >> 1);
      const bool valid = row < M;
      cp_async4(xs + (a * 32 + lane) * 4,
                valid ? x + (size_t)row * K + col : x, valid ? 4 : 0);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint8_t* src;
    bool valid;
    if constexpr (!TRANS) {
      const int col = n0 + 16 * g;
      const size_t row_bytes = INT4 ? (size_t)N / 2 : (size_t)N;
      const int k = step * 16 + 2 * t + (r & 1) + 8 * (r >> 1);
      valid = col < N;
      src = q + (size_t)k * row_bytes + (INT4 ? col / 2 : col);
    } else {
      const size_t row_bytes = INT4 ? (size_t)K / 2 : (size_t)K;
      const int n = n0 + 8 * r + g;
      valid = n < N;
      src = q + (size_t)n * row_bytes + (size_t)step * 64 + 16 * t;
    }
    unsigned char* dst = slot + (r * 32 + lane) * (!TRANS && INT4 ? 8 : 16);
    if constexpr (!TRANS && INT4)
      cp_async8(dst, valid ? src : q, valid ? 8 : 0);
    else
      cp_async16(dst, valid ? src : q, valid ? 16 : 0);
  }
}

template <bool TRANS, bool INT4>
__device__ __forceinline__ void read_step(uint4 (&v)[4], uint32_t (&a)[4],
                                          const unsigned char* slot,
                                          int lane) {
  if constexpr (!TRANS) {
    const unsigned char* xs = slot + 4 * 32 * (INT4 ? 8 : 16);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const uint32_t*>(xs + (i * 32 + lane) * 4);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if constexpr (!TRANS && INT4) {
      const uint2 w = *reinterpret_cast<const uint2*>(slot + (r * 32 + lane) * 8);
      v[r] = make_uint4(w.x, w.y, 0u, 0u);
    } else {
      v[r] = *reinterpret_cast<const uint4*>(slot + (r * 32 + lane) * 16);
    }
  }
}

// The products of one step: acc += x[rows, k of the step] @ codes.
template <bool TRANS, bool INT4, int MT>
__device__ __forceinline__ void compute_step(
    float (&acc)[Tile<TRANS, INT4, MT>::ACC][4], const uint4 (&v)[4],
    const uint32_t (&a)[4], const __nv_bfloat16* __restrict__ x, int step,
    int M, int K, int m0, int g, int t) {
  constexpr uint32_t BIAS = INT4 ? 0x88888888u : 0x80808080u;
  if constexpr (!TRANS) {
    const uint32_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float e[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (INT4)
          e[r] = i4f(word(v[r], i >> 3) ^ BIAS, i & 7);
        else
          e[r] = i8f(word(v[r], i >> 2) ^ BIAS, i & 3);
      }
      mma_16816(acc[i], a0, a1, a2, a3, bf2(e[0], e[1]), bf2(e[2], e[3]));
    }
  } else {
    constexpr int J = INT4 ? 8 : 4;        // mma k-steps a step
    const int kbase = step * Tile<TRANS, INT4, MT>::STEP + (INT4 ? 32 : 16) * t;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint32_t b0[4], b1[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if constexpr (INT4) {
          const uint32_t w = word(v[nt], j >> 1) ^ BIAS;
          const int h = 4 * (j & 1);
          b0[nt] = bf2(i4f(w, h), i4f(w, h + 1));
          b1[nt] = bf2(i4f(w, h + 2), i4f(w, h + 3));
        } else {
          const uint32_t w = word(v[nt], j) ^ BIAS;
          b0[nt] = bf2(i8f(w, 0), i8f(w, 1));
          b1[nt] = bf2(i8f(w, 2), i8f(w, 3));
        }
      }
      const int k = kbase + 4 * j;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ra = m0 + 16 * mt + g, rb = ra + 8;
        uint2 pa = make_uint2(0u, 0u), pb = make_uint2(0u, 0u);
        if (ra < M)
          pa = __ldg(reinterpret_cast<const uint2*>(x + (size_t)ra * K + k));
        if (rb < M)
          pb = __ldg(reinterpret_cast<const uint2*>(x + (size_t)rb * K + k));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt * 4 + nt], pa.x, pb.x, pa.y, pb.y, b0[nt], b1[nt]);
      }
    }
  }
}

// Output (m, n) from its float32 sum: acc * s (float32 out), or
// bf16(bf16(acc) * bf16(s)).
__device__ __forceinline__ void store(void* y, const float* __restrict__ s,
                                      float v, int m, int n, int M, int N,
                                      int out_f32) {
  if (m >= M || n >= N) return;
  const size_t o = (size_t)m * N + n;
  if (out_f32) {
    static_cast<float*>(y)[o] = v * s[n];
  } else {
    const float yb = __bfloat162float(__float2bfloat16_rn(v));
    const float sb = __bfloat162float(__float2bfloat16_rn(s[n]));
    static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16_rn(yb * sb);
  }
}

template <bool TRANS, bool INT4, int MT>
__global__ void __launch_bounds__(Tile<TRANS, INT4, MT>::THREADS)
    wq_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ q, const float* __restrict__ s,
                   void* __restrict__ y, int M, int N, int K, int out_f32) {
  using T = Tile<TRANS, INT4, MT>;
  // the copy ring during the walk, the partial tiles after it
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = gridDim.x, split = blockIdx.x;
  const int m0 = blockIdx.y * T::R, n0 = blockIdx.z * T::NW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // this warp's share of the contraction: worker u of U, steps [s0, s1)
  const int steps = K / T::STEP;
  const int u = split * T::WARPS + warp, U = S * T::WARPS;
  const int s0 = (int)((long long)steps * u / U);
  const int n_steps = (int)((long long)steps * (u + 1) / U) - s0;

  float acc[T::ACC][4];
#pragma unroll
  for (int i = 0; i < T::ACC; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  // STAGES - 1 steps in flight ahead of the one being multiplied; each
  // lane waits for its own copies only (cp.async groups are per thread)
  unsigned char* ring = smem + warp * T::WARP_SLOT;
#pragma unroll
  for (int p = 0; p < T::STAGES - 1; ++p) {
    if (p < n_steps)
      copy_step<TRANS, INT4>(ring + p * T::STAGE_BYTES, q, x, s0 + p, M, N,
                              K, m0, n0, lane);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    const int ahead = i + T::STAGES - 1;
    if (ahead < n_steps)
      copy_step<TRANS, INT4>(ring + (ahead % T::STAGES) * T::STAGE_BYTES, q,
                              x, s0 + ahead, M, N, K, m0, n0, lane);
    cp_async_commit();
    cp_async_wait<T::STAGES - 1>();
    uint4 v[4];
    uint32_t a[4];
    read_step<TRANS, INT4>(v, a, ring + (i % T::STAGES) * T::STAGE_BYTES,
                           lane);
    compute_step<TRANS, INT4, MT>(acc, v, a, x, s0 + i, M, K, m0, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring's memory becomes red
  float* red = reinterpret_cast<float*>(smem);

  // this warp's partial tile into shared memory
  float* mine = red + warp * T::R * T::RS;
  if constexpr (!TRANS) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mine[T::idx(g, 32 * t + i)] = acc[i][0];
      mine[T::idx(g, 32 * t + 16 + i)] = acc[i][1];
      mine[T::idx(g + 8, 32 * t + i)] = acc[i][2];
      mine[T::idx(g + 8, 32 * t + 16 + i)] = acc[i][3];
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int row = 16 * mt + g, col = 8 * nt + 2 * t;
        const float* c = acc[mt * 4 + nt];
        mine[T::idx(row, col)] = c[0];
        mine[T::idx(row, col + 1)] = c[1];
        mine[T::idx(row + 8, col)] = c[2];
        mine[T::idx(row + 8, col + 1)] = c[3];
      }
  }
  __syncthreads();
  // the block's sum, warps in order, into warp 0's tile
  constexpr int E = T::R * T::NW;
  for (int e = threadIdx.x; e < E; e += T::THREADS) {
    const int i = T::idx(e / T::NW, e % T::NW);
    float v = red[i];
#pragma unroll
    for (int w = 1; w < T::WARPS; ++w) v += red[w * T::R * T::RS + i];
    red[i] = v;
  }

  if (S == 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += T::THREADS)
      store(y, s, red[T::idx(e / T::NW, e % T::NW)], m0 + e / T::NW,
            n0 + e % T::NW, M, N, out_f32);
    return;
  }
  // the splits' sums, in split order; split r finishes every S-th run of
  // THREADS outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial is in its shared memory
  for (int e = split * T::THREADS + threadIdx.x; e < E;
       e += S * T::THREADS) {
    const int i = T::idx(e / T::NW, e % T::NW);
    float part[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)   // every read in flight at once
      part[r] = r < S ? cluster.map_shared_rank(red, r)[i] : 0.0f;
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) v += part[r];
    store(y, s, v, m0 + e / T::NW, n0 + e % T::NW, M, N, out_f32);
  }
  cluster.sync();   // no split leaves while another still reads it
}

template <bool TRANS, bool INT4, int MT>
int launch(const void* x, const void* q, const void* s, void* y, int M,
           int N, int K, int out_f32, int n_splits, cudaStream_t stream) {
  using T = Tile<TRANS, INT4, MT>;
  const dim3 grid(n_splits, (M + T::R - 1) / T::R, (N + T::NW - 1) / T::NW);
  return launch_split(wq_gemm_kernel<TRANS, INT4, MT>, grid, T::THREADS,
                      (size_t)T::SMEM, n_splits, stream,
                      static_cast<const __nv_bfloat16*>(x),
                      static_cast<const uint8_t*>(q),
                      static_cast<const float*>(s), y, M, N, K, out_f32);
}

template <bool INT4>
int dispatch(const void* x, const void* q, const void* s, void* y, int M,
             int N, int K, int trans, int out_f32, int n_splits,
             void* stream) {
  if (M <= 0) return 0;
  const int step = trans ? (INT4 ? 128 : 64) : 16;
  if (N <= 0 || K <= 0 || K % step || (!trans && N % 16) || n_splits < 1 ||
      n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!trans)
    return launch<false, INT4, 1>(x, q, s, y, M, N, K, out_f32, n_splits, st);
  if (M <= 16)
    return launch<true, INT4, 1>(x, q, s, y, M, N, K, out_f32, n_splits, st);
  return launch<true, INT4, 2>(x, q, s, y, M, N, K, out_f32, n_splits, st);
}

}  // namespace

// y [M, N] = (x [M, K] bf16 @ dequant(q)) * s [N] float32, q int8 [K, N]
// (trans = 0) or [N, K] (trans = 1); y float32 (out_f32 = 1) or bf16.
// n_splits blocks of one cluster split the contraction (1..8). Returns
// the launch's cudaError_t (0 = launched).
extern "C" int gofr_wq_gemm_i8(const void* x, const void* q, const void* s,
                               void* y, int M, int N, int K, int trans,
                               int out_f32, int n_splits, void* stream) {
  return dispatch<false>(x, q, s, y, M, N, K, trans, out_f32, n_splits,
                         stream);
}

// The same with int4 codes packed two per byte along the last axis:
// uint8 [K, N / 2] (trans = 0) or [N, K / 2] (trans = 1).
extern "C" int gofr_wq_gemm_i4(const void* x, const void* q, const void* s,
                               void* y, int M, int N, int K, int trans,
                               int out_f32, int n_splits, void* stream) {
  return dispatch<true>(x, q, s, y, M, N, K, trans, out_f32, n_splits,
                        stream);
}
