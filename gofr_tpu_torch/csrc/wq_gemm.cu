// Weight-only quantized GEMM for Hopper (sm_90a): y[M, N] = (x[M, K] @
// dequant(q)^T) * s[N], with int8 codes or int4 codes packed two per
// byte, read once from device memory and widened to bf16 in registers.
//
// Replaces no Pallas kernel. On the TPU the product is XLA's:
// gofr_tpu/ops/quant.py:86 `qmatmul` computes (x @ q.astype(x.dtype)) * s
// and counts on XLA to fuse the upcast into the matmul's operand read,
// so the narrow codes are what crosses HBM. A plain PyTorch
// `x @ q.to(bf16).T * s` writes a bf16 copy of the weight and reads it
// again; this kernel is what keeps the codes narrow on the card.
//
// One layout (ops/quant.py): codes [N, K], output channels by the
// contraction, the contraction contiguous — every layer matrix, an
// untied head and the embedding read as the tied head (x @ E^T). int4
// codes are packed along K: byte c holds element 2c in its low nibble
// and 2c + 1 in its high one, two's complement. Scales s [N] float32,
// x bf16 [M, K] row-major. Output: float32 acc * s (the LM head) or
// bf16 bf16(bf16(acc) * bf16(s)) (the backbone: the plain version's
// product rounded to bf16, then the scale, as JAX's qmatmul with
// preferred_element_type = bf16).
//
// What bounds it on the H100. At M <= 16 (the decode step's 8 rows),
// bytes: each code is used M times, far below the ~295 operations a
// byte that the tensor cores need to become the limit, so the bound is
// the codes over 3.35 TB/s and the design has to keep ~25 KB of codes in
// flight on every SM and the widening off the critical path. At M = 128
// (the tree verify) a product does 256 operations a code byte (int8;
// 512 for int4): the tensor cores and the codes' bytes bound it about
// equally, and the design has to keep x out of the register file and
// the tensor cores at wgmma's rate. What it does:
//   - swap AB: it computes y^T = W x^T on wgmma m64nNk16. A is 64 output
//     channels of the dequantized weight, from registers; B is x^T, and
//     x [M, K] row-major is exactly a K-major B, so x is read from a
//     swizzled shared tile as it lies, with wgmma's N the rows of x
//     rounded up to a tile of 8, 16, 32, 64 or 128 (wider M: more tiles
//     of 128). One kernel covers one row to the verify's 128 and wider;
//   - TMA: per stage of the contraction one bulk tensor copy brings the
//     [64 WG channels][128 bytes] code tile and one each [N-tile][64] x
//     box (both 128-byte swizzled; rows past M or N and k past K come
//     as zeros), completing on the stage's mbarrier. One producer warp
//     keeps a ring of 2 to 6 stages (by shared memory) in flight, the
//     WG consumer warpgroups (64 channels each, sharing the x tile: two
//     for the LM head at 64 rows or more, ops/quant.py wq_groups) hand a
//     stage back on a second mbarrier;
//   - the widening, in registers, with the codes in their natural
//     order: a lane's mma fragment needs k = 2t, 2t + 1, 2t + 8, 2t + 9
//     of a 16-k step, which it reads as 32-bit words (int8) or one
//     8-byte piece (int4) of its row; the swizzle puts the 8 rows a warp
//     reads in 8 different bank groups. int8: code ^ 0x80 placed in the
//     mantissa of 2^23 by one byte permute, one float subtraction, and
//     the bf16 is the top half of that exact float. int4: a nibble or'ed
//     into the mantissa of bf16 128 and 136 subtracted in one bf16x2 fma,
//     two codes a register. No conversion instruction (a quarter rate);
//   - the widening of one group of 8 k-steps overlaps the wgmma of the
//     previous one (two register buffers, one wgmma group in flight);
//   - split-K over a thread-block cluster (ops/quant.py wq_splits: S
//     from the shapes, so that narrow products such as wk, 512 channels,
//     still fill the card): the S blocks' partial tiles are summed
//     through distributed shared memory in split order — deterministic,
//     no atomics, no second launch. The launch neither allocates nor
//     synchronises, so a CUDA graph of the decode step holds it.
// Measured on the H100 (PERF.md, scripts/torch_wq_gemm_bench.py): at
// M = 8 the small products (wq, wk) sit near a 5-8 us floor (launch, the
// first TMA round trip, the cluster merge), the large ones stream at
// 40-75 % of the HBM rate; at M = 128 a stage's x boxes (NT rows of 128
// bytes, read again from L2 for every channel tile), not the tensor
// cores, set the pace, so fewer and wider blocks win there.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

#include "paged_common.cuh"
#include "wgmma_attn.cuh"

namespace cg = cooperative_groups;

namespace {

using wgattn::saddr;

// the ring: as many stages as 160 KB hold, 2 to 6 (deeper rings, up to
// 16 stages, and two code boxes a stage measured no faster on the H100)
constexpr int RING_BYTES = 163840;
constexpr int MAX_STAGES = 6;

// A block: WG consumer warpgroups, 64 output channels each (wgmma's M),
// sharing the x tile of NT rows, and one producer warp.
template <bool INT4, int NT, int WG>
struct Cfg {
  static constexpr int ROWS = 64 * WG;      // output channels a block
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int CODE_BYTES = ROWS * 128;   // a stage's code tile
  static constexpr int RS = ROWS + 4;       // partial-tile row stride
  static constexpr int KS = INT4 ? 256 : 128;     // contraction a stage
  static constexpr int XB = KS / 64;        // 64-wide x boxes a stage
  static constexpr int G = XB / 2;          // groups of 8 k16-steps
  static constexpr int X_BOX = NT * 128;
  static constexpr int STAGE = CODE_BYTES + XB * X_BOX;
  static constexpr int FIT = RING_BYTES / STAGE;
  static constexpr int STAGES =
      FIT < 2 ? 2 : FIT > MAX_STAGES ? MAX_STAGES : FIT;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES;
  static_assert(NT * RS * 4 <= STAGES * STAGE, "partial tile > ring");
};

// ------------------------------------------------ mbarriers and the TMA

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(saddr(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(saddr(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(saddr(b)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(saddr(b)), "r"(parity) : "memory");
}

// One box of a 2-D tensor map at (c0 innermost, c1) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(saddr(bar))
      : "memory");
}

// ---------------------------------------------------------- the widening

// Bytes b, b + 1 of a word of int8 codes as a bf16x2 (sel0 / sel1 =
// 0x7440 | b / b + 1): code ^ 0x80 = code + 128 in the low mantissa byte
// of 2^23, minus 2^23 + 128, exact; the bf16 is the float's top half.
__device__ __forceinline__ uint32_t i8pair(uint32_t w, uint32_t sel0,
                                           uint32_t sel1) {
  w ^= 0x80808080u;
  const float lo =
      __uint_as_float(__byte_perm(w, 0x4B000000u, sel0)) - 8388736.0f;
  const float hi =
      __uint_as_float(__byte_perm(w, 0x4B000000u, sel1)) - 8388736.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// bf16x2 v - 136, exact for v in 128 .. 143
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// The 16 int4 codes of one 16-k step of a row (v: k 0..7 in x, 8..15 in
// y) -> this lane's fragment pairs: lo = k (2t, 2t + 1), hi = k (2t + 8,
// 2t + 9). sel = t | t << 4 | (4 + t) << 8 | (4 + t) << 12 lays out
// [x_t, x_t, y_t, y_t]; a nibble ^ 8 (code + 8) or'ed into bf16 128's
// mantissa is 136 + code.
__device__ __forceinline__ void i4pairs(uint2 v, uint32_t sel, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t r = __byte_perm(v.x, v.y, sel);
  const uint32_t p =    // codes 2t, 2t + 8
      minus136(((r & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u);
  const uint32_t q =    // codes 2t + 1, 2t + 9
      minus136((((r >> 4) & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u);
  lo = __byte_perm(p, q, 0x5410);
  hi = __byte_perm(p, q, 0x7632);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Group grp (8 k16-steps: the whole int8 tile, half grp of the int4
// one) of a stage's code tile into this lane's A fragments: rows r0 =
// 16 warp + g and r0 + 8 (mma's m16k16 A layout per warp: a[s] = {(r0,
// 2t..), (r0 + 8, 2t..), (r0, 2t + 8..), (r0 + 8, 2t + 8..)}). The tile
// is [64 WG][128 bytes], 16-byte chunk c of row r at chunk c ^ (r & 7);
// r & 7 = g for both rows.
template <bool INT4>
__device__ __forceinline__ void dequant(uint32_t (&a)[8][4],
                                        const unsigned char* codes, int grp,
                                        int r0, int g, int t, uint32_t sa,
                                        uint32_t sb) {
  const unsigned char* row0 = codes + r0 * 128;
  const unsigned char* row1 = row0 + 8 * 128;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if constexpr (INT4) {
      // step j is 8 bytes: half j & 1 of chunk j >> 1
      const int j = 8 * grp + s;
      const int off = (((j >> 1) ^ g) << 4) + 8 * (j & 1);
      const uint2 v0 = *reinterpret_cast<const uint2*>(row0 + off);
      const uint2 v1 = *reinterpret_cast<const uint2*>(row1 + off);
      i4pairs(v0, sa, a[s][0], a[s][2]);
      i4pairs(v1, sa, a[s][1], a[s][3]);
    } else {
      // step s is chunk s; k 2t, 2t + 1 lie in word t >> 1, 2t + 8, 2t + 9
      // two words on
      const int off = ((s ^ g) << 4) + 4 * (t >> 1);
      a[s][0] = i8pair(lds32(row0 + off), sa, sb);
      a[s][1] = i8pair(lds32(row1 + off), sa, sb);
      a[s][2] = i8pair(lds32(row0 + off + 8), sa, sb);
      a[s][3] = i8pair(lds32(row1 + off + 8), sa, sb);
    }
  }
}

__device__ __forceinline__ void pin(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[s][e])::"memory");
}

// ------------------------------------------------------------- wgmma RS

// d (64 x NT, f32) += A (64 x 16 bf16, registers) B (16 x NT, K-major in
// shared memory, descriptor b).
template <int NT>
struct Wg;

template <>
struct Wg<8> {
  __device__ static __forceinline__ void mma(float (&d)[1][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wg<16> {
  __device__ static __forceinline__ void mma(float (&d)[2][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wg<32> {
  __device__ static __forceinline__ void mma(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wg<64> {
  __device__ static __forceinline__ void mma(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wg<128> {
  __device__ static __forceinline__ void mma(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ------------------------------------------------------------ the kernel

// One group gi (8 k16-steps) of the consumer warpgroup's walk: widen its
// codes into cur while the previous group's products (on prev) run, wait
// for those, hand their stage back if they closed it, then issue this
// group's 8 products.
template <bool INT4, int NT, int WG>
__device__ __forceinline__ void group(float (&acc)[NT / 8][4],
                                      uint32_t (&cur)[8][4],
                                      uint32_t (&prev)[8][4], int gi,
                                      unsigned char* ring, uint64_t* full,
                                      uint64_t* empty, int r0, int g, int t,
                                      int lane, uint32_t sa, uint32_t sb) {
  using C = Cfg<INT4, NT, WG>;
  const int st = gi / C::G, grp = gi - st * C::G, slot = st % C::STAGES;
  if (grp == 0) mbar_wait(full + slot, (st / C::STAGES) & 1);
  const unsigned char* codes = ring + slot * C::STAGE;
  dequant<INT4>(cur, codes, grp, r0, g, t, sa, sb);
  pin(cur);
  wgattn::wg_wait0();
  wgattn::pin(acc);
  pin(prev);
  if (gi > 0 && grp == 0) {   // group gi - 1 closed stage st - 1
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + (st - 1) % C::STAGES);
  }
  const uint32_t xs = saddr(codes + C::CODE_BYTES);
  wgattn::wg_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    // k16-step j of the stage: x box j / 4, 32 bytes a step inside it
    const int j = 8 * grp + s;
    Wg<NT>::mma(acc, cur[s],
                wgattn::desc(xs + (j >> 2) * C::X_BOX + (j & 3) * 32));
  }
  wgattn::wg_commit();
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

// grid (S splits, M tiles of NT rows, N tiles of 64 WG channels); the S
// splits of a tile are one cluster. tq: codes [N][K bytes (int4: K / 2)]
// in [64 WG][128-byte] boxes; tx: x [M][K] bf16 in [NT][64] boxes.
template <bool INT4, int NT, int WG>
__global__ void __launch_bounds__(Cfg<INT4, NT, WG>::THREADS)
    wq_gemm_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tx,
                   const float* __restrict__ s, void* __restrict__ y, int M,
                   int N, int K, int out_f32) {
  using C = Cfg<INT4, NT, WG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring of stages during the walk, the partial tile after it
  unsigned char* ring = wgattn::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  const int S = gridDim.x, split = blockIdx.x;
  const int m0 = blockIdx.y * NT, n0 = blockIdx.z * C::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // this split's stages of the contraction: [s0, s0 + n)
  const int steps = (K + C::KS - 1) / C::KS;
  const int s0 = (int)((long long)steps * split / S);
  const int n = (int)((long long)steps * (split + 1) / S) - s0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, C::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NT / 8][4];
#pragma unroll
  for (int i = 0; i < NT / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  if (warp == C::CONSUMERS / 32) {
    // the producer: one lane keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      for (int i = 0; i < n; ++i) {
        const int slot = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(empty + slot, (i / C::STAGES - 1) & 1);
        unsigned char* st = ring + slot * C::STAGE;
        mbar_expect(full + slot, C::STAGE);
        tma_load(st, &tq, (s0 + i) * 128, n0, full + slot);
#pragma unroll
        for (int b = 0; b < C::XB; ++b)
          tma_load(st + C::CODE_BYTES + b * C::X_BOX, &tx,
                   (s0 + i) * C::KS + 64 * b, m0, full + slot);
      }
    }
  } else {
    // the consumers: groups in pairs, so that each has its own buffer
    uint32_t sa, sb;
    if constexpr (INT4) {
      sa = t | t << 4 | (4 + t) << 8 | (4 + t) << 12;
      sb = 0;
    } else {
      sa = 0x7440u | (2 * (t & 1));
      sb = sa + 1;
    }
    const int r0 = 16 * warp + g;   // 64 channels a warpgroup
    uint32_t a0[8][4], a1[8][4] = {};
    const int total = n * C::G;
    int gi = 0;
    for (; gi + 1 < total; gi += 2) {
      group<INT4, NT, WG>(acc, a0, a1, gi, ring, full, empty, r0, g, t,
                          lane, sa, sb);
      group<INT4, NT, WG>(acc, a1, a0, gi + 1, ring, full, empty, r0, g, t,
                          lane, sa, sb);
    }
    if (gi < total)
      group<INT4, NT, WG>(acc, a0, a1, gi, ring, full, empty, r0, g, t,
                          lane, sa, sb);
    wgattn::wg_wait0();
    wgattn::pin(acc);
  }
  __syncthreads();   // every stage consumed: the ring's memory becomes red

  // the partial tile, [NT rows of x][64 WG channels]: accumulator
  // element (j, e) is channel 16 warp + g + 8 (e >> 1), row 8 j + 2 t +
  // (e & 1)
  float* red = reinterpret_cast<float*>(ring);
  if (warp < C::CONSUMERS / 32) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * j + 2 * t + (e & 1)) * C::RS + 16 * warp + g +
            8 * (e >> 1)] = acc[j][e];
  }
  __syncthreads();
  constexpr int E = NT * C::ROWS, THREADS = C::THREADS;
  if (S == 1) {
    for (int e = threadIdx.x; e < E; e += THREADS)
      store(y, s, red[(e / C::ROWS) * C::RS + e % C::ROWS],
            m0 + e / C::ROWS, n0 + e % C::ROWS, M, N, out_f32);
    return;
  }
  // the splits' sums, in split order; split r finishes every S-th run of
  // THREADS outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial is in its shared memory
  for (int e = split * THREADS + threadIdx.x; e < E; e += S * THREADS) {
    const int i = (e / C::ROWS) * C::RS + e % C::ROWS;
    float part[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)   // every read in flight at once
      part[r] = r < S ? cluster.map_shared_rank(red, r)[i] : 0.0f;
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) v += part[r];
    store(y, s, v, m0 + e / C::ROWS, n0 + e % C::ROWS, M, N, out_f32);
  }
  cluster.sync();   // no split leaves while another still reads it
}

// ------------------------------------------------------------- the host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, from the driver library the runtime
// has loaded (no link against libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A row-major [rows][cols] tensor of elem-byte values as a TMA map of
// [box_rows][box_cols] boxes, 128-byte swizzled, zeros past its edges.
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
               const void* base, uint64_t cols, uint64_t rows,
               uint32_t box_cols, uint32_t box_rows,
               CUtensorMapL2promotion l2) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult rc = fn(map, type, 2, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, l2,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool INT4, int NT, int WG>
int launch(const void* x, const void* q, const void* s, void* y, int M,
           int N, int K, int out_f32, int n_splits, cudaStream_t stream) {
  using C = Cfg<INT4, NT, WG>;
  CUtensorMap tq, tx;
  int rc = tensor_map(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q,
                      INT4 ? K / 2 : K, N, 128, C::ROWS,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc != 0) return rc;
  rc = tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, 64, NT,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (rc != 0) return rc;
  const dim3 grid(n_splits, (M + NT - 1) / NT, (N + C::ROWS - 1) / C::ROWS);
  return launch_split(wq_gemm_kernel<INT4, NT, WG>, grid, C::THREADS,
                      (size_t)C::SMEM, n_splits, stream, tq, tx,
                      static_cast<const float*>(s), y, M, N, K, out_f32);
}

template <bool INT4, int WG>
int by_rows(const void* x, const void* q, const void* s, void* y, int M,
            int N, int K, int out_f32, int n_splits, cudaStream_t st) {
  // the x tile: M rounded up to 8, 16, 32 or 64 rows, else tiles of 128
  auto go = [&](auto nt) {
    return launch<INT4, decltype(nt)::value, WG>(x, q, s, y, M, N, K,
                                                 out_f32, n_splits, st);
  };
  if (M <= 8) return go(std::integral_constant<int, 8>());
  if (M <= 16) return go(std::integral_constant<int, 16>());
  if (M <= 32) return go(std::integral_constant<int, 32>());
  if (M <= 64) return go(std::integral_constant<int, 64>());
  return go(std::integral_constant<int, 128>());
}

template <bool INT4>
int dispatch(const void* x, const void* q, const void* s, void* y, int M,
             int N, int K, int out_f32, int n_splits, int groups,
             void* stream) {
  if (M <= 0) return 0;
  if (N <= 0 || K <= 0 || K % (INT4 ? 32 : 16) || (groups != 1 &&
      groups != 2) || (N + 64 * groups - 1) / (64 * groups) > 65535 ||
      (M + 127) / 128 > 65535 || n_splits < 1 || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return groups == 1
             ? by_rows<INT4, 1>(x, q, s, y, M, N, K, out_f32, n_splits, st)
             : by_rows<INT4, 2>(x, q, s, y, M, N, K, out_f32, n_splits, st);
}

}  // namespace

// y [M, N] = (x [M, K] bf16 @ dequant(q)^T) * s [N] float32, q int8
// [N, K] (K a multiple of 16); y float32 (out_f32 = 1) or bf16. A block
// holds 64 x groups output channels (groups 1 or 2 consumer
// warpgroups); n_splits blocks of one cluster split the contraction
// (1..8). Returns the launch's cudaError_t (0 = launched).
extern "C" int gofr_wq_gemm_i8(const void* x, const void* q, const void* s,
                               void* y, int M, int N, int K, int out_f32,
                               int n_splits, int groups, void* stream) {
  return dispatch<false>(x, q, s, y, M, N, K, out_f32, n_splits, groups,
                         stream);
}

// The same with int4 codes packed two per byte along K: uint8 [N, K / 2]
// (K a multiple of 32).
extern "C" int gofr_wq_gemm_i4(const void* x, const void* q, const void* s,
                               void* y, int M, int N, int K, int out_f32,
                               int n_splits, int groups, void* stream) {
  return dispatch<true>(x, q, s, y, M, N, K, out_f32, n_splits, groups,
                        stream);
}
