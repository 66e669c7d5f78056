// The warpgroup tensor-core core that the flash prefill and the paged
// chunk/tree kernels share, for bf16 and float16 operands (T): one block
// is one warpgroup (4 warps, 128 threads) that owns a 64-row tile of
// query rows, walks 64-row K/V tiles staged in shared memory, and runs
// both products of a tile on wgmma (Hopper's asynchronous warpgroup MMA,
// sm_90a only):
//   S = Q K^T  wgmma.mma_async m64n64k16, A (Q) and B (K) from shared
//              memory, DP/16 k-steps, f32 accumulate;
//   O += P V   wgmma.mma_async m64n64k16 per 64 output columns, A (P)
//              from registers, B (V) from the row-major V tile read
//              MN-major (the transpose bit), 4 k-steps.
// DP is the staged head dim: the call's D rounded up to a whole swizzle
// atom (64 columns). Columns D .. DP of Q and K are staged as zeros, so S
// is exactly the D-column product; V's columns past D give output
// columns that are never stored.
//
// Shared-memory tiles. A [64 rows][DP] 16-bit tile is stored as DP / 64
// swizzle atoms of [64 rows][64 columns] (8 KiB each, 1024-byte
// aligned): row r of an atom is 128 bytes at r * 128, and its 16-byte
// chunk c sits at chunk c ^ (r & 7) — the 128-byte swizzle wgmma reads.
// The same stores serve a K-major operand (Q and K: rows are M or N, the
// head dim is K) and an MN-major one (V: rows are K, the head dim is
// N), so no tile is ever transposed. Every product reads one atom per
// instruction (N = 64 columns), so the descriptors' leading byte offset
// never spans atoms; both offsets are set to the 1024-byte stride of
// 8-row groups.
//
// Register layouts (PTX ISA, wgmma .m64nNk16 with .f32 accumulators):
// warp w of the warpgroup owns rows 16 w .. 16 w + 15, and with gid =
// lane / 4, tig = lane % 4 its accumulator element d[n][e] is row
// 16 w + gid + 8 (e >> 1), column 8 n + 2 tig + (e & 1) — the layout of
// mma.sync's C fragment, n-tile by n-tile. A register A operand of
// m64nNk16 (16-bit) is, per warp, mma.sync's m16k16 A fragment, so the
// S accumulator re-packs into P V's A operand without leaving registers
// (P rounded to T: 2^-8 relative for bf16, 2^-11 for float16, as JAX's
// kernel rounds P to its input type before P V).
//
// Synchronisation: wgmma reads shared memory through the async proxy,
// so threads that wrote a tile (cp.async or plain stores) fence the
// proxy before the block barrier that precedes the product; a wgmma
// whose register operands (P, or O after its rescale) were written by
// ordinary code follows wgmma.fence; accumulators are pinned with empty
// asm around commit / wait so the compiler moves no access across them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace wgattn {

constexpr int ROWS = 64;       // query rows per block: the wgmma M
constexpr int BK = 64;         // K/V rows per tile
constexpr int NTHREADS = 128;  // one warpgroup
constexpr int STAGES = 2;      // K/V tiles in the ring: double buffered
constexpr int ATOM = 64 * 128; // bytes of one [64][64] 16-bit swizzle atom
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of 16-byte chunk c (8 columns, c < DP / 8) of row r (< 64)
// in a swizzled [64][DP] tile.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * ATOM + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared-memory matrix descriptor of a 128-byte-swizzled operand
// starting at shared address a: start address, leading and stride byte
// offsets (16-byte units), layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
       | static_cast<uint64_t>(1024 >> 4) << 16
       | static_cast<uint64_t>(1024 >> 4) << 32
       | static_cast<uint64_t>(1) << 62;
}

// A 1024-byte aligned pointer at or after p (the swizzle atoms need it;
// the launchers reserve the slack).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (saddr(p) & 1023)) & 1023);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers: no access moves across this point.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

#define WGATTN_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"
#define WGATTN_D32_OPS(d)                                                 \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),             \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),             \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),             \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),             \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),             \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),             \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),             \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

// d (64 x 64, f32) = A (64 x 16, K-major in shared memory) B (16 x 64,
// K-major in shared memory), plus d when acc != 0; A and B of type T.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WGATTN_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WGATTN_D32_OPS(d)
        : "l"(a), "l"(b), "r"(acc));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGATTN_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WGATTN_D32_OPS(d)
        : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, f32) += A (64 x 16, pairs of T in registers) B (16 x 64,
// MN-major in shared memory: the transpose bit).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WGATTN_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WGATTN_D32_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGATTN_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WGATTN_D32_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WGATTN_D32
#undef WGATTN_D32_OPS

// s = Q K^T for the block's 64 rows x the tile's 64 K/V rows: q and k
// are the swizzled [64][DP] tiles; returns with the product complete.
template <typename T, int DP>
__device__ __forceinline__ void qk(float (&s)[8][4], const void* q,
                                   const void* k) {
  const uint64_t dq = desc(saddr(q)), dk = desc(saddr(k));
  pin(s);
  wg_fence();
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    // k-step kc: atom kc / 4, 32 bytes per step inside its rows
    const uint32_t off = (kc >> 2) * (ATOM >> 4) + (kc & 3) * 2;
    wgmma_ss<T>(s, dq + off, dk + off, kc > 0);
  }
  wg_commit();
  wg_wait0();
  pin(s);
}

// o += P V: pa holds P's four 16-column A operands, v is the swizzled
// [64][DP] V tile, o the DP / 64 column blocks of the output.
template <typename T, int DP>
__device__ __forceinline__ void pv(float (&o)[DP / 64][8][4],
                                   uint32_t (&pa)[4][4], const void* v) {
  const uint64_t dv = desc(saddr(v));
#pragma unroll
  for (int h = 0; h < DP / 64; ++h) pin(o[h]);
  pin(pa);
  wg_fence();
#pragma unroll
  for (int h = 0; h < DP / 64; ++h)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)   // 16 K/V rows = 2048 bytes
      wgmma_rs<T>(o[h], pa[kk], dv + (h * ATOM + kk * 2048) / 16);
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int h = 0; h < DP / 64; ++h) pin(o[h]);
  pin(pa);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as one register of two T, each rounded to nearest even
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// One tile's online-softmax update for this thread's two rows (e >> 1),
// in the log2 domain. s holds the raw scores Q K^T; bit 4 n + e of vis
// marks the elements the rows see (FULL: every live row sees the whole
// tile, and vis is not read); lg(col) is column col's multiplier into
// log2 units (scale * log2 e, times the K row scale for an int8 tile),
// pw(col) the weight P V applies to p (1, or the V row scale). Masked
// logits are NEG_INF, and p = exp2(logit - m) is 0 for them exactly: a
// row with nothing visible yet (m == NEG_INF) subtracts 0 instead of m,
// where exp2(0) would be 1. m is the running max, l a per-thread partial
// sum of the unweighted p (the quad shares m, so the quad reduction
// waits for the end of the walk), o is rescaled, and pa receives the
// A operands of P V in T.
template <typename T, bool FULL, int NH, typename Lg, typename Pw>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], uint32_t vis,
                                             Lg lg, Pw pw, float (&m)[2],
                                             float (&l)[2],
                                             float (&o)[NH][8][4],
                                             uint32_t (&pa)[4][4]) {
  const int tig = threadIdx.x & 3;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + tig * 2 + (e & 1);
      const float val = FULL || ((vis >> (4 * n + e)) & 1u) ? s[n][e] * lg(col)
                                                            : NEG_INF;
      s[n][e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
  float alpha[2], mu[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], 1));
    mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], 2));
    const float m_new = fmaxf(m[t], mx[t]);
    alpha[t] = ex2(m[t] - m_new);
    m[t] = m_new;
    mu[t] = m_new == NEG_INF ? 0.f : m_new;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + tig * 2 + (e & 1);
      const float p = ex2(s[n][e] - mu[e >> 1]);
      s[n][e] = p * pw(col);
      rs[e >> 1] += p;
    }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[h][n][0] *= alpha[0]; o[h][n][1] *= alpha[0];
      o[h][n][2] *= alpha[1]; o[h][n][3] *= alpha[1];
    }
  // P V's A operand for K/V rows 16 kk .. 16 kk + 15: S n-tiles 2 kk and
  // 2 kk + 1, each row's column pair packed into one register
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// f(0) .. f(N - 1): the copies (or conversions) of one tile, unrolled
// where UNROLL (up to DP 128: a few offsets a thread, which the compiler
// keeps in registers across the walk), one at a time otherwise (at DP
// 192 / 256 O takes DP / 2 registers a thread, and offsets hoisted out
// of the walk would spill).
template <int N, bool UNROLL, typename F>
__device__ __forceinline__ void for_each(F&& f) {
  if constexpr (UNROLL) {
#pragma unroll
    for (int k = 0; k < N; ++k) f(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < N; ++k) f(k);
  }
}

// The quad's row sums, once after the walk.
__device__ __forceinline__ void reduce_rows(float (&l)[2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    l[t] += __shfl_xor_sync(0xffffffffu, l[t], 1);
    l[t] += __shfl_xor_sync(0xffffffffu, l[t], 2);
  }
}

}  // namespace wgattn
