// Tensor-core helpers shared by the attention kernels: one warp-wide
// mma.sync m16n8k16 (bf16 A/B, f32 accumulate) and the 32-bit packing
// its fragments use. Fragment layout (PTX ISA, m16n8k16, .bf16), with
// gid = lane / 4 and tig = lane % 4:
//   A (16 x 16, row-major): a[0] = (gid, 2tig..2tig+1), a[1] = (gid+8, ...),
//                           a[2] = (gid, 2tig+8..), a[3] = (gid+8, 2tig+8..)
//   B (16 x 8, col-major):  b0 = (2tig..2tig+1, gid), b1 = (2tig+8.., gid)
//   C (16 x 8):             c[0..1] = (gid, 2tig..2tig+1), c[2..3] = (gid+8, ...)
// So a C fragment of Q K^T re-packs, two n-tiles at a time, into the A
// fragment of P V without leaving registers, and ldmatrix.x4.trans
// reads P V's B fragments from a row-major V tile.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the 16-byte rows of matrix i, and r[i] holds, for lane (gid,
// tig), rows 2tig and 2tig+1 of column gid of matrix i. On a row-major
// [k][n] tile (matrix rows = k) that is the B fragment half b0 or b1 of
// mma_16816.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
