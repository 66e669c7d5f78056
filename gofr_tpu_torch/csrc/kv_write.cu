// KV row write for Hopper (sm_90a): one layer's new K and V rows into
// the head-major page pool, bf16 or int8 codes with a float32 scale per
// row.
//
// Replaces no Pallas kernel. On the TPU the write is XLA's scatter,
// fused into the jitted decode step: gofr_tpu/ops/paged_kv.py
// `pool_write`, `pool.at[li, :, pids, offs].set(rows, mode="drop")`,
// with `quantize_rows` in front of it for the int8 pool. It computes the
// same function: row n (K and V, each [Hkv, hd] bf16) lands at page
// pids[n], offset offs[n] of every KV head of the layer [Hkv, Np, pg,
// hd]; a row whose page id is outside [0, Np) (or whose offset is
// outside [0, pg)) is dropped, here on the card, so the caller needs no
// host sync to select the rows in range (what the eager PyTorch version
// does with `nonzero`, and what a CUDA graph cannot hold). For the int8
// pool each row is quantized on the way: scale = max(amax, 1e-8) / 127
// with an IEEE division (__fdiv_rn), codes rint(x / scale) (round half
// to even, IEEE division) clipped to +-127 -- bit for bit the codes and
// scales of ops/paged_kv.py:quantize_rows, and so of the JAX package's.
//
// What bounds it on the H100: bytes, and at decode sizes the launch.
// A decode step writes B x Hkv x hd x 2 values per layer (8 KiB at B =
// 8 for Llama-3.2-1B): far below a microsecond of HBM time, so the
// design only keeps the write to ONE launch per layer for K and V
// together, where the eager version took about ten launches per layer
// for a bf16 pool and about thirty for an int8 one (the index selects
// and puts, and the quantize's abs, amax, clamp, divide, round, clip
// and cast, for K and for V) plus a host sync per step. One block per
// (row, KV head): warp 0 writes the K row, warp 1 the V row; for int8
// the warp reduces the row's amax with shuffles and every lane writes
// its codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool QUANT>
__global__ void kv_write_kernel(const __nv_bfloat16* __restrict__ k_rows,
                                const __nv_bfloat16* __restrict__ v_rows,
                                const int* __restrict__ pids,
                                const int* __restrict__ offs, void* k_dst,
                                void* v_dst, float* k_scales,
                                float* v_scales, int Hkv, int n_pages,
                                int page, int D) {
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* src = warp == 0 ? k_rows : v_rows;
  if (src == nullptr) return;  // a K-only write
  const int pid = pids[n];
  const int off = offs[n];
  if (pid < 0 || pid >= n_pages || off < 0 || off >= page) return;
  const __nv_bfloat16* row = src + ((size_t)n * Hkv + h) * D;
  const size_t dst_row = ((size_t)h * n_pages + pid) * page + off;
  void* dst = warp == 0 ? k_dst : v_dst;
  if constexpr (!QUANT) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dst) + dst_row * D;
    for (int i = lane; i < D; i += 32) out[i] = row[i];
  } else {
    float amax = 0.0f;
    for (int i = lane; i < D; i += 32)
      amax = fmaxf(amax, fabsf(__bfloat162float(row[i])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
    int8_t* out = static_cast<int8_t*>(dst) + dst_row * D;
    for (int i = lane; i < D; i += 32) {
      const float c = rintf(__fdiv_rn(__bfloat162float(row[i]), scale));
      out[i] = static_cast<int8_t>(fminf(fmaxf(c, -127.0f), 127.0f));
    }
    if (lane == 0) (warp == 0 ? k_scales : v_scales)[dst_row] = scale;
  }
}

template <bool QUANT>
int launch(const void* k_rows, const void* v_rows, const int* pids,
           const int* offs, void* k_dst, void* v_dst, float* k_scales,
           float* v_scales, int N, int Hkv, int n_pages, int page, int D,
           void* stream) {
  if (N <= 0) return 0;
  kv_write_kernel<QUANT><<<dim3(N, Hkv), 64, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(k_rows),
      static_cast<const __nv_bfloat16*>(v_rows), pids, offs, k_dst, v_dst,
      k_scales, v_scales, Hkv, n_pages, page, D);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer's K and V rows, each bf16 [N, Hkv, D] (v_rows may be null:
// K only), into bf16 pools [Hkv, n_pages, page, D] at (pids[n],
// offs[n]), int32 [N]. Returns the launch's cudaError_t (0 = launched).
extern "C" int gofr_kv_write(const void* k_rows, const void* v_rows,
                             const int* pids, const int* offs, void* k_pool,
                             void* v_pool, int N, int Hkv, int n_pages,
                             int page, int D, void* stream) {
  return launch<false>(k_rows, v_rows, pids, offs, k_pool, v_pool, nullptr,
                       nullptr, N, Hkv, n_pages, page, D, stream);
}

// The same into an int8 pool: codes int8 [Hkv, n_pages, page, D], scales
// float32 [Hkv, n_pages, page, 1], quantized on the way.
extern "C" int gofr_kv_write_i8(const void* k_rows, const void* v_rows,
                                const int* pids, const int* offs,
                                void* k_codes, void* v_codes, float* k_scales,
                                float* v_scales, int N, int Hkv, int n_pages,
                                int page, int D, void* stream) {
  return launch<true>(k_rows, v_rows, pids, offs, k_codes, v_codes, k_scales,
                      v_scales, N, Hkv, n_pages, page, D, stream);
}
