// Helpers the paged decode and chunk/tree kernels share (the flash
// kernel takes its cp.async and launch helpers too): an int8 code's
// value, asynchronous global -> shared copies (cp.async), and the launch
// of a split-KV grid whose splits of one work item form a thread-block
// cluster.
//
// cp.async: a thread issues a copy and goes on; commit_group closes the
// copies issued so far into a group, wait_group<N> waits until at most N
// groups are still in flight. A source size below the copy size fills
// the rest of the destination with zeros (0: nothing is read), which is
// how a position past the walk limit gets codes, values and scales of 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the portable thread-block cluster size: the most splits a walk takes
constexpr int MAX_SPLITS = 8;

// Code e (0..15) of a 16-byte load of int8 codes, as a float (exact).
__device__ __forceinline__ float code(const uint4& w, int e) {
  const uint32_t word = e < 4 ? w.x : e < 8 ? w.y : e < 12 ? w.z : w.w;
  return static_cast<float>(static_cast<int8_t>(word >> (8 * (e & 3))));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, L2 only (the pages are streamed once per block)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 8 bytes
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes (a row scale)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Launch `kernel` on `grid` x `threads` with `smem` dynamic shared bytes.
// With n_splits > 1 the grid's x dimension holds the splits of each work
// item next to each other, and each run of n_splits blocks along x is
// one thread-block cluster (n_splits <= MAX_SPLITS),
// so the splits can merge their partial results through distributed
// shared memory. Returns the cudaError_t of the attribute call or the
// launch (0 = launched): a refused launch is reported, never retried.
template <typename... KArgs, typename... Args>
int launch_split(void (*kernel)(KArgs...), dim3 grid, int threads,
                 size_t smem, int n_splits, cudaStream_t stream,
                 Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = n_splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
