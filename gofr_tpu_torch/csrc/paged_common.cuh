// Helpers the paged decode and chunk/tree kernels share (the flash
// kernel takes its cp.async and launch helpers too): an int8 code's
// value, asynchronous global -> shared copies (cp.async) and the widest
// copy a row takes, the sub-groups of a wide GQA group, and the launch
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

#include <initializer_list>

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

// `vec` bytes (16, 8 or 4, the same across the warp), as above.
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src,
                                             int vec, int src_bytes) {
  if (vec == 16)
    cp_async16(dst, src, src_bytes);
  else if (vec == 8)
    cp_async8(dst, src, src_bytes);
  else
    cp_async4(dst, src, src_bytes);
}

// The widest copy, 16, 8 or 4 bytes, that divides a row of `row_bytes`
// and the address of every pointer given (0: not even 4 does). A row
// whose bytes are not a multiple of 16 (head dim 100 in float16: 200
// bytes) is staged in 8- or 4-byte copies, so the card reads only the
// row's own bytes.
inline int copy_width(int row_bytes, std::initializer_list<const void*> ptrs) {
  for (int vec = 16; vec >= 4; vec /= 2) {
    bool ok = row_bytes % vec == 0;
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % vec == 0;
    if (ok) return vec;
  }
  return 0;
}

// A GQA group of more query heads than a block holds (`cap`) is cut into
// `n` sub-groups of the same KV head, `size` = ceil(group / n) heads each
// (the last one fewer where n does not divide the group), one block each;
// a group of at most `cap` heads is one sub-group.
struct SubGroups {
  int n, size;
};
__host__ __device__ inline SubGroups sub_groups(int group, int cap) {
  if (group <= cap) return {1, group};
  const int n = (group + cap - 1) / cap;
  return {n, (group + n - 1) / n};
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
