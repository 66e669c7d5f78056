// The activation types the C entries take, by the code each reads as its
// `dtype` argument, and their exact conversions to float32 and back
// (round to nearest even), shared by the attention kernel of every
// shape (attn_simt.cuh) and the K/V writers (kv_write.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace act {

enum DType { BF16 = 0, F16 = 1, F32 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace act
