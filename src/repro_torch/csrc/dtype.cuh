// f32 <-> storage-type conversions shared by the port's kernels.  Every
// kernel loads float32 or bfloat16 inputs, computes in f32 and rounds the
// output back to the input's type (round to nearest even).
#pragma once

#include <cuda_bf16.h>

namespace capsim {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);              // round to nearest even
}

}  // namespace capsim
