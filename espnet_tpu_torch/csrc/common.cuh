// Shared helpers of the port's CUDA kernels.
//
// Every kernel source exposes a plain C entry point (no PyTorch headers), so
// one `nvcc -shared` call builds all of them in seconds and Python binds them
// with ctypes (espnet_tpu_torch/ops/cuda_build.py). Each entry point launches
// on the stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace espnet_port {

// Element types, as the Python wrappers encode them.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Entry-point return code for an argument the kernels do not take (the
// wrappers check first, so this only guards a direct C caller).
constexpr int kUnsupported = -1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened again: reproduces a `.astype(T)` of the
// reference between two float32 steps.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Max and sum over the 16 lanes of a half-warp (lanes 0-15 and 16-31 reduce
// separately: every xor offset is below 16).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace espnet_port
