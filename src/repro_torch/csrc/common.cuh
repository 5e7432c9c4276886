// Shared helpers of the port's hand-written Hopper kernels.
//
// Every C entry point takes raw device pointers, element strides and the
// CUDA stream (all passed from Python through ctypes), launches on that
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr float NEG_INF = -1e30f;  // the JAX kernels' masked-score value
constexpr float L_FLOOR = 1e-30f;  // softmax denominator floor

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace repro

REPRO_API const char* repro_error_string(int err);
