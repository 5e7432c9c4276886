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

#include <type_traits>

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

// Block-wide sum (MAX false) or maximum (MAX true) of one float per thread
// of a block of WARPS warps, returned to every thread; red holds WARPS + 1
// floats of shared memory.  Maxima are taken of absolute values, so 0 pads
// the missing lanes of either.
template <int WARPS, bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : 0.0f;
    v = MAX ? warp_max(v) : warp_sum(v);
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  const float out = red[WARPS];
  __syncthreads();   // red is free again for the next reduction
  return out;
}

// f32 or bf16 K/V values widen to f32; an int8 value is dequantized as the
// JAX paged int8 decode kernel does it, f32(bf16(f32(int8) * scale)) with
// the scale already rounded to bf16 — the value a bf16 dequantized copy of
// the cache holds.
__device__ __forceinline__ float kv_value(float x, float) { return x; }
__device__ __forceinline__ float kv_value(__nv_bfloat16 x, float) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float kv_value(int8_t x, float sc) {
  return __bfloat162float(__float2bfloat16(static_cast<float>(x) * sc));
}

// One K or V row (head_dim values) and, for int8 rows, its scale.
template <typename KV>
struct Row {
  const KV* p;
  float sc;
  __device__ __forceinline__ float operator[](int i) const {
    return kv_value(p[i], sc);
  }
};

// Where key j of one (slot, KV head) lies.  The attention kernels walk
// logical key positions in the same tiles and order whatever the storage,
// and ask one of these for each key's row, so a paged cache gives the same
// numbers as a contiguous one holding the same rows.
template <typename KV>
struct ContigRows {   // row j at p + j * s
  const KV* p;
  int64_t s;
  __device__ __forceinline__ Row<KV> operator()(int j) const {
    return {p + j * s, 1.f};
  }
};

template <typename KV>
struct PagedRows {    // row j in page bt[j / ps] at slot j % ps
  const KV* p;        // the pool at this head (page 0, slot 0)
  int64_t page_s, row_s;
  const float* sc;    // int8 pools: the scale plane at this head
  int64_t sc_page_s, sc_row_s;
  const int* bt;      // this slot's block-table row
  int ps;
  __device__ __forceinline__ Row<KV> operator()(int j) const {
    const int64_t pg = bt[j / ps], r = j % ps;
    float s = 1.f;
    if constexpr (std::is_same_v<KV, int8_t>)
      s = __bfloat162float(__float2bfloat16(sc[pg * sc_page_s + r * sc_row_s]));
    return {p + pg * page_s + r * row_s, s};
  }
};

// A whole K or V operand: rows(b, kvh) gives one (slot, KV head)'s rows.
template <typename KV>
struct ContigKV {     // (b, kv_h, S, d) through element strides
  const KV* p;
  int64_t sb, sh, ss;
  __device__ __forceinline__ ContigRows<KV> rows(int b, int kvh) const {
    return {p + b * sb + kvh * sh, ss};
  }
};

template <typename KV>
struct PagedKV {      // (P, ps, kv_h, d) pool, (P, ps, kv_h) scales, (b, n) table
  const KV* p;
  int64_t sp, sr, sh;
  const float* sc;
  int64_t ssp, ssr, ssh;
  const int* bt;
  int64_t bt_s;
  int ps;
  __device__ __forceinline__ PagedRows<KV> rows(int b, int kvh) const {
    return {p + kvh * sh, sp, sr, sc != nullptr ? sc + kvh * ssh : nullptr,
            ssp, ssr, bt + b * bt_s, ps};
  }
};

}  // namespace repro

REPRO_API const char* repro_error_string(int err);
