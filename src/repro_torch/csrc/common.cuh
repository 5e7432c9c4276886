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

#include <initializer_list>
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

// Asynchronous copies from global into shared memory (cp.async): 16 bytes
// (both addresses on 16 bytes, cached in L2 only) or 4; commit closes a
// group of this thread's copies, wait<N> waits until at most N of its
// groups are in flight and makes the landed copies visible to it.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One K or V row (head_dim values) and, for int8 rows, its scale rounded
// to bf16 (an int8 value v then reads as f32(bf16(f32(v) * scale)), the JAX
// paged int8 kernel's dequantization and a bf16 dequantized copy's value).
template <typename KV>
struct Row {
  const KV* p;
  float sc;
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
  using value_type = KV;
  const KV* p;
  int64_t sb, sh, ss;
  __device__ __forceinline__ ContigRows<KV> rows(int b, int kvh) const {
    return {p + b * sb + kvh * sh, ss};
  }
};

template <typename KV>
struct PagedKV {      // (P, ps, kv_h, d) pool, (P, ps, kv_h) scales, (b, n) table
  using value_type = KV;
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

// Host side: whether an operand can be copied 16 bytes at a time (cp.async):
// its base pointer and every byte stride a multiple of 16.  A null pointer
// (an absent operand) passes.
inline bool aligned16(const void* p, std::initializer_list<int64_t> byte_strides) {
  if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int64_t s : byte_strides)
    if (s % 16 != 0) return false;
  return true;
}

template <typename KV>
bool aligned16(const ContigKV<KV>& x) {
  return aligned16(x.p, {x.sb * int64_t(sizeof(KV)), x.sh * int64_t(sizeof(KV)),
                         x.ss * int64_t(sizeof(KV))});
}

template <typename KV>
bool aligned16(const PagedKV<KV>& x) {
  return aligned16(x.p, {x.sp * int64_t(sizeof(KV)), x.sr * int64_t(sizeof(KV)),
                         x.sh * int64_t(sizeof(KV))});
}

}  // namespace repro

REPRO_API const char* repro_error_string(int err);
REPRO_API int repro_empty_launch(void* stream);
