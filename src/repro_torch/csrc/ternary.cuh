// Helpers of the two ternary matmul kernels (tlmm.cu, tlmm_lut.cu): the
// base-3 code's digits and wide reads of code and activation bytes.
#pragma once

#include "common.cuh"

namespace repro {

__host__ __device__ constexpr int pow3(int g) {
  return g == 0 ? 1 : 3 * pow3(g - 1);
}

// The weights of code c of a group of G (G <= 5) as G int8 values in
// {-1, 0, 1}, little-endian: .x holds digits 0-3, the low byte of .y digit 4
// (0 past G).  One entry per code, NC = 3^G of them, in shared memory.
template <int G>
__device__ __forceinline__ uint2 code_weights(int c) {
  uint32_t x = 0, y = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const uint32_t w = static_cast<uint8_t>(static_cast<int8_t>(c % 3 - 1));
    if (j < 4) x |= w << (8 * j);
    else y = w;
    c /= 3;
  }
  return {x, y};
}

// The weights of a code through two small tables in shared memory: lo[c % 9]
// holds digits 0-1 (two bytes), hi[c / 9] digits 2 .. G-1, so that
// operator() gives code_weights<G>(c) as one 64-bit value.  The 9 and
// 3^(G-2) <= 27 words lie in distinct banks: a warp's reads of either table
// never conflict, where reads of one 3^G-entry table by random codes do.
// Codes past the table are clamped into it.
template <int G>
struct SplitWeights {
  static constexpr int NLO = pow3(G < 2 ? G : 2);
  static constexpr int NHI = pow3(G < 2 ? 0 : G - 2);
  uint32_t lo[NLO], hi[NHI];

  __device__ void init(int tid, int nthreads) {
    for (int i = tid; i < NLO + NHI; i += nthreads) {
      const bool is_lo = i < NLO;
      const uint2 w = code_weights<(G < 2 ? G : 2)>(is_lo ? i : 0);
      const uint2 h = code_weights<(G < 2 ? 0 : G - 2)>(is_lo ? 0 : i - NLO);
      if (is_lo) lo[i] = w.x;
      else hi[i - NLO] = h.x;
    }
  }
  __device__ __forceinline__ uint64_t operator()(int c) const {
    c = min(c, pow3(G) - 1);
    return lo[c % 9] | (static_cast<uint64_t>(hi[c / 9]) << 16);
  }
};

// Sign-extended int8 of the low byte.
__device__ __forceinline__ int sx8(uint32_t v) {
  return static_cast<int>(static_cast<int8_t>(v & 0xff));
}

// The code bytes of columns col .. col + 3 of one code row, one 32-bit
// load when `vec` (4-byte aligned row and columns) and all four lie before
// k; bytes past k read as `pad`.
__device__ __forceinline__ uint32_t load_codes4(const uint8_t* row, int col,
                                                int k, bool vec,
                                                uint32_t pad) {
  if (vec && col + 3 < k)
    return __ldg(reinterpret_cast<const uint32_t*>(row + col));
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w |= (col + q < k ? static_cast<uint32_t>(__ldg(row + col + q)) : pad)
         << (8 * q);
  return w;
}

// The G activations of one group (reduction indices [i0, i0 + G)) of one
// row as int8 packed like code_weights: .x values 0-3, .y value 4
// sign-extended.  Indices at or past L, and rows past m (row == nullptr),
// read as zero.
template <int G>
__device__ __forceinline__ int2 group_acts(const int8_t* row, int i0, int L) {
  uint32_t x = 0;
  int y = 0;
  if (row != nullptr) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int v = i0 + j < L ? row[i0 + j] : 0;
      if (j < 4) x |= static_cast<uint32_t>(v & 0xff) << (8 * j);
      else y = v;
    }
  }
  return {static_cast<int>(x), y};
}

// Sum over the group of activation x weight: one __dp4a and one multiply-add.
__device__ __forceinline__ int group_dot(int2 act, uint2 wt, int acc) {
  return __dp4a(act.x, static_cast<int>(wt.x), acc + act.y * sx8(wt.y));
}

}  // namespace repro
