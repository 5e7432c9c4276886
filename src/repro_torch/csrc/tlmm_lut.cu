// Table-lookup ternary matmul (TLMM Method 3, full table) for Hopper.
//
// Replaces: src/repro/kernels/tlmm_lut/kernel.py::tlmm_lut_kernel (the
// pallas_call in tlmm_lut_pallas).  (m, n) int8 activations x (rows, k)
// uint8 base-3 codes -> (m, k) int32, bit-exact (integer sums).
//
// Bound on the card: the bytes are tlmm's (the packed codes, the
// activations, the int32 output: a few microseconds at the serving shapes)
// and the arithmetic is integer adds, so what bounds it is shared memory:
// every output is a sum of one table read per group, and a warp's 32 reads
// of one table land on banks chosen by the codes (random bank conflicts),
// plus the writes that build the tables.  There is no tensor-core form of
// a lookup; this is the design the paper's Table 4 measures against tlmm.
//
// Design: one block owns BM activation rows x BK output columns and walks
// the groups in steps of GS.  Each step
//   1. builds the 3^G-entry table of each (row, group) of the step in shared
//      memory, one warp per table, by the digit recursion
//      T[c + d 3^j] = T[c] + (d - 1) a_j  (3^G adds a table); entries are
//      bounded by G * 128, so they are int16;
//   2. stages the step's code bytes (coalesced along k) in shared memory;
//   3. lets each thread, owning one output column, read its code per group
//      once and add T[row][group][code] into BM int32 accumulators.
// Blocks also split the group steps (grid.z) when the (rows, columns) grid
// alone would leave SMs idle (m = 4 at decode); the partial sums meet in the
// zeroed output with integer atomics, exact in any order.  Rows past m,
// columns past k and reduction indices past L read as zero (the last group's
// missing activations as zero terms), so the wrapper never pads.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int BM = 4;          // activation rows per block
constexpr int THREADS = 256;   // one output column per thread
constexpr int BK = THREADS;    // output columns per block
constexpr int WARPS = THREADS / 32;

__host__ __device__ constexpr int pow3(int g) {
  return g == 0 ? 1 : 3 * pow3(g - 1);
}
// groups per step: tables of BM x GS groups stay near 31 KB of int16
__host__ __device__ constexpr int group_step(int g) {
  return g >= 5 ? 16 : g == 4 ? 32 : 64;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
tlmm_lut_kernel(const int8_t* __restrict__ a, int64_t lda,
                const uint8_t* __restrict__ codes, int64_t ldc,
                int32_t* __restrict__ out, int m, int k, int rows, int L,
                int steps_per_split) {
  constexpr int NC = pow3(G);
  constexpr int TP = NC + (NC & 1);   // even table pitch (int16 pairs)
  constexpr int GS = group_step(G);
  __shared__ int16_t t_s[BM * GS * TP];
  __shared__ uint8_t c_s[GS][BK];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BK;
  const int col = col0 + tid;
  const int n_groups = (L + G - 1) / G;
  const int n_steps = (n_groups + GS - 1) / GS;
  const int s_lo = blockIdx.z * steps_per_split;
  const int s_hi = min(n_steps, s_lo + steps_per_split);

  int acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0;

  for (int s = s_lo; s < s_hi; ++s) {
    const int g0 = s * GS;
    const int gs = min(GS, n_groups - g0);
    // 1. tables: one warp per (row, group)
    for (int t = warp; t < BM * gs; t += WARPS) {
      const int r = t / gs, grp = t % gs;
      const int row = row0 + r, gg = g0 + grp;
      int av = 0;
      if (lane < G && row < m && gg * G + lane < L)
        av = a[static_cast<int64_t>(row) * lda + gg * G + lane];
      int16_t* T = t_s + (r * GS + grp) * TP;
      if (lane == 0) T[0] = 0;   // the empty sum
      __syncwarp();
      int span = 1;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int aj = __shfl_sync(0xffffffffu, av, j);
        // each lane reads only its own c < span and writes c, c + span,
        // c + 2 span: no entry is read and written by two lanes
        for (int c = lane; c < span; c += 32) {
          const int v = T[c];
          T[c] = static_cast<int16_t>(v - aj);
          T[c + span] = static_cast<int16_t>(v);
          T[c + 2 * span] = static_cast<int16_t>(v + aj);
        }
        __syncwarp();
        span *= 3;
      }
    }
    // 2. the step's codes; a code past the table (never made by packing)
    // is clamped into it so that no read leaves shared memory
    for (int idx = tid; idx < gs * BK; idx += THREADS) {
      const int grp = idx / BK, j = idx % BK;
      const int gg = g0 + grp, gc = col0 + j;
      int c = (gg < rows && gc < k)
                  ? codes[static_cast<int64_t>(gg) * ldc + gc]
                  : (NC - 1) / 2;   // all digits 1: the zero-weight code
      c_s[grp][j] = static_cast<uint8_t>(min(c, NC - 1));
    }
    __syncthreads();
    // 3. lookups
    for (int grp = 0; grp < gs; ++grp) {
      const int c = c_s[grp][tid];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += t_s[(r * GS + grp) * TP + c];
    }
    __syncthreads();
  }
  if (col >= k) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = row0 + r;
    if (row < m) atomicAdd(out + static_cast<int64_t>(row) * k + col, acc[r]);
  }
}

template <int G>
void launch(const int8_t* a, int64_t lda, const uint8_t* codes, int64_t ldc,
            int32_t* out, int m, int k, int rows, int L, cudaStream_t stream) {
  constexpr int GS = group_step(G);
  const int n_steps = ((L + G - 1) / G + GS - 1) / GS;
  if (n_steps == 0) return;   // empty reduction: the zeroed output stands
  dim3 grid((k + BK - 1) / BK, (m + BM - 1) / BM, 1);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // split the group steps until some two blocks per SM are in flight
  const int tiles = static_cast<int>(grid.x * grid.y);
  const int split =
      std::max(1, std::min(n_steps, (2 * sms + tiles - 1) / tiles));
  const int per = (n_steps + split - 1) / split;
  grid.z = (n_steps + per - 1) / per;
  tlmm_lut_kernel<G><<<grid, THREADS, 0, stream>>>(a, lda, codes, ldc, out, m,
                                                   k, rows, L, per);
}

}  // namespace

// a: (m, >= L) int8, row stride lda; codes: (rows, k) uint8, row stride ldc;
// out: (m, k) int32 contiguous and ZEROED by the caller (blocks add into it).
// Sums over reduction indices [0, L), L <= rows * g.
REPRO_API int tlmm_lut_launch(const void* a, int64_t lda, const void* codes,
                              int64_t ldc, void* out, int m, int k, int rows,
                              int L, int g, void* stream) {
  auto A = static_cast<const int8_t*>(a);
  auto C = static_cast<const uint8_t*>(codes);
  auto O = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: launch<1>(A, lda, C, ldc, O, m, k, rows, L, st); break;
    case 2: launch<2>(A, lda, C, ldc, O, m, k, rows, L, st); break;
    case 3: launch<3>(A, lda, C, ldc, O, m, k, rows, L, st); break;
    case 4: launch<4>(A, lda, C, ldc, O, m, k, rows, L, st); break;
    case 5: launch<5>(A, lda, C, ldc, O, m, k, rows, L, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
