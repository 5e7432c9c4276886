// Packed ternary matmul (TLMM) for Hopper.
//
// Replaces: src/repro/kernels/tlmm/kernel.py::tlmm_kernel (the pallas_call in
// tlmm_pallas).  (m, n) int8 activations x (rows, k) uint8 base-3 codes ->
// (m, k) int32, bit-exact.
//
// Bound on the card: at the serving shapes (m <= 128 activation rows against
// 1536x1536 .. 4096x1536 weights) the int8 work is under a microsecond at
// the tensor-core rate, and the weight stream is the packed codes (1.6
// bits/weight), so the kernel is bound by launch latency and by how fast it
// turns code bytes into int8 operands.
//
// Design: one block owns a BM x BK output tile and walks the reduction in
// steps of R code rows (R*G values).  Each step stages the activation slab
// and the *decoded* weight slab in shared memory: every code byte is read
// from device memory once per block and unpacked there (digit = c % 3 - 1),
// so device traffic stays at the packed size.  Both slabs are stored
// reduction-contiguous as int32 words of four int8 values, and each thread
// accumulates a 4x4 micro-tile with __dp4a (int8 x int8 -> int32).  Rows
// past m, columns past k and reduction indices past L read as zero (codes
// past `rows` as the all-zero-weight code), so the wrapper never pads.
#include "common.cuh"

namespace {

constexpr int BM = 64;       // activation rows per block
constexpr int BK = 64;       // output columns per block
constexpr int R = 16;        // code rows per reduction step: R*G % 4 == 0
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <int G>
__global__ void __launch_bounds__(THREADS)
tlmm_kernel(const int8_t* __restrict__ a, int64_t lda,
            const uint8_t* __restrict__ codes, int64_t ldc,
            int32_t* __restrict__ out, int m, int k, int rows, int L) {
  constexpr int RG = R * G;        // reduction values per step
  constexpr int W = RG / 4;        // int32 words per staged slab row
  constexpr int P = W | 1;         // odd pitch: column reads hit 16 banks
  constexpr int ZERO_CODE = ((G == 1 ? 3 : G == 2 ? 9 : G == 3 ? 27
                              : G == 4 ? 81 : 243) - 1) / 2;  // all digits 1
  __shared__ int32_t a_s[BM][P];
  __shared__ int32_t w_s[BK][P];
  int8_t* a_b = reinterpret_cast<int8_t*>(&a_s[0][0]);
  int8_t* w_b = reinterpret_cast<int8_t*>(&w_s[0][0]);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BK;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int n_steps = (L + RG - 1) / RG;
  for (int s = 0; s < n_steps; ++s) {
    const int r_base = s * RG;
    const int c_base = s * R;
    for (int idx = tid; idx < BM * RG; idx += THREADS) {
      const int i = idx / RG, r = idx % RG;
      const int gr = row0 + i, gk = r_base + r;
      a_b[i * P * 4 + r] =
          (gr < m && gk < L) ? a[static_cast<int64_t>(gr) * lda + gk] : 0;
    }
    for (int idx = tid; idx < R * BK; idx += THREADS) {
      const int cr = idx / BK, j = idx % BK;
      const int grow = c_base + cr, gcol = col0 + j;
      int c = (grow < rows && gcol < k)
                  ? codes[static_cast<int64_t>(grow) * ldc + gcol]
                  : ZERO_CODE;
#pragma unroll
      for (int d = 0; d < G; ++d) {
        w_b[j * P * 4 + cr * G + d] = static_cast<int8_t>(c % 3 - 1);
        c /= 3;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < W; ++kk) {
      int av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w_s[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < k) out[static_cast<int64_t>(gr) * k + gc] = acc[i][j];
    }
  }
}

template <int G>
void launch(const int8_t* a, int64_t lda, const uint8_t* codes, int64_t ldc,
            int32_t* out, int m, int k, int rows, int L, cudaStream_t stream) {
  dim3 grid((k + BK - 1) / BK, (m + BM - 1) / BM);
  tlmm_kernel<G><<<grid, THREADS, 0, stream>>>(a, lda, codes, ldc, out, m, k,
                                               rows, L);
}

}  // namespace

// a: (m, >= L) int8, row stride lda; codes: (rows, k) uint8, row stride ldc;
// out: (m, k) int32 contiguous.  Sums over reduction indices [0, L),
// L <= rows * g.
REPRO_API int tlmm_launch(const void* a, int64_t lda, const void* codes,
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
