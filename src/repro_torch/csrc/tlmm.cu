// Packed ternary matmul (TLMM) for Hopper.
//
// Replaces: src/repro/kernels/tlmm/kernel.py::tlmm_kernel (the pallas_call in
// tlmm_pallas).  (m, n) int8 activations x (rows, k) uint8 base-3 codes ->
// (m, k) int32, bit-exact.
//
// Bound on the card: at the serving shapes (m <= 128 activation rows against
// 1536x1536 .. 4096x1536 weights) the int8 work is under a microsecond at
// the tensor-core rate, and the weight stream is the packed codes (1.6
// bits/weight, 0.5-1.3 MB a linear), so the kernel is bound by latency and
// by how fast it turns code bytes into int8 operands.
//
// Two regimes in this source; kernels/tlmm/plan.py picks one on m and sizes
// the grid.  Both may split the reduction over blocks (grid.z): the partial
// sums meet in a zeroed output through integer atomics, exact in any order.
//   - Decode, m <= 16 (tlmm_dp4a_kernel): streams the weights.  A block is
//     one warp wide, 128 columns, 4 adjacent ones a lane read with one
//     32-bit load; its 8 warps share the split's code rows and meet in
//     shared memory.  The activations of the split (<= 16 rows) sit in
//     shared memory once, G values of a code row packed in 8 bytes, and a
//     code turns into its G weights through two small tables that no two
//     lanes read in conflict (SplitWeights), so one __dp4a and one
//     multiply-add cover a code.
//   - Prefill, m > 16 (tlmm_mma_kernel): int8 tensor cores through
//     mma.sync m16n8k32.  A block owns a 64 x 64 tile and walks its split in
//     steps of 32 code rows, each step's codes decoded once into shared
//     memory (column-major along the reduction, the "col" B operand).  The
//     steps overlap, so that the loads' latency stays off the path: while
//     step s multiplies, step s + 1's codes (loaded into registers two
//     steps earlier) are decoded into the other weight buffer, 16-byte
//     cp.async copies bring step s + 2's activations into the third
//     activation buffer, and step s + 3's code bytes are loaded; one barrier
//     a step.
// Rows past m, columns past k and reduction indices past L read as zero
// (codes past `rows` as code 0, whose weights only meet zero activations),
// so the wrapper never pads; a code past the table (never made by packing)
// is clamped into it.
#include "ternary.cuh"

namespace {

using repro::pow3;

// ---------------------------------------------------------------------------
// Decode regime: __dp4a, 8 warps a block over one warp-wide column tile
// ---------------------------------------------------------------------------

constexpr int D_THREADS = 256;
constexpr int D_WARPS = D_THREADS / 32;
constexpr int D_COLS = 128;     // plan.DECODE_COLS: 4 columns a lane
constexpr int D_CHUNK = 64;     // code rows whose activations are staged at once

template <int G, int MR>
__global__ void __launch_bounds__(D_THREADS)
tlmm_dp4a_kernel(const int8_t* __restrict__ a, int64_t lda,
                 const uint8_t* __restrict__ codes, int64_t ldc,
                 int32_t* __restrict__ out, int m, int k, int L, int per,
                 bool vec, bool atomic) {
  __shared__ repro::SplitWeights<G> wt_s;
  __shared__ int2 act_s[D_CHUNK][MR];
  __shared__ int red_s[MR][D_COLS];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col0 = blockIdx.x * D_COLS, col = col0 + 4 * lane;
  const int n_groups = (L + G - 1) / G;
  const int g_lo = blockIdx.z * per;
  const int g_hi = min(n_groups, g_lo + per);

  wt_s.init(tid, D_THREADS);
  for (int i = tid; i < MR * D_COLS; i += D_THREADS) (&red_s[0][0])[i] = 0;

  int acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0;

  for (int c0 = g_lo; c0 < g_hi; c0 += D_CHUNK) {
    const int ch = min(D_CHUNK, g_hi - c0);
    __syncthreads();   // the last chunk's reads are done
    for (int idx = tid; idx < ch * MR; idx += D_THREADS) {
      const int r = idx / MR, i = idx - r * MR;
      act_s[r][i] = repro::group_acts<G>(
          i < m ? a + static_cast<int64_t>(i) * lda : nullptr, (c0 + r) * G,
          L);
    }
    __syncthreads();
#pragma unroll 2
    for (int r = warp; r < ch; r += D_WARPS) {
      const uint32_t cw =
          col < k ? repro::load_codes4(
                        codes + static_cast<int64_t>(c0 + r) * ldc, col, k,
                        vec, 0)
                  : 0;
      uint2 wt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t v = wt_s(static_cast<int>((cw >> (8 * q)) & 0xff));
        wt[q] = {static_cast<uint32_t>(v), static_cast<uint32_t>(v >> 32)};
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int2 av = act_s[r][i];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = repro::group_dot(av, wt[q], acc[i][q]);
      }
    }
  }
  __syncthreads();   // red_s zeroed (also when the loop ran no chunk)
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i >= m) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) atomicAdd(&red_s[i][4 * lane + q], acc[i][q]);
  }
  __syncthreads();
  for (int idx = tid; idx < MR * D_COLS; idx += D_THREADS) {
    const int i = idx / D_COLS, j = idx - i * D_COLS, c = col0 + j;
    if (i >= m || c >= k) continue;
    int32_t* o = out + static_cast<int64_t>(i) * k + c;
    if (atomic) atomicAdd(o, red_s[i][j]);
    else *o = red_s[i][j];
  }
}

// ---------------------------------------------------------------------------
// Prefill regime: int8 mma.sync on 64 x 64 tiles, pipelined steps
// ---------------------------------------------------------------------------

constexpr int M_THREADS = 256;  // 8 warps, 2 x 4, a 32 x 16 tile each
constexpr int M_BM = 64;        // plan.MMA_ROWS
constexpr int M_BN = 64;        // plan.MMA_COLS
constexpr int M_R = 32;         // plan.MMA_STEP: code rows a step
constexpr int M_UNITS = M_BN * M_R / 4 / M_THREADS;   // decode units a thread

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  // the bytes past src_bytes are filled with zeros
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  // all but the newest commit group have landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8 x 8 matrices of 16-bit words (8 rows of 16 bytes) from shared
// memory, lane l giving the address of row l % 8 of matrix l / 8; lane l
// gets the 4 bytes (l % 4) of row l / 4 of each.  For int8 those are the
// mma.m16n8k32 fragments: A's (rows 0-7 | 8-15) x (bytes 0-15 | 16-31), or
// B's bytes 0-15 | 16-31 of two 8-column groups.
__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], const int* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16 x 32, row) x b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Decode unit u in [0, M_BN * M_R / 4) is (column n, code rows 4 q4 .. 4 q4
// + 3), thread tid owning u = tid + i * M_THREADS; a warp spans 8 columns x
// 4 q4, so that its stores of G words a unit into w_s (pitch 4 mod 8 words)
// hit distinct banks at G = 3 and 5.
__device__ __forceinline__ int unit_col(int u) { return u % 8 + 8 * (u / 64); }
__device__ __forceinline__ int unit_quad(int u) { return (u / 8) % 8; }

// The code bytes of a thread's decode units of one step, in registers and
// not combined, so that nothing waits on the loads before the next step
// decodes them.  Codes past `rows` or k read as code 0.
__device__ __forceinline__ void load_step_codes(
    uint32_t (&cb)[M_UNITS][4], const uint8_t* __restrict__ codes,
    int64_t ldc, int cr0, int col0, int rows, int k, int tid) {
#pragma unroll
  for (int i = 0; i < M_UNITS; ++i) {
    const int u = tid + i * M_THREADS, n = unit_col(u), q4 = unit_quad(u);
    const int col = col0 + n;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int cr = cr0 + 4 * q4 + qq;
      cb[i][qq] = cr < rows && col < k
                      ? __ldg(codes + static_cast<int64_t>(cr) * ldc + col)
                      : 0;
    }
  }
}

// Shared memory of the mma kernel: M_STAGES activation buffers and two
// weight buffers of 64 rows at a pitch of 8G + 4 words (4 mod 8: fragment
// reads of 8 rows x 4 words hit 32 banks).
constexpr int M_STAGES = 3;
__host__ __device__ constexpr int mma_pitch(int g) { return 8 * g + 4; }
__host__ __device__ constexpr size_t mma_smem_bytes(int g) {
  return sizeof(int) * (M_STAGES + 2) * M_BM * mma_pitch(g);
}
static_assert(M_BM == M_BN, "activation and weight buffers share a shape");

template <int G>
__global__ void __launch_bounds__(M_THREADS)
tlmm_mma_kernel(const int8_t* __restrict__ a, int64_t lda,
                const uint8_t* __restrict__ codes, int64_t ldc,
                int32_t* __restrict__ out, int m, int k, int rows, int L,
                int per, bool vec_a, bool atomic) {
  constexpr int KB = M_R * G;       // reduction bytes a step: G k32 slices
  constexpr int PW = mma_pitch(G);
  constexpr int AC = KB / 16;       // 16-byte chunks of an activation row
  extern __shared__ __align__(16) int smem[];
  auto a_s = reinterpret_cast<int (*)[M_BM][PW]>(smem);          // [M_STAGES]
  auto w_s = reinterpret_cast<int (*)[M_BN][PW]>(smem + M_STAGES * M_BM * PW);
  __shared__ repro::SplitWeights<G> wt_s;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;   // mma fragment coordinates
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix row addresses
  const int row0 = blockIdx.y * M_BM, col0 = blockIdx.x * M_BN;
  const int n_groups = (L + G - 1) / G;
  const int g_lo = blockIdx.z * per;
  const int n_steps = (min(n_groups, g_lo + per) - g_lo + M_R - 1) / M_R;

  // step s's activations into a_s[s % M_STAGES] (cp.async, zero-filled past
  // L and m); always one commit group, empty past the last step
  auto stage_acts = [&](int s) {
    const int i0 = (g_lo + s * M_R) * G, buf = s % M_STAGES;
    for (int idx = tid; s < n_steps && idx < M_BM * AC; idx += M_THREADS) {
      const int r = idx / AC, ch = idx - r * AC, row = row0 + r;
      const int pos = i0 + 16 * ch;
      const int nb = row < m ? min(max(L - pos, 0), 16) : 0;
      int8_t* dst = reinterpret_cast<int8_t*>(&a_s[buf][r][0]) + 16 * ch;
      const int8_t* src = a + static_cast<int64_t>(row) * lda + pos;
      if (vec_a) {
        cp_async16(dst, nb > 0 ? src : a, nb);
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b) dst[b] = b < nb ? src[b] : 0;
      }
    }
    cp_async_commit();
  };
  auto load_codes = [&](uint32_t (&cb)[M_UNITS][4], int s) {
    if (s < n_steps)
      load_step_codes(cb, codes, ldc, g_lo + s * M_R, col0, rows, k, tid);
  };
  // a step's code bytes (registers) -> its weights in w_s[s & 1], column-
  // major along the reduction: a unit's 4 codes become G words of 4G weights
  auto decode = [&](const uint32_t (&cb)[M_UNITS][4], int s) {
#pragma unroll
    for (int i = 0; i < M_UNITS; ++i) {
      const int u = tid + i * M_THREADS, n = unit_col(u), q4 = unit_quad(u);
      uint32_t words[G];
#pragma unroll
      for (int w = 0; w < G; ++w) words[w] = 0;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const uint64_t v = wt_s(static_cast<int>(cb[i][qq]));
        constexpr int BITS = 8 * G;
        const int at = qq * BITS;   // v's bits [at, at + BITS) of the unit
#pragma unroll
        for (int w = 0; w < G; ++w) {
          const int lo = 32 * w;
          if (at + BITS <= lo || at >= lo + 32) continue;
          words[w] |= at >= lo ? static_cast<uint32_t>(v << (at - lo))
                               : static_cast<uint32_t>(v >> (lo - at));
        }
      }
#pragma unroll
      for (int w = 0; w < G; ++w)
        w_s[s & 1][n][q4 * G + w] = static_cast<int>(words[w]);
    }
  };

  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  int acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // step s multiplies while step s + 1's codes decode, step s + 2's
  // activations copy and step s + 3's codes load (two register sets, so
  // the loop is unrolled by two): one barrier a step
  auto step = [&](int s, uint32_t (&cb)[M_UNITS][4]) {
    cp_async_wait_one();   // step s's activations landed
    __syncthreads();       // ... for every thread; step s - 1 is done
    stage_acts(s + 2);
    if (s + 1 < n_steps) decode(cb, s + 1);
    load_codes(cb, s + 3);
    const int buf = s % M_STAGES;
#pragma unroll
    for (int ks = 0; ks < G; ++ks) {   // k32 slices of the step
      // one ldmatrix.x4 a fragment: lane l gives the row address of row
      // l % 8 of 8 x 16-byte matrix l / 8
      int af[2][4], bf[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], &a_s[buf][wm + 16 * mi + mrow + 8 * (mat & 1)]
                                [8 * ks + 4 * (mat >> 1)]);
      ldmatrix_x4(bf, &w_s[s & 1][wn + 8 * (mat >> 1) + mrow]
                          [8 * ks + 4 * (mat & 1)]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int b[2] = {bf[2 * ni], bf[2 * ni + 1]};
          mma_s8(acc[mi][ni], af[mi], b);
        }
    }
  };
  uint32_t cb0[M_UNITS][4], cb1[M_UNITS][4];
  wt_s.init(tid, M_THREADS);
  stage_acts(0);
  stage_acts(1);
  load_codes(cb0, 0);
  load_codes(cb1, 1);
  __syncthreads();   // wt_s
  if (n_steps > 0) decode(cb0, 0);
  load_codes(cb0, 2);
  for (int s = 0; s < n_steps; s += 2) {
    step(s, cb1);
    if (s + 1 < n_steps) step(s + 1, cb0);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + 16 * mi + gq + 8 * h;
        if (row >= m) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + wn + 8 * ni + 2 * tq + e;
          if (c >= k) continue;
          int32_t* o = out + static_cast<int64_t>(row) * k + c;
          if (atomic) atomicAdd(o, acc[mi][ni][2 * h + e]);
          else *o = acc[mi][ni][2 * h + e];
        }
      }
}

template <int G, int MR>
int launch_dp4a(const int8_t* a, int64_t lda, const uint8_t* codes,
                int64_t ldc, int32_t* out, int m, int k, int L, int per,
                int split, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(codes) % 4 == 0 && ldc % 4 == 0;
  dim3 grid((k + D_COLS - 1) / D_COLS, 1, split);
  tlmm_dp4a_kernel<G, MR><<<grid, D_THREADS, 0, stream>>>(
      a, lda, codes, ldc, out, m, k, L, per, vec, split > 1);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_g(const int8_t* a, int64_t lda, const uint8_t* codes, int64_t ldc,
             int32_t* out, int m, int k, int rows, int L, int bm, int bn,
             int per, int split, cudaStream_t st) {
  if (bm <= 16) {
    if (bn != D_COLS || m > bm) return static_cast<int>(cudaErrorInvalidValue);
    switch (bm) {
      case 1: return launch_dp4a<G, 1>(a, lda, codes, ldc, out, m, k, L, per, split, st);
      case 4: return launch_dp4a<G, 4>(a, lda, codes, ldc, out, m, k, L, per, split, st);
      case 8: return launch_dp4a<G, 8>(a, lda, codes, ldc, out, m, k, L, per, split, st);
      case 16: return launch_dp4a<G, 16>(a, lda, codes, ldc, out, m, k, L, per, split, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (bm != M_BM || bn != M_BN || per % M_R != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = mma_smem_bytes(G);
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tlmm_mma_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const bool vec_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 16 == 0;
  dim3 grid((k + M_BN - 1) / M_BN, (m + M_BM - 1) / M_BM, split);
  tlmm_mma_kernel<G><<<grid, M_THREADS, smem, st>>>(
      a, lda, codes, ldc, out, m, k, rows, L, per, vec_a, split > 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (m, >= L) int8, row stride lda; codes: (rows, k) uint8, row stride ldc;
// out: (m, k) int32 contiguous, ZEROED by the caller when split > 1 (blocks
// add into it).  Sums over reduction indices [0, L), L <= rows * g.  The
// plan (kernels/tlmm/plan.py plan_tlmm): bm <= 16 rows and bn = 128
// columns a block for the __dp4a kernel, bm = bn = 64 for the mma kernel;
// per code rows (a multiple of 32 for the mma kernel) in each of split
// reduction splits.
REPRO_API int tlmm_launch(const void* a, int64_t lda, const void* codes,
                          int64_t ldc, void* out, int m, int k, int rows,
                          int L, int g, int bm, int bn, int per, int split,
                          void* stream) {
  if (per <= 0 || split <= 0 || g < 1 || g > 5 || (L + g - 1) / g > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  auto A = static_cast<const int8_t*>(a);
  auto C = static_cast<const uint8_t*>(codes);
  auto O = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: return launch_g<1>(A, lda, C, ldc, O, m, k, rows, L, bm, bn, per, split, st);
    case 2: return launch_g<2>(A, lda, C, ldc, O, m, k, rows, L, bm, bn, per, split, st);
    case 3: return launch_g<3>(A, lda, C, ldc, O, m, k, rows, L, bm, bn, per, split, st);
    case 4: return launch_g<4>(A, lda, C, ldc, O, m, k, rows, L, bm, bn, per, split, st);
    default: return launch_g<5>(A, lda, C, ldc, O, m, k, rows, L, bm, bn, per, split, st);
  }
}

// Dynamic shared memory of one block of the kernel that a plan with bm rows
// a block launches at group size g (0: the kernel's is all static).
REPRO_API int tlmm_dynamic_smem(int g, int bm) {
  return bm == M_BM ? static_cast<int>(mma_smem_bytes(g)) : 0;
}
