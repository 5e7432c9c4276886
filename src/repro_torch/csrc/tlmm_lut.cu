// Table-lookup ternary matmul (TLMM Method 3, full table) for Hopper.
//
// Replaces: src/repro/kernels/tlmm_lut/kernel.py::tlmm_lut_kernel (the
// pallas_call in tlmm_lut_pallas).  (m, n) int8 activations x (rows, k)
// uint8 base-3 codes -> (m, k) int32, bit-exact (integer sums).
//
// Bound on the card: the bytes are tlmm's (the packed codes, the
// activations, the int32 output: a few microseconds at the serving shapes)
// and the arithmetic is integer adds, so what bounds it is shared memory:
// every output is a sum of one table read per group, and a warp's reads of
// one table land on banks chosen by the codes (random bank conflicts).
// There is no tensor-core form of a lookup; this is the design the paper's
// Table 4 measures against tlmm.
//
// Design, the paper's precompute-once, look-up-many dataflow:
//   - a block owns BM activation rows (2, 4 or 8) and 1024 output columns,
//     4 adjacent ones a thread, so each (row, group) table serves 1024
//     columns per build (the plan in kernels/tlmm/plan.py splits the groups
//     over blocks, grid.z, to fill the SMs);
//   - the BM rows' int16 entries of one code lie side by side, two rows a
//     32-bit word (|entry| <= G * 128), so one 4-, 8- or 16-byte shared load
//     serves all BM rows;
//   - every thread builds its own entries directly, T[c] = sum_j w_j(c) a_j,
//     as one __dp4a and one multiply-add a row (no chain of digit rounds),
//     THREADS / GS threads a group, each reading the group's activations
//     once;
//   - a thread reads its 4 columns' codes of a group with one 32-bit load
//     (a step's first 8 groups' before the tables are built, so that their
//     latency overlaps the build) and adds the packed words as they are: the low halves' sum stays
//     within int16 for a step of at most 32767 / (G * 128) groups (51 at
//     G = 5), after which both halves are unpacked into int32 sums.
// Rows past m, columns past k and reduction indices past L read as zero
// (the last group's missing activations as zero terms), so the wrapper
// never pads; a code past the table (never made by packing) is clamped into
// it so that no read leaves shared memory.
#include "ternary.cuh"

namespace {

using repro::pow3;

constexpr int THREADS = 256;
constexpr int CPT = 4;                  // output columns a thread
constexpr int BK = THREADS * CPT;       // plan.LUT_COLS
constexpr int PRE = 8;                  // groups whose codes load early

// groups a step: tables of 8 rows stay near 62 KB at G = 5, and the packed
// sums of a step cannot carry between halves
__host__ __device__ constexpr int group_step(int g) {
  return g >= 5 ? 16 : g == 4 ? 32 : 64;
}
static_assert(group_step(5) * 5 * 128 < 32768 && group_step(4) * 4 * 128 <
              32768 && group_step(3) * 3 * 128 < 32768, "packed sums");

template <int G, int BM>
constexpr size_t smem_bytes() {
  return sizeof(int) * group_step(G) * pow3(G) * (BM / 2)   // tables
         + sizeof(uint2) * pow3(G)                           // code weights
         + sizeof(int2) * BM * group_step(G);                // activations
}

template <int W>
__device__ __forceinline__ void load_words(const int* p, int (&e)[W]) {
  if constexpr (W == 1) {
    e[0] = *p;
  } else if constexpr (W == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    e[0] = v.x; e[1] = v.y;
  } else {
    const int4 v = *reinterpret_cast<const int4*>(p);
    e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
  }
}

template <int W>
__device__ __forceinline__ void store_words(int* p, const int (&e)[W]) {
  if constexpr (W == 1) *p = e[0];
  else if constexpr (W == 2) *reinterpret_cast<int2*>(p) = make_int2(e[0], e[1]);
  else *reinterpret_cast<int4*>(p) = make_int4(e[0], e[1], e[2], e[3]);
}

template <int G, int BM>
__global__ void __launch_bounds__(THREADS)
tlmm_lut_kernel(const int8_t* __restrict__ a, int64_t lda,
                const uint8_t* __restrict__ codes, int64_t ldc,
                int32_t* __restrict__ out, int m, int k, int L, int per,
                bool vec, bool atomic) {
  constexpr int NC = pow3(G);
  constexpr int GS = group_step(G);
  constexpr int W = BM / 2;             // 32-bit words an entry
  constexpr int TPG = THREADS / GS;     // threads building a group's table
  static_assert(THREADS % GS == 0, "whole groups of builders");
  extern __shared__ __align__(16) int smem[];
  int* t_s = smem;                                       // [GS][NC][W]
  uint2* wt_s = reinterpret_cast<uint2*>(t_s + GS * NC * W);   // [NC]
  int2* act_s = reinterpret_cast<int2*>(wt_s + NC);           // [BM][GS]

  const int tid = threadIdx.x;
  const int col = blockIdx.x * BK + tid * CPT;
  const int row0 = blockIdx.y * BM;
  const int n_groups = (L + G - 1) / G;
  const int g_lo = blockIdx.z * per;
  const int g_hi = min(n_groups, g_lo + per);

  for (int c = tid; c < NC; c += THREADS) wt_s[c] = repro::code_weights<G>(c);

  int acc[CPT][BM];
#pragma unroll
  for (int q = 0; q < CPT; ++q)
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[q][r] = 0;

  for (int g0 = g_lo; g0 < g_hi; g0 += GS) {
    const int gs = min(GS, g_hi - g0);
    const uint8_t* crow = codes + static_cast<int64_t>(g0) * ldc;
    // the step's first PRE groups' codes load while the tables are built
    uint32_t pre[PRE];
#pragma unroll
    for (int grp = 0; grp < PRE; ++grp)
      pre[grp] = col < k && grp < gs
                     ? repro::load_codes4(crow + grp * ldc, col, k, vec, 0)
                     : 0;
    __syncthreads();   // the last step's lookups are done
    // 1. the step's activations, G of a (row, group) packed as int8
    for (int idx = tid; idx < BM * gs; idx += THREADS) {
      const int r = idx / gs, grp = idx - r * gs, row = row0 + r;
      act_s[r * GS + grp] = repro::group_acts<G>(
          row < m ? a + static_cast<int64_t>(row) * lda : nullptr,
          (g0 + grp) * G, L);
    }
    __syncthreads();
    // 2. tables: TPG threads a group, each reading the group's activations
    //    once and computing every TPG-th entry for all BM rows
    if (const int grp = tid / TPG; grp < gs) {
      int2 av[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) av[r] = act_s[r * GS + grp];
      for (int c = tid % TPG; c < NC; c += TPG) {
        const uint2 wt = wt_s[c];
        int ent[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int lo = repro::group_dot(av[2 * w], wt, 0);
          const int hi = repro::group_dot(av[2 * w + 1], wt, 0);
          ent[w] = hi * 65536 + lo;
        }
        store_words<W>(t_s + (grp * NC + c) * W, ent);
      }
    }
    __syncthreads();
    // 3. lookups: one wide read serves the BM rows of a column
    int pk[CPT][W];
#pragma unroll
    for (int q = 0; q < CPT; ++q)
#pragma unroll
      for (int w = 0; w < W; ++w) pk[q][w] = 0;
    auto lookup = [&](int grp, uint32_t cw) {
      const int* tg = t_s + grp * NC * W;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = min(static_cast<int>((cw >> (8 * q)) & 0xff), NC - 1);
        int ent[W];
        load_words<W>(tg + c * W, ent);
#pragma unroll
        for (int w = 0; w < W; ++w) pk[q][w] += ent[w];
      }
    };
#pragma unroll
    for (int grp = 0; grp < PRE; ++grp)
      if (grp < gs) lookup(grp, pre[grp]);
#pragma unroll 4
    for (int grp = PRE; grp < gs; ++grp)
      lookup(grp, col < k ? repro::load_codes4(crow + grp * ldc, col, k, vec, 0)
                          : 0);
    // 4. unpack: the low half is the int16 sum, the rest the high half's
#pragma unroll
    for (int q = 0; q < CPT; ++q)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int lo = static_cast<int16_t>(pk[q][w] & 0xffff);
        acc[q][2 * w] += lo;
        acc[q][2 * w + 1] += (pk[q][w] - lo) >> 16;
      }
  }
  if (col >= k) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = row0 + r;
    if (row >= m) break;
    int32_t* o = out + static_cast<int64_t>(row) * k + col;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      if (col + q >= k) break;
      if (atomic) atomicAdd(o + q, acc[q][r]);
      else o[q] = acc[q][r];
    }
  }
}

template <int G, int BM>
int launch(const int8_t* a, int64_t lda, const uint8_t* codes, int64_t ldc,
           int32_t* out, int m, int k, int L, int per, int split,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<G, BM>();
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tlmm_lut_kernel<G, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const bool vec = reinterpret_cast<uintptr_t>(codes) % 4 == 0 && ldc % 4 == 0;
  dim3 grid((k + BK - 1) / BK, (m + BM - 1) / BM, split);
  tlmm_lut_kernel<G, BM><<<grid, THREADS, smem, stream>>>(
      a, lda, codes, ldc, out, m, k, L, per, vec, split > 1);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_g(const int8_t* a, int64_t lda, const uint8_t* codes, int64_t ldc,
             int32_t* out, int m, int k, int L, int bm, int per, int split,
             cudaStream_t st) {
  switch (bm) {
    case 2: return launch<G, 2>(a, lda, codes, ldc, out, m, k, L, per, split, st);
    case 4: return launch<G, 4>(a, lda, codes, ldc, out, m, k, L, per, split, st);
    case 8: return launch<G, 8>(a, lda, codes, ldc, out, m, k, L, per, split, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// a: (m, >= L) int8, row stride lda; codes: (rows, k) uint8, row stride ldc;
// out: (m, k) int32 contiguous, ZEROED by the caller when split > 1 (blocks
// add into it).  Sums over reduction indices [0, L), L <= rows * g.  The
// plan (kernels/tlmm/plan.py plan_tlmm_lut): bm rows and bn (= 1024)
// columns a block, per groups in each of split reduction splits.
REPRO_API int tlmm_lut_launch(const void* a, int64_t lda, const void* codes,
                              int64_t ldc, void* out, int m, int k, int rows,
                              int L, int g, int bm, int bn, int per,
                              int split, void* stream) {
  if (bn != BK || per <= 0 || split <= 0 || g < 1 || g > 5 ||
      (L + g - 1) / g > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  auto A = static_cast<const int8_t*>(a);
  auto C = static_cast<const uint8_t*>(codes);
  auto O = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: return launch_g<1>(A, lda, C, ldc, O, m, k, L, bm, per, split, st);
    case 2: return launch_g<2>(A, lda, C, ldc, O, m, k, L, bm, per, split, st);
    case 3: return launch_g<3>(A, lda, C, ldc, O, m, k, L, bm, per, split, st);
    case 4: return launch_g<4>(A, lda, C, ldc, O, m, k, L, bm, per, split, st);
    default: return launch_g<5>(A, lda, C, ldc, O, m, k, L, bm, per, split, st);
  }
}

// Dynamic shared memory of one block at group size g and bm rows a block.
REPRO_API int tlmm_lut_dynamic_smem(int g, int bm) {
  constexpr int BMS[3] = {2, 4, 8};
  constexpr size_t B[5][3] = {
      {smem_bytes<1, 2>(), smem_bytes<1, 4>(), smem_bytes<1, 8>()},
      {smem_bytes<2, 2>(), smem_bytes<2, 4>(), smem_bytes<2, 8>()},
      {smem_bytes<3, 2>(), smem_bytes<3, 4>(), smem_bytes<3, 8>()},
      {smem_bytes<4, 2>(), smem_bytes<4, 4>(), smem_bytes<4, 8>()},
      {smem_bytes<5, 2>(), smem_bytes<5, 4>(), smem_bytes<5, 8>()}};
  for (int i = 0; i < 3; ++i)
    if (g >= 1 && g <= 5 && bm == BMS[i]) return static_cast<int>(B[g - 1][i]);
  return -1;
}
