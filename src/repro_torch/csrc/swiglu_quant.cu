// Fused dequant, SiLU(gate) * up and int8 requant (the paper's TLMM-FUSE
// elementwise unit) for Hopper.
//
// Replaces: src/repro/kernels/swiglu_quant/kernel.py::swiglu_quant_kernel.
// Per row of the (m, f) int32 gate and up accumulators and their (m, 1) f32
// dequant scales: g = gate * gs, u = up * us, h = g * sigmoid(g) * u,
// amax = max(|h|, 1e-5), scale = amax * (1/127), q = clip(rint(h / scale),
// -127, 127) -> (m, f) int8 and (m, 1) f32 scales.
//
// Bound on the card: bytes (two int32 reads and one int8 write a value),
// 0.04-1.4 us at the model's rows: below one launch.  A call costs its
// chain of dependent latencies.
//
// Design (kernels/swiglu_quant/plan.py): one block a row, the row cut into
// 16-byte chunks of 4 values, thread t holding chunks t and t + T (T
// threads, at most 2 chunks a thread: rows up to 8192 values).  Each thread
// loads its chunks of gate and up, all loads in flight at once (16 bytes a
// load where the rows are aligned, else the scalar instantiation reads the
// same chunks), computes h once into registers, the row's maximum is
// reduced by shuffles and one shared-memory exchange, and each thread
// quantizes its values from registers and stores 4 codes at once.  A row
// too wide for registers is staged once into shared memory by cp.async
// instead (h overwrites the gate chunk there; rows up to 29040 values).  A
// row too wide for shared memory (qwen2-72b's 29568) is looped: 1024
// threads walk chunks t, t + 1024, ... from global memory twice, h and the
// maximum first, then h again and the codes (each value's arithmetic is
// its own, so h is the same bits both times).  Below the looped widths no
// value is read twice and each expf runs once.  A maximum does not
// depend on its order, so the bits do not depend on the layout.  (Splitting
// a small-m row over a thread-block cluster with a distributed-shared-
// memory maximum lost to one block a row at every m and width timed: its
// launch and cluster barriers cost more than its extra SMs saved.)  The
// arithmetic is the plain version's, operation for operation: sigmoid as
// 1 / (1 + expf(-g)) (expf, not __expf), the scale as a product by
// f32(1/127) (the JAX package's jitted arithmetic), a true division by it
// and rintf (round half to even).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int CHUNK = 4;
constexpr int THREADS = 512;       // a block, while 2 chunks a thread do
constexpr int MAX_THREADS = 1024;
constexpr int KMAX = 2;            // chunks a thread holds in registers
constexpr int MAX_SMEM = 232448;   // shared memory a block may take (H100)

__device__ __forceinline__ float swiglu(int gate, int up, float gs,
                                        float us) {
  const float g = __fmul_rn(static_cast<float>(gate), gs);
  const float u = __fmul_rn(static_cast<float>(up), us);
  return __fmul_rn(__fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)))),
                   u);
}

__device__ __forceinline__ unsigned code(float h, float sc) {
  return static_cast<uint8_t>(static_cast<int8_t>(
      fminf(fmaxf(rintf(h / sc), -127.0f), 127.0f)));
}

// One chunk of a row into 4 ints (zeros past f).
template <bool VEC>
__device__ __forceinline__ int4 load_chunk(const int32_t* row, int c, int f) {
  if constexpr (VEC) return reinterpret_cast<const int4*>(row)[c];
  int v[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const int e = c * CHUNK + j;
    v[j] = e < f ? row[e] : 0;
  }
  return make_int4(v[0], v[1], v[2], v[3]);
}

// A chunk's four values of h, their maximum into amax.
__device__ __forceinline__ float4 swiglu4(int4 g, int4 u, float gs, float us,
                                          float& amax) {
  const float4 h = make_float4(swiglu(g.x, u.x, gs, us),
                               swiglu(g.y, u.y, gs, us),
                               swiglu(g.z, u.z, gs, us),
                               swiglu(g.w, u.w, gs, us));
  amax = fmaxf(amax, fmaxf(fmaxf(fabsf(h.x), fabsf(h.y)),
                           fmaxf(fabsf(h.z), fabsf(h.w))));
  return h;
}

template <bool VEC>
__device__ __forceinline__ void store_chunk(int8_t* row, int c, int f,
                                            float4 h, float sc) {
  const unsigned b[CHUNK] = {code(h.x, sc), code(h.y, sc), code(h.z, sc),
                             code(h.w, sc)};
  if constexpr (VEC) {
    reinterpret_cast<unsigned*>(row)[c] =
        b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
  } else {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (c * CHUNK + j < f) row[c * CHUNK + j] = static_cast<int8_t>(b[j]);
  }
}

// The block's maximum of every thread's v (all >= 0), to every thread:
// warp shuffles, then one exchange through shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = repro::warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < static_cast<int>(blockDim.x / 32); ++i)
    v = fmaxf(v, red[i]);
  return v;
}

// Where a block keeps its row: registers, shared memory, or nowhere (the
// looped row, read twice).
enum Path { REGS, STAGED, LOOPED };

// Block b quantizes row b; thread t holds the chunks t + k * T.
template <bool VEC, int PATH>
__global__ void __launch_bounds__(MAX_THREADS)
swiglu_quant_kernel(const int32_t* __restrict__ gate, int64_t ldg,
                    const int32_t* __restrict__ up, int64_t ldu,
                    const float* __restrict__ gscale,
                    const float* __restrict__ uscale, int8_t* __restrict__ q,
                    float* __restrict__ scale, int f) {
  extern __shared__ int4 stage[];   // STAGED: gate chunks, then up chunks
  __shared__ float red[MAX_THREADS / 32];
  const int64_t row = blockIdx.x;
  const int nc = (f + CHUNK - 1) / CHUNK;
  const int T = blockDim.x, t = threadIdx.x;
  const int32_t* gr = gate + row * ldg;
  const int32_t* ur = up + row * ldu;
  int8_t* qr = q + row * f;
  const float gs = gscale[row], us = uscale[row];
  float amax = 0.f;

  if constexpr (PATH == REGS) {
    int4 g[KMAX], u[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int c = t + k * T;
      if (c < nc) {
        g[k] = load_chunk<VEC>(gr, c, f);
        u[k] = load_chunk<VEC>(ur, c, f);
      }
    }
    float4 h[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (t + k * T < nc) h[k] = swiglu4(g[k], u[k], gs, us, amax);
    const float sc =
        __fmul_rn(fmaxf(block_max(amax, red), 1e-5f), 1.0f / 127.0f);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int c = t + k * T;
      if (c < nc) store_chunk<VEC>(qr, c, f, h[k], sc);
    }
    if (t == 0) scale[row] = sc;
  } else if constexpr (PATH == LOOPED) {
    for (int c = t; c < nc; c += T)
      swiglu4(load_chunk<VEC>(gr, c, f), load_chunk<VEC>(ur, c, f), gs, us,
              amax);
    const float sc =
        __fmul_rn(fmaxf(block_max(amax, red), 1e-5f), 1.0f / 127.0f);
    float unused = 0.f;
    for (int c = t; c < nc; c += T)
      store_chunk<VEC>(qr, c, f,
                       swiglu4(load_chunk<VEC>(gr, c, f),
                               load_chunk<VEC>(ur, c, f), gs, us, unused),
                       sc);
    if (t == 0) scale[row] = sc;
  } else {
    int4* gst = stage;
    int4* ust = stage + nc;
    for (int c = t; c < nc; c += T) {
      if constexpr (VEC) {
        repro::cp_async16(&gst[c], gr + c * CHUNK);
        repro::cp_async16(&ust[c], ur + c * CHUNK);
      } else {
        int* gi = reinterpret_cast<int*>(&gst[c]);
        int* ui = reinterpret_cast<int*>(&ust[c]);
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const int e = c * CHUNK + j;
          if (e < f) {
            repro::cp_async4(&gi[j], gr + e);
            repro::cp_async4(&ui[j], ur + e);
          } else {
            gi[j] = ui[j] = 0;
          }
        }
      }
    }
    repro::cp_async_commit();
    repro::cp_async_wait<0>();   // this thread's chunks, which it reads alone
    for (int c = t; c < nc; c += T) {
      const float4 h = swiglu4(gst[c], ust[c], gs, us, amax);
      reinterpret_cast<float4*>(gst)[c] = h;
    }
    const float sc =
        __fmul_rn(fmaxf(block_max(amax, red), 1e-5f), 1.0f / 127.0f);
    for (int c = t; c < nc; c += T)
      store_chunk<VEC>(qr, c, f, reinterpret_cast<const float4*>(gst)[c], sc);
    if (t == 0) scale[row] = sc;
  }
}

template <bool VEC, int PATH>
int launch(const void* gate, int64_t ldg, const void* up, int64_t ldu,
           const void* gscale, const void* uscale, void* q, void* scale,
           int m, int f, int threads, cudaStream_t st) {
  const size_t smem =
      PATH == STAGED ? 2 * sizeof(int4) * ((f + CHUNK - 1) / CHUNK) : 0;
  const auto kernel = swiglu_quant_kernel<VEC, PATH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<m, threads, smem, st>>>(
      static_cast<const int32_t*>(gate), ldg,
      static_cast<const int32_t*>(up), ldu,
      static_cast<const float*>(gscale), static_cast<const float*>(uscale),
      static_cast<int8_t*>(q), static_cast<float*>(scale), f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gate, up: (m, f) int32, row strides ldg, ldu, unit stride along f;
// gscale, uscale: (m,) f32; q: (m, f) int8 contiguous; scale: (m,) f32.
// vec: 16-byte loads and 4-byte stores (gate and up must then start every
// row on 16 bytes and f be a multiple of 4).  The layout follows f alone
// (kernels/swiglu_quant/plan.py): THREADS threads a block, more (up to
// MAX_THREADS) while KMAX chunks a thread hold a row in registers, past
// that MAX_THREADS threads on the row staged in shared memory where it fits
// beside the block's static shared memory, and looped where it does not.
// A call the kernel does not take returns cudaErrorInvalidValue.
REPRO_API int swiglu_quant_launch(const void* gate, int64_t ldg,
                                  const void* up, int64_t ldu,
                                  const void* gscale, const void* uscale,
                                  void* q, void* scale, int m, int f,
                                  int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int nc = (f + CHUNK - 1) / CHUNK;
  int threads = std::min(THREADS, 32 * ((nc + 31) / 32));
  if ((nc + threads - 1) / threads > KMAX)
    threads = std::min(MAX_THREADS,
                       32 * ((nc + 32 * KMAX - 1) / (32 * KMAX)));
  const bool staged = (nc + threads - 1) / threads > KMAX;
  const bool looped =
      staged && 2 * int64_t(sizeof(int4)) * nc +
                        int64_t(sizeof(float)) * (MAX_THREADS / 32) > MAX_SMEM;
  if (f < 1 ||
      (vec && !(f % CHUNK == 0 &&
                repro::aligned16(gate, {ldg * int64_t(sizeof(int32_t))}) &&
                repro::aligned16(up, {ldu * int64_t(sizeof(int32_t))}))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (looped)
    return vec ? launch<true, LOOPED>(gate, ldg, up, ldu, gscale, uscale, q,
                                      scale, m, f, threads, st)
               : launch<false, LOOPED>(gate, ldg, up, ldu, gscale, uscale, q,
                                       scale, m, f, threads, st);
  if (staged)
    return vec ? launch<true, STAGED>(gate, ldg, up, ldu, gscale, uscale, q,
                                      scale, m, f, threads, st)
               : launch<false, STAGED>(gate, ldg, up, ldu, gscale, uscale, q,
                                       scale, m, f, threads, st);
  return vec ? launch<true, REGS>(gate, ldg, up, ldu, gscale, uscale, q,
                                  scale, m, f, threads, st)
             : launch<false, REGS>(gate, ldg, up, ldu, gscale, uscale, q,
                                   scale, m, f, threads, st);
}
