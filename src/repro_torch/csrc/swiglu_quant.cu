// Fused dequant, SiLU(gate) * up and int8 requant (the paper's TLMM-FUSE
// elementwise unit) for Hopper.
//
// Replaces: src/repro/kernels/swiglu_quant/kernel.py::swiglu_quant_kernel.
// Per row of the (m, f) int32 gate and up accumulators and their (m, 1) f32
// dequant scales: g = gate * gs, u = up * us, h = g * sigmoid(g) * u,
// amax = max(|h|, 1e-5), scale = amax / 127, q = clip(rint(h / scale),
// -127, 127) -> (m, f) int8 and (m, 1) f32 scales.
//
// Bound on the card: bytes (two int32 reads and one int8 write per element,
// one expf), a few microseconds at the model's rows.
//
// Design: one block per row; pass 1 finds amax of h (block reduction),
// pass 2 recomputes h with the same operations and quantizes, so the float
// activation never reaches device memory.  The arithmetic is the plain
// version's, operation for operation: sigmoid as 1 / (1 + expf(-g)) (expf,
// not __expf), a true division by the scale and rintf (round half to even).
// A maximum does not depend on its order, so kernel and plain version
// agree bit for bit wherever expf does.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float swiglu(int gate, int up, float gs,
                                        float us) {
  const float g = static_cast<float>(gate) * gs;
  const float u = static_cast<float>(up) * us;
  return g * (1.0f / (1.0f + expf(-g))) * u;
}

__global__ void __launch_bounds__(THREADS)
swiglu_quant_kernel(const int32_t* __restrict__ gate, int64_t ldg,
                    const int32_t* __restrict__ up, int64_t ldu,
                    const float* __restrict__ gscale,
                    const float* __restrict__ uscale, int8_t* __restrict__ q,
                    float* __restrict__ scale, int f) {
  __shared__ float red[WARPS + 1];
  const int64_t row = blockIdx.x;
  const int32_t* gr = gate + row * ldg;
  const int32_t* ur = up + row * ldu;
  const float gs = gscale[row], us = uscale[row];

  float amax = 0.0f;
  for (int i = threadIdx.x; i < f; i += THREADS)
    amax = fmaxf(amax, fabsf(swiglu(gr[i], ur[i], gs, us)));
  amax = fmaxf(repro::block_reduce<WARPS, true>(amax, red), 1e-5f);
  const float sc = amax / 127.0f;

  int8_t* qr = q + row * f;
  for (int i = threadIdx.x; i < f; i += THREADS) {
    const float h = swiglu(gr[i], ur[i], gs, us);
    qr[i] = static_cast<int8_t>(
        fminf(fmaxf(rintf(h / sc), -127.0f), 127.0f));
  }
  if (threadIdx.x == 0) scale[row] = sc;
}

}  // namespace

// gate, up: (m, f) int32, row strides ldg, ldu, unit stride along f;
// gscale, uscale: (m,) f32; q: (m, f) int8 contiguous; scale: (m,) f32.
REPRO_API int swiglu_quant_launch(const void* gate, int64_t ldg,
                                  const void* up, int64_t ldu,
                                  const void* gscale, const void* uscale,
                                  void* q, void* scale, int m, int f,
                                  void* stream) {
  swiglu_quant_kernel<<<m, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gate), ldg,
      static_cast<const int32_t*>(up), ldu,
      static_cast<const float*>(gscale), static_cast<const float*>(uscale),
      static_cast<int8_t*>(q), static_cast<float*>(scale), f);
  return static_cast<int>(cudaGetLastError());
}
