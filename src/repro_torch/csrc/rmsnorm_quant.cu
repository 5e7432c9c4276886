// Fused RMSNorm + absmax int8 quant (the paper's RMS-MAX unit) for Hopper.
//
// Replaces: src/repro/kernels/rmsnorm_quant/kernel.py::rmsnorm_quant_kernel.
// Per row of (m, d) f32 or bf16 x and a (d,) f32 or bf16 norm weight:
// var = mean(x^2) in f32, xn = x * rsqrt(var + eps) * w, amax = max(|xn|,
// 1e-5), scale = amax / 127, q = clip(rint(xn / scale), -127, 127) -> (m, d)
// int8 and (m, 1) f32 scales.
//
// Bound on the card: bytes (one read of x, one write of the int8 codes, a
// few operations per element), a few microseconds at the model's rows.
//
// Design: one block per row.  Pass 1 sums x^2 (block reduction), pass 2
// finds amax of xn, pass 3 recomputes xn with the same operations and
// quantizes; the row stays in L1/L2 between passes, and nothing but the
// codes and the scale is written.  The arithmetic is the plain version's,
// operation for operation (rsqrtf for torch.rsqrt), with a true
// division by the scale (no reciprocal multiply: it moves codes) and rintf
// (round half to even, as torch.round and jnp.round).  Only the order of
// the sum of squares differs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
rmsnorm_quant_kernel(const TX* __restrict__ x, int64_t ldx,
                     const TW* __restrict__ w, int8_t* __restrict__ q,
                     float* __restrict__ scale, int d, float eps) {
  __shared__ float red[WARPS + 1];
  const int64_t row = blockIdx.x;
  const TX* xr = x + row * ldx;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float v = repro::to_float(xr[i]);
    ss += v * v;
  }
  const float var =
      repro::block_reduce<WARPS, false>(ss, red) / static_cast<float>(d);
  const float rs = rsqrtf(var + eps);

  float amax = 0.0f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float xn = repro::to_float(xr[i]) * rs * repro::to_float(w[i]);
    amax = fmaxf(amax, fabsf(xn));
  }
  amax = fmaxf(repro::block_reduce<WARPS, true>(amax, red), 1e-5f);
  const float sc = amax / 127.0f;

  int8_t* qr = q + row * d;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float xn = repro::to_float(xr[i]) * rs * repro::to_float(w[i]);
    qr[i] = static_cast<int8_t>(
        fminf(fmaxf(rintf(xn / sc), -127.0f), 127.0f));
  }
  if (threadIdx.x == 0) scale[row] = sc;
}

template <typename TX, typename TW>
void launch(const void* x, int64_t ldx, const void* w, void* q, void* scale,
            int m, int d, float eps, cudaStream_t stream) {
  rmsnorm_quant_kernel<TX, TW><<<m, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), ldx, static_cast<const TW*>(w),
      static_cast<int8_t*>(q), static_cast<float*>(scale), d, eps);
}

}  // namespace

// x: (m, d) f32 (x_bf16 = 0) or bf16 (1), row stride ldx, unit stride along
// d; w: (d,) f32 or bf16 (w_bf16); q: (m, d) int8 contiguous; scale: (m,)
// f32.
REPRO_API int rmsnorm_quant_launch(const void* x, int64_t ldx, const void* w,
                                   void* q, void* scale, int m, int d,
                                   float eps, int x_bf16, int w_bf16,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    launch<bf16, bf16>(x, ldx, w, q, scale, m, d, eps, st);
  else if (x_bf16)
    launch<bf16, float>(x, ldx, w, q, scale, m, d, eps, st);
  else if (w_bf16)
    launch<float, bf16>(x, ldx, w, q, scale, m, d, eps, st);
  else
    launch<float, float>(x, ldx, w, q, scale, m, d, eps, st);
  return static_cast<int>(cudaGetLastError());
}
