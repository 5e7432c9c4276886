// Fused RMSNorm + absmax int8 quant (the paper's RMS-MAX unit) for Hopper.
//
// Replaces: src/repro/kernels/rmsnorm_quant/kernel.py::rmsnorm_quant_kernel.
// Per row of (m, d) f32 or bf16 x and a (d,) f32 or bf16 norm weight:
// var = sum(x^2) * (1/d) in f32, xn = x * rsqrt(var + eps) * w, amax =
// max(|xn|, 1e-5), scale = amax * (1/127), q = clip(rint(xn / scale), -127,
// 127) -> (m, d) int8 and (m, 1) f32 scales.
//
// Bound on the card: bytes (one read of x and w, one write of the codes),
// 0.01-0.3 us at the model's rows: far below one launch.  What a call
// costs is its chain of dependent latencies: a load's round trip, each
// reduction's steps and barriers, the divisions of the quantization.
//
// Design (kernels/rmsnorm_quant/plan.py): one block a row, a row cut into
// chunks of 8 values, thread t holding chunk t in registers from load to
// store (warps = ceil(chunks / 32), for d <= 8192).  A thread's loads of x
// and w are all issued before the first use (16 bytes a load where the
// rows are aligned, else the scalar instantiation reads the same chunk),
// nothing is read twice, the sum of squares and then the maximum reduce by
// xor shuffles with one shared-memory exchange each when a row spans
// warps, and each chunk's codes leave in one 8-byte store.  The warps are
// a function of d, so the sum runs in an order fixed by d alone (the
// plan's `sum_of_squares` replays it): a row gives the same bits whatever
// m and the load width.  The arithmetic is the plain version's (the JAX
// package's as it runs jitted): products rounded before each add, the
// mean as a product by 1/d, rsqrtf for torch.rsqrt, x * rs * w in that
// order, the scale as a product by f32(1/127), a true division by it and
// rintf (round half to even).
//
// Wider rows (d > 8192) take the kernel's LOOP instantiation: 1024
// threads, thread t walking chunks t, t + 1024, ... from global memory
// three times (the sum of squares in that order, then the maximum of xn,
// then the codes, xn computed again to the same bits).  The row stays in
// L1/L2 between the walks; rows at or below 8192 compile without the loop.
#include "common.cuh"

namespace {

constexpr int CHUNK = 8;
constexpr int MAX_THREADS = 1024;

// One chunk of x or w into 8 floats (zeros past d).
template <bool VEC>
__device__ __forceinline__ void load_chunk(const float* row, int c, int d,
                                           float (&v)[CHUNK]) {
  if constexpr (VEC) {
    const float4* p = reinterpret_cast<const float4*>(row + c * CHUNK);
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int e = c * CHUNK + j;
      v[j] = e < d ? row[e] : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* row, int c,
                                           int d, float (&v)[CHUNK]) {
  if constexpr (VEC) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + c * CHUNK);
    const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 bits are a float's upper half
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int e = c * CHUNK + j;
      v[j] = e < d ? __bfloat162float(row[e]) : 0.f;
    }
  }
}

__device__ __forceinline__ unsigned code(float xn, float sc) {
  return static_cast<uint8_t>(static_cast<int8_t>(
      fminf(fmaxf(rintf(xn / sc), -127.0f), 127.0f)));
}

// Sum of squares of a chunk in order, each square rounded before it is
// added (no fused multiply-add).
__device__ __forceinline__ void add_squares(float& ss,
                                            const float (&v)[CHUNK]) {
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
}

// v <- v * rs * w in that order, amax <- max(amax, |v|).
__device__ __forceinline__ void normalize(float (&v)[CHUNK],
                                          const float (&wv)[CHUNK], float rs,
                                          float& amax) {
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    v[j] = __fmul_rn(__fmul_rn(v[j], rs), wv[j]);
    amax = fmaxf(amax, fabsf(v[j]));
  }
}

// The codes of chunk c of the row: one 8-byte store, or one a value.
template <bool VEC>
__device__ __forceinline__ void store_codes(int8_t* qr, int c, int d,
                                            const float (&v)[CHUNK],
                                            float sc) {
  if constexpr (VEC) {
    uint2 out;
    out.x = code(v[0], sc) | code(v[1], sc) << 8 | code(v[2], sc) << 16 |
            code(v[3], sc) << 24;
    out.y = code(v[4], sc) | code(v[5], sc) << 8 | code(v[6], sc) << 16 |
            code(v[7], sc) << 24;
    reinterpret_cast<uint2*>(qr)[c] = out;
  } else {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int e = c * CHUNK + j;
      if (e < d) qr[e] = static_cast<int8_t>(code(v[j], sc));
    }
  }
}

// Block b normalizes and quantizes row b.  Thread t holds chunk t in
// registers from load to store; with LOOP (d > CHUNK * MAX_THREADS) it
// walks the chunks t, t + T, ... from global memory three times instead.
template <typename TX, typename TW, bool VEC, bool LOOP>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_quant_kernel(const TX* __restrict__ x, int64_t ldx,
                     const TW* __restrict__ w, int8_t* __restrict__ q,
                     float* __restrict__ scale, int d, float eps) {
  __shared__ float red_ss[32], red_max[32];   // one slot a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, T = blockDim.x, t = threadIdx.x;
  const int nc = (d + CHUNK - 1) / CHUNK;
  const int64_t row = blockIdx.x;
  const TX* xr = x + row * ldx;
  const bool live = t < nc;
  const float inv_d = __frcp_rn(static_cast<float>(d));   // f32(1/d)

  // sum of squares: a thread's chunks in order, then the butterfly, then
  // the warps in warp order
  float v[CHUNK], wv[CHUNK], ss = 0.f;
  if constexpr (LOOP) {
    for (int c = t; c < nc; c += T) {
      load_chunk<VEC>(xr, c, d, v);
      add_squares(ss, v);
    }
  } else {
    if (live) {
      load_chunk<VEC>(xr, t, d, v);
      load_chunk<VEC>(w, t, d, wv);
    } else {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) v[j] = wv[j] = 0.f;
    }
    add_squares(ss, v);
  }
  ss = repro::warp_sum(ss);
  if (warps > 1) {
    if (lane == 0) red_ss[warp] = ss;
    __syncthreads();
    ss = red_ss[0];
    for (int i = 1; i < warps; ++i) ss = __fadd_rn(ss, red_ss[i]);
  }
  const float var = __fmul_rn(ss, inv_d);
  const float rs = rsqrtf(__fadd_rn(var, eps));

  float amax = 0.f;
  if constexpr (LOOP) {
    for (int c = t; c < nc; c += T) {
      load_chunk<VEC>(xr, c, d, v);
      load_chunk<VEC>(w, c, d, wv);
      normalize(v, wv, rs, amax);
    }
  } else {
    normalize(v, wv, rs, amax);
  }
  amax = repro::warp_max(amax);
  if (warps > 1) {
    if (lane == 0) red_max[warp] = amax;
    __syncthreads();
    amax = red_max[0];
    for (int i = 1; i < warps; ++i) amax = fmaxf(amax, red_max[i]);
  }
  const float sc = __fmul_rn(fmaxf(amax, 1e-5f), 1.0f / 127.0f);
  if (t == 0) scale[row] = sc;

  int8_t* qr = q + row * d;
  if constexpr (LOOP) {
    float unused = 0.f;
    for (int c = t; c < nc; c += T) {   // xn again, to the same bits
      load_chunk<VEC>(xr, c, d, v);
      load_chunk<VEC>(w, c, d, wv);
      normalize(v, wv, rs, unused);
      store_codes<VEC>(qr, c, d, v, sc);
    }
  } else if (live) {
    store_codes<VEC>(qr, t, d, v, sc);
  }
}

template <typename TX, typename TW>
int launch(const void* x, int64_t ldx, const void* w, void* q, void* scale,
           int m, int d, float eps, int vec, cudaStream_t st) {
  if (vec && !(d % CHUNK == 0 &&
               repro::aligned16(x, {ldx * int64_t(sizeof(TX))}) &&
               repro::aligned16(w, {})))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = d > CHUNK * MAX_THREADS;
  const int threads =
      wide ? MAX_THREADS : 32 * ((d + 32 * CHUNK - 1) / (32 * CHUNK));
  const auto kernel =
      wide ? (vec ? rmsnorm_quant_kernel<TX, TW, true, true>
                  : rmsnorm_quant_kernel<TX, TW, false, true>)
           : (vec ? rmsnorm_quant_kernel<TX, TW, true, false>
                  : rmsnorm_quant_kernel<TX, TW, false, false>);
  kernel<<<m, threads, 0, st>>>(
      static_cast<const TX*>(x), ldx, static_cast<const TW*>(w),
      static_cast<int8_t*>(q), static_cast<float*>(scale), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, d) f32 (x_bf16 = 0) or bf16 (1), row stride ldx, unit stride along
// d, d > 0 (one chunk a thread to 8192, the LOOP instantiation past that); w:
// (d,) f32 or bf16 (w_bf16); q: (m, d) int8
// contiguous; scale: (m,) f32.  vec: 16-byte loads (the rows and w must
// then start on 16 bytes and d be a multiple of 8).  A call the kernel does
// not take returns cudaErrorInvalidValue.
REPRO_API int rmsnorm_quant_launch(const void* x, int64_t ldx, const void* w,
                                   void* q, void* scale, int m, int d,
                                   float eps, int x_bf16, int w_bf16,
                                   int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16 && w_bf16)
    return launch<bf16, bf16>(x, ldx, w, q, scale, m, d, eps, vec, st);
  if (x_bf16)
    return launch<bf16, float>(x, ldx, w, q, scale, m, d, eps, vec, st);
  if (w_bf16)
    return launch<float, bf16>(x, ldx, w, q, scale, m, d, eps, vec, st);
  return launch<float, float>(x, ldx, w, q, scale, m, d, eps, vec, st);
}
