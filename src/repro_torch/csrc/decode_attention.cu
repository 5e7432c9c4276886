// Single-token GQA decode attention against a contiguous KV cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel
// (the pallas_call in decode_attention_pallas).  One f32 query per (slot,
// head) against the slot's cache row, keys at positions < cache_len[slot]
// only, online softmax in f32 with the JAX kernel's constants (masked score
// -1e30, denominator floor 1e-30, scale = d**-0.5 from the wrapper).
//
// Bound on the card: bytes.  Each (slot, head) streams cache_len keys and
// values once (2 bytes each in bf16) and does 4*d flops per key, far below
// the card's flop/byte balance, so the ideal time is the live KV bytes over
// the memory rate; at serving shapes (4 slots x 24 heads x <= 256 keys) it
// is a few microseconds, close to launch latency.
//
// Design: one block per (head, slot); its four warps take interleaved tiles
// of 32 keys up to cache_len only (dead positions past the live length are
// never read, the TPU kernel's block skip).  Within a tile the lanes split
// the head dim, so every K and V row is one coalesced 64- or 128-byte read;
// a butterfly sum gives each key's score to all lanes, lane j keeps key j's,
// and the tile's probabilities are broadcast back with shuffles for the V
// sum.  Each warp carries its own (m, l, acc) in registers; the four partial
// states are merged once through shared memory at the end.  The cache is
// read through strides, so the (b, S, kv_h, d) layout needs no transpose
// copy, and bf16 converts to f32 in registers.
#include "common.cuh"

namespace {

using repro::L_FLOOR;
using repro::NEG_INF;

constexpr int WARPS = 4;

template <int D, typename KV>
__global__ void __launch_bounds__(WARPS * 32)
decode_attn_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh,
                   const KV* __restrict__ k, int64_t k_sb, int64_t k_sh,
                   int64_t k_ss, const KV* __restrict__ v, int64_t v_sb,
                   int64_t v_sh, int64_t v_ss, float* __restrict__ out,
                   const int* __restrict__ cache_len, int h, int kv_h, int S,
                   float scale) {
  constexpr int DPL = D / 32;
  __shared__ float m_s[WARPS], l_s[WARPS];
  __shared__ float acc_s[WARPS][D];

  const int hh = blockIdx.x, bi = blockIdx.y;
  const int kvh = hh / (h / kv_h);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_keys = min(cache_len[bi], S);

  const float* qb = q + bi * q_sb + hh * q_sh;
  const KV* kb = k + bi * k_sb + kvh * k_sh;
  const KV* vb = v + bi * v_sb + kvh * v_sh;
  float qr[DPL], acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    qr[e] = qb[lane + 32 * e];
    acc[e] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  for (int k0 = warp * 32; k0 < n_keys; k0 += WARPS * 32) {
    float s_mine = NEG_INF;    // lane j: score of key k0 + j
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + j;
      if (key >= n_keys) break;          // warp-uniform
      const KV* kr = kb + key * k_ss;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) part += qr[e] * repro::to_float(kr[lane + 32 * e]);
      const float dot = repro::warp_sum(part);
      if (lane == j) s_mine = dot * scale;
    }
    const bool live = k0 + lane < n_keys;
    const float m_new = fmaxf(m, repro::warp_max(s_mine));
    const float p = live ? expf(s_mine - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + repro::warp_sum(p);
    float pv[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) pv[e] = 0.f;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + j;
      if (key >= n_keys) break;
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const KV* vr = vb + key * v_ss;
#pragma unroll
      for (int e = 0; e < DPL; ++e) pv[e] += pj * repro::to_float(vr[lane + 32 * e]);
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] = acc[e] * alpha + pv[e];
    m = m_new;
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc_s[warp][lane + 32 * e] = acc[e];
  __syncthreads();
  if (warp != 0) return;
  float mm = m_s[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, m_s[w]);
  float lt = 0.f, o[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) o[e] = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float c = expf(m_s[w] - mm);
    lt += l_s[w] * c;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] += acc_s[w][lane + 32 * e] * c;
  }
  const float inv = 1.f / fmaxf(lt, L_FLOOR);
  float* ob = out + (static_cast<int64_t>(bi) * h + hh) * D;
#pragma unroll
  for (int e = 0; e < DPL; ++e) ob[lane + 32 * e] = o[e] * inv;
}

template <int D, typename KV>
void launch(const float* q, const int64_t* qs, const void* k,
            const int64_t* ks, const void* v, const int64_t* vs, float* out,
            const int* cache_len, int b, int h, int kv_h, int S, float scale,
            cudaStream_t stream) {
  dim3 grid(h, b);
  decode_attn_kernel<D, KV><<<grid, WARPS * 32, 0, stream>>>(
      q, qs[0], qs[1], static_cast<const KV*>(k), ks[0], ks[1], ks[2],
      static_cast<const KV*>(v), vs[0], vs[1], vs[2], out, cache_len, h, kv_h,
      S, scale);
}

template <int D>
void launch_d(const float* q, const int64_t* qs, const void* k,
              const int64_t* ks, const void* v, const int64_t* vs, float* out,
              const int* cache_len, int b, int h, int kv_h, int S, float scale,
              int kv_bf16, cudaStream_t stream) {
  if (kv_bf16)
    launch<D, __nv_bfloat16>(q, qs, k, ks, v, vs, out, cache_len, b, h, kv_h, S, scale, stream);
  else
    launch<D, float>(q, qs, k, ks, v, vs, out, cache_len, b, h, kv_h, S, scale, stream);
}

}  // namespace

// q: (b, h, 1, d) f32 with element strides qs = (batch, head); k, v:
// (b, kv_h, S, d) bf16 (kv_bf16 = 1) or f32 with strides (batch, head, row),
// last dims contiguous; cache_len: (b,) int32 live lengths.  out: (b, h, d)
// f32 contiguous.
REPRO_API int decode_attn_launch(const void* q, const int64_t* qs,
                                 const void* k, const int64_t* ks,
                                 const void* v, const int64_t* vs, void* out,
                                 const void* cache_len, int b, int h,
                                 int kv_h, int S, int d, float scale,
                                 int kv_bf16, void* stream) {
  auto Q = static_cast<const float*>(q);
  auto O = static_cast<float*>(out);
  auto cl = static_cast<const int*>(cache_len);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: launch_d<32>(Q, qs, k, ks, v, vs, O, cl, b, h, kv_h, S, scale, kv_bf16, st); break;
    case 64: launch_d<64>(Q, qs, k, ks, v, vs, O, cl, b, h, kv_h, S, scale, kv_bf16, st); break;
    case 128: launch_d<128>(Q, qs, k, ks, v, vs, O, cl, b, h, kv_h, S, scale, kv_bf16, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
