// Single-token GQA decode attention against a contiguous or a paged KV
// cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel
// (the pallas_call in decode_attention_pallas), ::_paged_decode_kernel
// (paged_decode_attention_pallas) and ::_paged_decode_quant_kernel
// (paged_decode_attention_quant_pallas).  One f32 query per (slot, head)
// against the slot's keys at positions < cache_len[slot] only (and, with a
// sliding window, >= cache_len[slot] - window), online
// softmax in f32 with the JAX kernels' constants (masked score -1e30,
// denominator floor 1e-30, scale = d**-0.5 from the wrapper).  The paged
// forms read key j of slot b from pool page bt[b, j / ps], row j % ps; the
// int8 form dequantizes each value as f32(bf16(f32(int8) * bf16(scale))),
// the rounding of the JAX paged int8 kernel and of a bf16 dequantized copy.
//
// Bound on the card: bytes.  Each (slot, head) streams cache_len keys and
// values once (2 bytes each in bf16, 1 in int8 plus a 4-byte scale per
// row) and does 4*d flops per key, far below the card's flop/byte balance,
// so the ideal time is the live KV bytes over the memory rate; at serving
// shapes (4 slots x 24 heads x <= 256 keys) it is a few microseconds, close
// to launch latency.
//
// Design: one block per (head, slot); its four warps take interleaved tiles
// of 32 keys up to cache_len only (dead positions past the live length are
// never read, the TPU kernel's block skip).  Within a tile the lanes split
// the head dim, so every K and V row is one coalesced 64- or 128-byte read;
// a butterfly sum gives each key's score to all lanes, lane j keeps key j's,
// and the tile's probabilities are broadcast back with shuffles for the V
// sum.  Each warp carries its own (m, l, acc) in registers; the four partial
// states are merged once through shared memory at the end.  The key walk is
// over logical positions and only the address of a key's row depends on
// the storage (ContigKV or PagedKV, common.cuh): the TPU kernel's one grid
// step per page becomes a table lookup per key, so a paged cache gives the
// contiguous kernel's numbers bit for bit, for any page size, and a dead
// table entry (null page 0) is never read below cache_len.  Contiguous
// caches are read through strides, so the (b, S, kv_h, d) layout needs no
// transpose copy; bf16 and int8 convert to f32 in registers.
#include "common.cuh"

namespace {

using repro::L_FLOOR;
using repro::NEG_INF;

constexpr int WARPS = 4;

// WIN: a sliding window is set.  A separate instantiation, so the
// windowless kernel keeps its code: a compare per key slowed it by 12-17 %
// on an H100 (700 W) at the serving shapes.
template <int D, bool WIN, typename Src>
__global__ void __launch_bounds__(WARPS * 32)
decode_attn_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh,
                   Src k, Src v, float* __restrict__ out,
                   const int* __restrict__ cache_len, int h, int kv_h, int S,
                   float scale, int window) {
  constexpr int DPL = D / 32;
  __shared__ float m_s[WARPS], l_s[WARPS];
  __shared__ float acc_s[WARPS][D];

  const int hh = blockIdx.x, bi = blockIdx.y;
  const int kvh = hh / (h / kv_h);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_keys = min(cache_len[bi], S);
  // sliding window: only keys in [lo, n_keys) are live; tiles stay
  // aligned to 0 and those wholly below lo are skipped
  const int lo = WIN ? max(0, cache_len[bi] - window) : 0;

  const float* qb = q + bi * q_sb + hh * q_sh;
  const auto k_rows = k.rows(bi, kvh);
  const auto v_rows = v.rows(bi, kvh);
  float qr[DPL], acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    qr[e] = qb[lane + 32 * e];
    acc[e] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  for (int k0 = warp * 32; k0 < n_keys; k0 += WARPS * 32) {
    if (WIN && k0 + 32 <= lo) continue;  // warp-uniform
    float s_mine = NEG_INF;    // lane j: score of key k0 + j
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + j;
      if (key >= n_keys) break;          // warp-uniform
      if (WIN && key < lo) continue;
      const auto kr = k_rows(key);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) part += qr[e] * kr[lane + 32 * e];
      const float dot = repro::warp_sum(part);
      if (lane == j) s_mine = dot * scale;
    }
    const bool live = (!WIN || k0 + lane >= lo) && k0 + lane < n_keys;
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
      if (WIN && key < lo) continue;
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const auto vr = v_rows(key);
#pragma unroll
      for (int e = 0; e < DPL; ++e) pv[e] += pj * vr[lane + 32 * e];
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

template <int D, typename Src>
void launch_d(dim3 grid, cudaStream_t stream, const float* q,
              const int64_t* qs, Src k, Src v, float* out,
              const int* cache_len, int h, int kv_h, int S, float scale,
              int window) {
  if (window < 0)
    decode_attn_kernel<D, false, Src><<<grid, WARPS * 32, 0, stream>>>(
        q, qs[0], qs[1], k, v, out, cache_len, h, kv_h, S, scale, window);
  else
    decode_attn_kernel<D, true, Src><<<grid, WARPS * 32, 0, stream>>>(
        q, qs[0], qs[1], k, v, out, cache_len, h, kv_h, S, scale, window);
}

template <typename Src>
int launch(int d, const float* q, const int64_t* qs, Src k, Src v,
           float* out, const int* cache_len, int b, int h, int kv_h, int S,
           float scale, int window, cudaStream_t stream) {
  const dim3 grid(h, b);
  switch (d) {
    case 32: launch_d<32>(grid, stream, q, qs, k, v, out, cache_len, h, kv_h, S, scale, window); break;
    case 64: launch_d<64>(grid, stream, q, qs, k, v, out, cache_len, h, kv_h, S, scale, window); break;
    case 128: launch_d<128>(grid, stream, q, qs, k, v, out, cache_len, h, kv_h, S, scale, window); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
repro::ContigKV<KV> contig(const void* p, const int64_t* st) {
  return {static_cast<const KV*>(p), st[0], st[1], st[2]};
}

template <typename KV>
repro::PagedKV<KV> paged(const void* p, const int64_t* st, const void* sc,
                         const int64_t* sst, const int* bt, int64_t bt_s,
                         int ps) {
  return {static_cast<const KV*>(p), st[0], st[1], st[2],
          static_cast<const float*>(sc), sst ? sst[0] : 0, sst ? sst[1] : 0,
          sst ? sst[2] : 0, bt, bt_s, ps};
}

}  // namespace

// q: (b, h, 1, d) f32 with element strides qs = (batch, head); k, v:
// (b, kv_h, S, d) bf16 (kv_bf16 = 1) or f32 with strides (batch, head, row),
// last dims contiguous; cache_len: (b,) int32 live lengths.  out: (b, h, d)
// f32 contiguous.  window: sliding window (keys at positions >= cache_len -
// window), or -1 for none.
REPRO_API int decode_attn_launch(const void* q, const int64_t* qs,
                                 const void* k, const int64_t* ks,
                                 const void* v, const int64_t* vs, void* out,
                                 const void* cache_len, int b, int h,
                                 int kv_h, int S, int d, float scale,
                                 int window, int kv_bf16, void* stream) {
  auto Q = static_cast<const float*>(q);
  auto O = static_cast<float*>(out);
  auto cl = static_cast<const int*>(cache_len);
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch(d, Q, qs, contig<__nv_bfloat16>(k, ks),
                  contig<__nv_bfloat16>(v, vs), O, cl, b, h, kv_h, S, scale, window, st);
  return launch(d, Q, qs, contig<float>(k, ks), contig<float>(v, vs), O, cl,
                b, h, kv_h, S, scale, window, st);
}

// The paged forms.  k, v: (P, ps, kv_h, d) pools with element strides
// (page, row, head), last dims contiguous, of kv_kind 0 = f32, 1 = bf16 or
// 2 = int8; k_sc, v_sc: for int8, (P, ps, kv_h) f32 scale planes with
// strides (page, row, head), else null; bt: (b, n_pages) int32 block table
// with row stride bt_s (every entry a valid page; dead entries name page
// 0).  Keys at positions < min(cache_len, n_pages * ps) are read.
REPRO_API int decode_attn_paged_launch(
    const void* q, const int64_t* qs, const void* k, const int64_t* ks,
    const void* v, const int64_t* vs, const void* k_sc, const int64_t* kss,
    const void* v_sc, const int64_t* vss, void* out, const void* cache_len,
    const void* bt, int64_t bt_s, int b, int h, int kv_h, int n_pages, int ps,
    int d, float scale, int window, int kv_kind, void* stream) {
  auto Q = static_cast<const float*>(q);
  auto O = static_cast<float*>(out);
  auto cl = static_cast<const int*>(cache_len);
  auto T = static_cast<const int*>(bt);
  auto st = static_cast<cudaStream_t>(stream);
  const int S = n_pages * ps;
  switch (kv_kind) {
    case 0:
      return launch(d, Q, qs, paged<float>(k, ks, nullptr, nullptr, T, bt_s, ps),
                    paged<float>(v, vs, nullptr, nullptr, T, bt_s, ps), O, cl,
                    b, h, kv_h, S, scale, window, st);
    case 1:
      return launch(d, Q, qs,
                    paged<__nv_bfloat16>(k, ks, nullptr, nullptr, T, bt_s, ps),
                    paged<__nv_bfloat16>(v, vs, nullptr, nullptr, T, bt_s, ps),
                    O, cl, b, h, kv_h, S, scale, window, st);
    case 2:
      if (k_sc == nullptr || v_sc == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch(d, Q, qs, paged<int8_t>(k, ks, k_sc, kss, T, bt_s, ps),
                    paged<int8_t>(v, vs, v_sc, vss, T, bt_s, ps), O, cl, b, h,
                    kv_h, S, scale, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
