// Causal GQA flash attention for prompt prefill and chunked prefill, on a
// contiguous or a paged cache.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py::_flash_kernel (the
// pallas_call in flash_prefill_pallas), ::_chunk_kernel (the pallas_call
// in flash_chunk_prefill_pallas) and ::_paged_chunk_kernel (the pallas_call
// in flash_chunk_prefill_paged_pallas).  All compute, per (batch, head) and
// per query row at absolute position p, the online softmax over keys at
// positions <= p (and > p - window with a sliding window), in f32, with the
// JAX kernels' constants: masked scores -1e30, denominator floor 1e-30,
// scale = d**-0.5 passed in by the wrapper.  The prompt kernel is the chunk
// kernel with every row offset 0 and no separate chunk operand.
//
// The chunk kernels take their keys from two operands, as the JAX model
// feeds its chunk kernel the cache cast to f32 with the chunk's own span
// overlaid by its fresh f32 K/V: keys in [start, start + t) of row b come
// from the chunk's fresh K/V (f32, t rows), every other key from the cache
// (bf16 or f32), where start = offset[b] clamped to [0, S - t] as the
// cache write clamps it.  So the whole cache is never cast or copied.  The
// cache is contiguous rows (b, kv_h, S, d) or, in the paged form, a
// (P, ps, kv_h, d) page pool read through a (b, n_pages) block table, key j
// of row b in page bt[b, j / ps] at row j % ps (S = n_pages * ps).  Cache
// keys at or past offset[b] + t are never attended and never read, so stale
// page slack and dead table entries stay unread.
//
// Bound on the card: at serving shapes (<= 128 query rows per head, head dim
// 64, a few hundred keys) the work is a few MFLOP per head and the operands
// a few hundred KB, so launch latency and the f32 CUDA-core arithmetic bound
// it; the tensor cores are not used (f32 operands, as the JAX kernels).
//
// Design: one block per (query tile of BQ rows, head, batch row); the
// sequential KV grid axis of the TPU kernel becomes a loop inside the block.
// Each KV tile is staged once in shared memory (converted to f32, taken from
// the cache or the chunk operand key by key) and shared by the block's four
// warps, each of which owns BQ/4 query rows: lanes split the tile's keys for
// the scores and the head dim for the output accumulator, and the per-row
// (m, l, acc) state stays in registers, so no score ever reaches device
// memory.  Tiles entirely above the causal frontier of the block's last row,
// or entirely left of the window, are skipped (the offset is read at run
// time, as the TPU kernel's scalar-prefetched offset).  The tiles walk
// logical key positions; only the staging asks the storage (ContigKV or
// PagedKV, common.cuh) where a key's row lies, so the paged form stages the
// same tiles as the contiguous one and gives its numbers bit for bit, for
// any page size (a tile may span pages: each key finds its own).  GQA reads
// KV head h / (h / kv_h) directly; every operand is addressed through
// strides, so the (b, S, kv_h, d) cache layout is read in place.
#include "common.cuh"

namespace {

using repro::L_FLOOR;
using repro::NEG_INF;

constexpr int BQ = 16;         // query rows per block
constexpr int WARPS = 4;       // BQ / WARPS rows per warp
constexpr int ROWS = BQ / WARPS;

template <int D>
struct Tile {
  static constexpr int BKV = D <= 64 ? 64 : 32;   // keys per staged tile
  static constexpr int KPL = BKV / 32;            // keys per lane
  static constexpr int DPL = D / 32;              // head dims per lane
};

struct Strides {   // element strides of a (batch, head, row, d) operand
  int64_t b, h, s;
};

template <int D, typename Src>
__global__ void __launch_bounds__(WARPS * 32)
flash_attn_kernel(const float* __restrict__ q, Strides qs, Src k, Src v,
                  const float* __restrict__ kn, Strides kns,
                  const float* __restrict__ vn, Strides vns,
                  float* __restrict__ out, const int* __restrict__ offset,
                  int h, int kv_h, int t, int S, float scale, int window) {
  constexpr int BKV = Tile<D>::BKV, KPL = Tile<D>::KPL, DPL = Tile<D>::DPL;
  __shared__ float q_s[BQ][D];
  __shared__ float k_s[BKV][D + 1];   // +1: lanes read distinct keys conflict-free
  __shared__ float v_s[BKV][D];

  const int qi = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kvh = hh / (h / kv_h);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int off = offset != nullptr ? offset[bi] : 0;
  const int q_row0 = qi * BQ;             // chunk-local index of row 0
  const int q_start = off + q_row0;       // absolute position of row 0

  // keys [f0, f0 + t) come from the chunk operand (none: f0 = S); no row
  // attends a key at or past off + t
  const int f0 = kn != nullptr ? min(max(off, 0), S - t) : S;
  const int live_end = off + t;

  const float* qb = q + bi * qs.b + hh * qs.h;
  const auto k_rows = k.rows(bi, kvh);
  const auto v_rows = v.rows(bi, kvh);
  const float* knb = kn != nullptr ? kn + bi * kns.b + kvh * kns.h : nullptr;
  const float* vnb = vn != nullptr ? vn + bi * vns.b + kvh * vns.h : nullptr;

  for (int idx = tid; idx < BQ * D; idx += WARPS * 32) {
    const int r = idx / D, d = idx % D;
    q_s[r][d] = (q_row0 + r < t) ? qb[(q_row0 + r) * qs.s + d] : 0.f;
  }

  float m_r[ROWS], l_r[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m_r[rr] = NEG_INF;
    l_r[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[rr][e] = 0.f;
  }

  // causal frontier of the tile's last row; window: first live key of row 0
  const int k_end = min(S, q_start + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, (q_start - window + 1) / BKV * BKV);

  for (int k_start = k_begin; k_start < k_end; k_start += BKV) {
    __syncthreads();  // previous tile fully consumed
    if (k_start + BKV <= min(S, f0)) {    // block-uniform: all from the cache
      for (int idx = tid; idx < BKV * D; idx += WARPS * 32) {
        const int r = idx / D, d = idx % D;
        k_s[r][d] = k_rows(k_start + r)[d];
        v_s[r][d] = v_rows(k_start + r)[d];
      }
    } else {
      // predicated loads, no branch: one of the two terms is zero (keys
      // past the row or past every row's causal reach read as zeros)
      for (int idx = tid; idx < BKV * D; idx += WARPS * 32) {
        const int r = idx / D, d = idx % D;
        const int key = k_start + r;
        const bool in = key < S;
        const bool fresh = in && key >= f0 && key < f0 + t;
        const bool cached = in && !fresh && key < live_end;
        const int64_t kf = key - f0;
        k_s[r][d] = (fresh ? knb[kf * kns.s + d] : 0.f) +
                    (cached ? k_rows(key)[d] : 0.f);
        v_s[r][d] = (fresh ? vnb[kf * vns.s + d] : 0.f) +
                    (cached ? v_rows(key)[d] : 0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      if (q_row0 + r >= t) continue;      // padded query row: never written
      const int qpos = q_start + r;
      float s[KPL];
      bool live[KPL];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kr = lane + 32 * j;
        const int key = k_start + kr;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += q_s[r][d] * k_s[kr][d];
        live[j] = key < S && key <= qpos && (window <= 0 || key > qpos - window);
        s[j] = live[j] ? dot * scale : NEG_INF;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_r[rr], repro::warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        s[j] = live[j] ? expf(s[j] - m_new) : 0.f;   // s now holds p
        psum += s[j];
      }
      const float alpha = expf(m_r[rr] - m_new);
      l_r[rr] = l_r[rr] * alpha + repro::warp_sum(psum);
      float pv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) pv[e] = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        for (int src = 0; src < 32; ++src) {
          const float p = __shfl_sync(0xffffffffu, s[j], src);
          const int kr = src + 32 * j;
#pragma unroll
          for (int e = 0; e < DPL; ++e) pv[e] += p * v_s[kr][lane + 32 * e];
        }
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[rr][e] = acc[rr][e] * alpha + pv[e];
      m_r[rr] = m_new;
    }
  }

  float* ob = out + ((static_cast<int64_t>(bi) * h + hh) * t) * D;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    if (q_row0 + r >= t) continue;
    const float inv = 1.f / fmaxf(l_r[rr], L_FLOOR);
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      ob[static_cast<int64_t>(q_row0 + r) * D + lane + 32 * e] = acc[rr][e] * inv;
  }
}

Strides strides_of(const int64_t* st) {
  return st != nullptr ? Strides{st[0], st[1], st[2]} : Strides{0, 0, 0};
}

template <typename Src>
int launch(int d, const float* q, const int64_t* qs, Src k, Src v,
           const float* kn, const int64_t* kns, const float* vn,
           const int64_t* vns, float* out, const int* offset, int b, int h,
           int kv_h, int t, int S, float scale, int window,
           cudaStream_t stream) {
  if ((kn == nullptr) != (vn == nullptr) || (kn != nullptr && t > S))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t + BQ - 1) / BQ, h, b);
  const Strides QS = strides_of(qs), KNS = strides_of(kns),
                VNS = strides_of(vns);
  switch (d) {
    case 32: flash_attn_kernel<32, Src><<<grid, WARPS * 32, 0, stream>>>(q, QS, k, v, kn, KNS, vn, VNS, out, offset, h, kv_h, t, S, scale, window); break;
    case 64: flash_attn_kernel<64, Src><<<grid, WARPS * 32, 0, stream>>>(q, QS, k, v, kn, KNS, vn, VNS, out, offset, h, kv_h, t, S, scale, window); break;
    case 128: flash_attn_kernel<128, Src><<<grid, WARPS * 32, 0, stream>>>(q, QS, k, v, kn, KNS, vn, VNS, out, offset, h, kv_h, t, S, scale, window); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
repro::ContigKV<KV> contig(const void* p, const int64_t* st) {
  return {static_cast<const KV*>(p), st[0], st[1], st[2]};
}

template <typename KV>
repro::PagedKV<KV> paged(const void* p, const int64_t* st, const int* bt,
                         int64_t bt_s, int ps) {
  return {static_cast<const KV*>(p), st[0], st[1], st[2], nullptr, 0, 0, 0,
          bt, bt_s, ps};
}

}  // namespace

// q: (b, h, t, d) f32 with element strides qs = (batch, head, row); k, v:
// (b, kv_h, S, d), bf16 (kv_bf16 = 1) or f32, with strides ks, vs; kn, vn:
// the chunk's fresh keys and values (b, kv_h, t, d) f32 with strides kns,
// vns, or null (the prompt kernel: every key from k, v); last dims
// contiguous.  out: (b, h, t, d) f32 contiguous.  offset: (b,) int32
// absolute position of each row's first query, or null for all zeros.
// window <= 0 means no sliding window.
REPRO_API int flash_attn_launch(const void* q, const int64_t* qs,
                                const void* k, const int64_t* ks,
                                const void* v, const int64_t* vs,
                                const void* kn, const int64_t* kns,
                                const void* vn, const int64_t* vns,
                                void* out, const void* offset, int b, int h,
                                int kv_h, int t, int S, int d, float scale,
                                int window, int kv_bf16, void* stream) {
  auto Q = static_cast<const float*>(q);
  auto KN = static_cast<const float*>(kn);
  auto VN = static_cast<const float*>(vn);
  auto O = static_cast<float*>(out);
  auto off = static_cast<const int*>(offset);
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch(d, Q, qs, contig<__nv_bfloat16>(k, ks),
                  contig<__nv_bfloat16>(v, vs), KN, kns, VN, vns, O, off, b,
                  h, kv_h, t, S, scale, window, st);
  return launch(d, Q, qs, contig<float>(k, ks), contig<float>(v, vs), KN, kns,
                VN, vns, O, off, b, h, kv_h, t, S, scale, window, st);
}

// The paged chunk form: as above with the cache a (P, ps, kv_h, d) pool,
// element strides ks, vs = (page, row, head), bf16 (kv_bf16 = 1) or f32,
// read through bt: (b, n_pages) int32 with row stride bt_s (S = n_pages *
// ps; dead entries name page 0).  kn, vn and offset are required.
REPRO_API int flash_attn_paged_launch(
    const void* q, const int64_t* qs, const void* k, const int64_t* ks,
    const void* v, const int64_t* vs, const void* bt, int64_t bt_s,
    const void* kn, const int64_t* kns, const void* vn, const int64_t* vns,
    void* out, const void* offset, int b, int h, int kv_h, int t,
    int n_pages, int ps, int d, float scale, int window, int kv_bf16,
    void* stream) {
  if (kn == nullptr || offset == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto Q = static_cast<const float*>(q);
  auto KN = static_cast<const float*>(kn);
  auto VN = static_cast<const float*>(vn);
  auto O = static_cast<float*>(out);
  auto off = static_cast<const int*>(offset);
  auto T = static_cast<const int*>(bt);
  auto st = static_cast<cudaStream_t>(stream);
  const int S = n_pages * ps;
  if (kv_bf16)
    return launch(d, Q, qs, paged<__nv_bfloat16>(k, ks, T, bt_s, ps),
                  paged<__nv_bfloat16>(v, vs, T, bt_s, ps), KN, kns, VN, vns,
                  O, off, b, h, kv_h, t, S, scale, window, st);
  return launch(d, Q, qs, paged<float>(k, ks, T, bt_s, ps),
                paged<float>(v, vs, T, bt_s, ps), KN, kns, VN, vns, O, off, b,
                h, kv_h, t, S, scale, window, st);
}
