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
// page slack and dead table entries stay unread: their staged rows are
// written as zeros (a masked key still multiplies in a tensor-core tile, and
// 0 * NaN would poison P.V).
//
// Bound on the card: at serving shapes (<= 128 query rows per head, head dim
// 64, a few hundred keys) the work is a few MFLOP per head and the operands
// a few hundred KB, far below both of the card's rates; the time is launch
// latency plus the longest block's chain of dependent steps (copy, products,
// softmax) over its keys.  The first design walked each block's keys one
// tile after another on CUDA cores, about 10 us a 64-key tile.  In this
// one a 16-key tile's 96 mma sit among many times as many other
// instructions a warp (TF32 splits, fragment loads, masks, the softmax),
// so with 16 warps to an SM the SM's instruction issue, not its tensor
// cores, sets the step; the plan trades warps (parallel steps) against
// each warp's fixed work.
//
// Design, for that chain:
// - Products on the tensor cores in f32-class precision ("3xTF32", as
//   CUTLASS's OpMultiplyAddFastF32): each f32 operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi) (rounded as cvt.rna.tf32.f32 does),
//   and mma.sync.m16n8k8 accumulates lo*hi + hi*lo + hi*hi in f32, small
//   terms first (Q.K^T in two accumulators, even and odd k8 steps, added
//   at the end: half the chain of dependent products).  A bf16 row
//   is exact in TF32 (lo = 0), so a tile holding only bf16 cache rows skips
//   the product with the K or V remainder (adding +0 changes no bit).  One
//   warp owns the block's 16 query rows, the m16 of the instruction; S = Q.K^T
//   and O += P.V stay in register fragments (FlashAttention-2 style), P
//   taken from S's accumulator layout by permuting the keys of each k8 step
//   (column c of the A fragment is key 2c or 2c - 7), which V's fragments
//   read in the same order.  A row's max and sum take two quad shuffles.
// - The block's keys are split across its warps: warp w walks the key tiles
//   whose absolute index is w modulo the warp count, each warp with its own
//   (m, l, acc); the warps merge once in shared memory by log-sum-exp, in
//   warp order.  A warp with no live key holds m = -1e30, l = 0 and
//   contributes exactly 0.  Which tile and warp a key falls to depends on
//   its absolute position alone, never on the query tile or the offset, so
//   a prompt and any chunking of it (f32 rows) give the same bits.
// - Each key's row is resolved once a tile, not per element: one lane per
//   key works out its source (a fresh chunk row, a cache row or, paged,
//   row j % ps of page bt[j / ps]; null for a dead key) into the warp's
//   shared memory, and the copies then move 16 bytes a thread with cp.async
//   in the row's own type (4 f32 or 8 bf16 values), a bf16 tile widened to
//   f32 at the fragment load; dead rows are stored as zeros.  The one or
//   two tiles a chunk's fresh f32 rows fall in are staged as f32, their
//   bf16 cache rows widened on the way.  A warp's first tile copies while
//   the query tile is split; each later one after the tile before it has
//   multiplied (a warp walks one or two 16-key tiles at serving shapes, and
//   a second stage lost on the card).
// Tiles wholly above the causal frontier of the block's last row, or wholly
// left of the window, are skipped (the offset is read at run time, as the
// TPU kernel's scalar-prefetched offset).  The tiles walk logical key
// positions; only the staging asks the storage (ContigKV or PagedKV,
// common.cuh) where a key's row lies, so the paged form stages the same
// tiles as the contiguous one and gives its numbers bit for bit, for any
// page size.  GQA reads KV head h / (h / kv_h) directly; every operand is
// addressed through strides, so the (b, S, kv_h, d) cache layout is read in
// place.  The warps a block come from the wrapper (kernels/flash_prefill/
// plan.py, by head dim).
#include <type_traits>

#include "common.cuh"

namespace {

using repro::L_FLOOR;
using repro::NEG_INF;

constexpr int BQ = 16;            // query rows of a block: the m16 of mma
constexpr int BK = 16;            // keys a tile (a lane resolves each key)
constexpr int MAX_WARPS = 8;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may take

struct Strides {   // element strides of a (batch, head, row, d) operand
  int64_t b, h, s;
};

// Shared memory of a block (plan.py smem_bytes): the query tile's TF32 high
// and low parts, then per warp the row sources of a tile (K, V pointers)
// and a K and a V tile of rows padded to d + 4 floats (the padding puts a
// fragment load's 32 lanes on 32 banks).
size_t smem_bytes(int d, int warps) {
  const size_t row = (d + 4) * sizeof(float);
  return 2 * BQ * row + warps * (2 * BK * sizeof(void*) + 2 * BK * row);
}

// TF32 rounding as cvt.rna.tf32.f32 does it for finite x: to nearest, ties
// away from zero, the 13 low bits cleared (two integer operations where the
// cvt's SASS guards infinities too)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a * b on one m16n8k8 TF32 tile (f32 accumulators)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

// A staged K or V element and its operand fragments: an f32 row gives its
// 3xTF32 parts; a bf16 row (BF16) is widened, exact in TF32 (lo = 0).
template <bool BF16>
__device__ __forceinline__ void staged(const float* row, int i, uint32_t& hi,
                                       uint32_t& lo) {
  if constexpr (BF16) {
    hi = static_cast<uint32_t>(
             reinterpret_cast<const unsigned short*>(row)[i]) << 16;
    lo = 0;
  } else {
    split(row[i], hi, lo);
  }
}

// One warp's step over one key tile: S = Q.K^T for the block's 16 rows,
// masked and scaled, the online softmax update of (m, l) and o += P.V.
// Lane (g = lane / 4, tq = lane % 4) holds rows g and g + 8 (index 0, 1 of
// m and l) and, in S, keys 8j + 2tq and 8j + 2tq + 1.
// BF16: the tile's rows are staged as bf16 (no remainder products).
template <int D, bool BF16>
__device__ __forceinline__ void tile_step(
    const float* q_hi, const float* q_lo, const float* k_s, const float* v_s,
    int key0, int qpos0, int S, int window, float scale,
    float (&o)[D / 8][4], float (&m)[2], float (&l)[2]) {
  constexpr int RS = D + 4, NT = BK / 8, DT = D / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;

  // two accumulators a key, over the even and the odd k8 steps (halving the
  // chain of dependent products), each taking small terms first
  float s[NT][4], s2[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DT; ++kd) {
    float (&acc)[NT][4] = kd % 2 == 0 ? s : s2;
    const int c = kd * 8 + tq;
    uint32_t ah[4], al[4];   // A: (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4)
    ah[0] = __float_as_uint(q_hi[g * RS + c]);
    ah[1] = __float_as_uint(q_hi[(g + 8) * RS + c]);
    ah[2] = __float_as_uint(q_hi[g * RS + c + 4]);
    ah[3] = __float_as_uint(q_hi[(g + 8) * RS + c + 4]);
    al[0] = __float_as_uint(q_lo[g * RS + c]);
    al[1] = __float_as_uint(q_lo[(g + 8) * RS + c]);
    al[2] = __float_as_uint(q_lo[g * RS + c + 4]);
    al[3] = __float_as_uint(q_lo[(g + 8) * RS + c + 4]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {   // B: K row 8j + g, dims c and c + 4
      const int r = j * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      staged<BF16>(k_s + r * RS, c, bh0, bl0);
      staged<BF16>(k_s + r * RS, c + 4, bh1, bl1);
      mma(acc[j], al, bh0, bh1);
      if constexpr (!BF16) mma(acc[j], ah, bl0, bl1);
      mma(acc[j], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];

  uint32_t live = 0;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + 2 * tq + (e & 1);
      const int qpos = qpos0 + 8 * (e >> 1);
      const bool ok = key < S && key <= qpos &&
                      (window <= 0 || key > qpos - window);
      s[j][e] = ok ? s[j][e] * scale : NEG_INF;
      live |= static_cast<uint32_t>(ok) << (j * 4 + e);
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    m_new[i] = fmaxf(m[i], mx[i]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // s now holds p
      s[j][e] = (live >> (j * 4 + e)) & 1 ? expf(s[j][e] - m_new[e >> 1])
                                          : 0.f;
      psum[e >> 1] += s[j][e];
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
    alpha[i] = expf(m[i] - m_new[i]);
    l[i] = l[i] * alpha[i] + psum[i];
    m[i] = m_new[i];
  }
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }

  // P.V: A column tq of k-step kk is key 8kk + 2tq, column tq + 4 key
  // 8kk + 2tq + 1 (S's accumulator layout); B rows follow the same keys
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t ph[4], pl[4];
    split(s[kk][0], ph[0], pl[0]);
    split(s[kk][2], ph[1], pl[1]);
    split(s[kk][1], ph[2], pl[2]);
    split(s[kk][3], ph[3], pl[3]);
    const int r0 = kk * 8 + 2 * tq, r1 = r0 + 1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int c = n * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      staged<BF16>(v_s + r0 * RS, c, bh0, bl0);
      staged<BF16>(v_s + r1 * RS, c, bh1, bl1);
      mma(o[n], pl, bh0, bh1);
      if constexpr (!BF16) mma(o[n], ph, bl0, bl1);
      mma(o[n], ph, bh0, bh1);
    }
  }
}

// Stage key tile kt of one warp into k_s, v_s: one lane per key resolves
// its rows (a fresh chunk row, a cache row, or null for a dead key) into the
// warp's `src`, then the lanes copy 16 bytes each, dead rows stored as
// zeros.  A tile of cache rows only is staged in the cache's type with
// cp.async; a tile that holds fresh f32 rows is staged as f32, its bf16
// cache rows widened on the way (only the tiles a chunk's span touches).
// Returns whether the tile is staged as bf16.
template <int D, typename KV, typename Rows>
__device__ __forceinline__ bool stage_tile(
    int kt, float* k_s, float* v_s, const char** src, bool vec, Rows k_rows,
    Rows v_rows, const float* knb, int64_t kn_s, const float* vnb,
    int64_t vn_s, int f0, int t, int S, int live_end) {
  constexpr bool F32 = std::is_same_v<KV, float>;
  constexpr int RS = D + 4;
  const int lane = threadIdx.x % 32;
  __syncwarp();   // the stage's previous tile and the sources are free
  const int key = kt * BK + lane;   // lane r resolves row r
  const char* ks = nullptr;
  const char* vs = nullptr;
  bool fresh = false;
  if (lane < BK && key < S && key < live_end) {
    fresh = key >= f0 && key < f0 + t;
    if (fresh) {
      ks = reinterpret_cast<const char*>(knb + (key - f0) * kn_s);
      vs = reinterpret_cast<const char*>(vnb + (key - f0) * vn_s);
    } else {
      ks = reinterpret_cast<const char*>(k_rows(key).p);
      vs = reinterpret_cast<const char*>(v_rows(key).p);
    }
  }
  if (lane < BK) {
    src[lane] = ks;
    src[BK + lane] = vs;
  }
  const uint32_t fresh_rows = __ballot_sync(0xffffffffu, fresh);
  __syncwarp();
  const bool bf16 = !F32 && fresh_rows == 0;
  if (!vec) {   // an operand not 16-byte aligned: element by element
    for (int idx = lane; idx < BK * D; idx += 32) {
      const int r = idx / D, d = idx % D;
      const bool f = F32 || ((fresh_rows >> r) & 1);
      const char* row[2] = {src[r], src[BK + r]};
      float* dst[2] = {k_s + r * RS, v_s + r * RS};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float val =
            row[x] == nullptr ? 0.f
            : f ? reinterpret_cast<const float*>(row[x])[d]
                : repro::to_float(reinterpret_cast<const KV*>(row[x])[d]);
        if (bf16)
          reinterpret_cast<__nv_bfloat16*>(dst[x])[d] = __float2bfloat16(val);
        else
          dst[x][d] = val;
      }
    }
  } else if (bf16 || F32) {   // rows in the staged type: cp.async
    constexpr int CH = D * static_cast<int>(sizeof(KV)) / 16;
#pragma unroll 4
    for (int i = 0; i < BK * CH / 32; ++i) {
      const int idx = lane + 32 * i, r = idx / CH, c = idx % CH;
      const char* row[2] = {src[r], src[BK + r]};
      float* dst[2] = {k_s + r * RS, v_s + r * RS};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        char* to = reinterpret_cast<char*>(dst[x]) + 16 * c;
        if (row[x] != nullptr)
          cp_async16(to, row[x] + 16 * c);
        else
          *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {   // f32 fresh rows by cp.async, bf16 cache rows widened
    constexpr int CH = D / 4;
#pragma unroll 4
    for (int i = 0; i < BK * CH / 32; ++i) {
      const int idx = lane + 32 * i, r = idx / CH, c = idx % CH;
      const bool f = (fresh_rows >> r) & 1;
      const char* row[2] = {src[r], src[BK + r]};
      float* dst[2] = {k_s + r * RS, v_s + r * RS};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float4* to = reinterpret_cast<float4*>(dst[x] + 4 * c);
        if (row[x] == nullptr) {
          *to = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (f) {
          cp_async16(to, row[x] + 16 * c);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(row[x] + 8 * c);
          *to = make_float4(__uint_as_float(w.x << 16),
                            __uint_as_float(w.x & 0xffff0000u),
                            __uint_as_float(w.y << 16),
                            __uint_as_float(w.y & 0xffff0000u));
        }
      }
    }
  }
  cp_async_commit();   // (empty when nothing was copied asynchronously)
  return bf16;
}

// Registers: at d <= 64 held to 128 a thread, so that two 8-warp blocks
// share an SM (they fit without spilling); at d = 128 up to 255 (held to
// 128 they spill).
template <int D, typename Src>
__global__ void __launch_bounds__(MAX_WARPS * 32, D <= 64 ? 2 : 1)
flash_attn_kernel(const float* __restrict__ q, Strides qs, Src k, Src v,
                  const float* __restrict__ kn, Strides kns,
                  const float* __restrict__ vn, Strides vns,
                  float* __restrict__ out, const int* __restrict__ offset,
                  int h, int kv_h, int t, int S, float scale, int window,
                  bool vec) {
  using KV = typename Src::value_type;
  constexpr bool F32 = std::is_same_v<KV, float>;
  constexpr int RS = D + 4, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int W = blockDim.x / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  float* q_hi = reinterpret_cast<float*>(smem);
  float* q_lo = q_hi + BQ * RS;
  const char** src = reinterpret_cast<const char**>(q_lo + BQ * RS);
  float* tiles0 = reinterpret_cast<float*>(src + W * 2 * BK);
  src += warp * 2 * BK;                 // this warp's K sources, V sources
  const int tile_floats = 2 * BK * RS;
  float* tiles = tiles0 + warp * tile_floats;

  const int qi = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int kvh = hh / (h / kv_h);
  const int off = offset != nullptr ? offset[bi] : 0;
  const int q_row0 = qi * BQ;             // chunk-local index of row 0
  const int q_start = off + q_row0;       // absolute position of row 0

  // keys [f0, f0 + t) come from the chunk operand (none: f0 = S); no row
  // attends a key at or past off + t
  const int f0 = kn != nullptr ? min(max(off, 0), S - t) : S;
  const int live_end = off + t;

  const auto k_rows = k.rows(bi, kvh);
  const auto v_rows = v.rows(bi, kvh);
  const float* knb = kn != nullptr ? kn + bi * kns.b + kvh * kns.h : nullptr;
  const float* vnb = vn != nullptr ? vn + bi * vns.b + kvh * vns.h : nullptr;

  // the query tile: copied raw into q_hi (rows past t as zeros) ...
  const float* qb = q + bi * qs.b + hh * qs.h;
  constexpr int QV = BQ * D / 4;   // 16-byte chunks of the tile
  for (int idx = tid; idx < QV; idx += blockDim.x) {
    const int r = idx / (D / 4), c = 4 * (idx % (D / 4));
    float* dst = q_hi + r * RS + c;
    const float* from = qb + static_cast<int64_t>(q_row0 + r) * qs.s + c;
    if (q_row0 + r >= t) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (vec) {
      cp_async16(dst, from);
    } else {
      *reinterpret_cast<float4*>(dst) =
          make_float4(from[0], from[1], from[2], from[3]);
    }
  }
  cp_async_commit();

  // ... while this warp's first key tile copies.  The block's tiles run
  // from the window's first key of row 0 to the causal frontier of its last
  // row; this warp's are those with kt % W == warp.
  const int k_end = min(min(S, live_end), q_start + BQ);
  const int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  const int kt_begin = k_begin / BK, kt_end = (k_end + BK - 1) / BK;
  int kt = kt_begin + (warp - kt_begin % W + W) % W;
  float* k_s = tiles;
  float* v_s = tiles + BK * RS;
  bool bf16 = false;   // the current tile is staged as bf16
  if (kt < kt_end) {
    bf16 = stage_tile<D, KV>(kt, k_s, v_s, src, vec, k_rows, v_rows, knb,
                             kns.s, vnb, vns.s, f0, t, S, live_end);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  // each thread splits the chunks it copied into TF32 high and low parts
  for (int idx = tid; idx < QV; idx += blockDim.x) {
    const int at = idx / (D / 4) * RS + 4 * (idx % (D / 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      split(q_hi[at + e], hi, lo);
      q_hi[at + e] = __uint_as_float(hi);
      q_lo[at + e] = __uint_as_float(lo);
    }
  }
  __syncthreads();

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (; kt < kt_end; kt += W) {
    cp_async_wait<0>();
    __syncwarp();   // every lane's copies and zero rows are visible
    if (!F32 && bf16)
      tile_step<D, true>(q_hi, q_lo, k_s, v_s, kt * BK, q_start + g, S,
                         window, scale, o, m, l);
    else
      tile_step<D, false>(q_hi, q_lo, k_s, v_s, kt * BK, q_start + g, S,
                          window, scale, o, m, l);
    if (kt + W < kt_end)
      bf16 = stage_tile<D, KV>(kt + W, k_s, v_s, src, vec, k_rows, v_rows,
                               knb, kns.s, vnb, vns.s, f0, t, S, live_end);
  }

  // merge: each warp's (m, l, acc) into its own tile space, then every
  // output by log-sum-exp over the warps in warp order
  __syncwarp();
  float* mo = tiles;   // [BQ][RS] acc, then m[BQ], l[BQ]
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(mo + g * RS + c) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(mo + (g + 8) * RS + c) =
        make_float2(o[n][2], o[n][3]);
  }
  if (tq == 0) {
    mo[BQ * RS + g] = m[0];
    mo[BQ * RS + g + 8] = m[1];
    mo[BQ * RS + BQ + g] = l[0];
    mo[BQ * RS + BQ + g + 8] = l[1];
  }
  __syncthreads();
  float* wgt = q_hi;   // [BQ][MAX_WARPS] weights, then 1 / l of each row
  if (tid < BQ) {
    float mt = NEG_INF;
    for (int w = 0; w < W; ++w)
      mt = fmaxf(mt, tiles0[w * tile_floats + BQ * RS + tid]);
    float lt = 0.f;
    for (int w = 0; w < W; ++w) {
      const float* mw = tiles0 + w * tile_floats + BQ * RS;
      const float e = expf(mw[tid] - mt);
      wgt[tid * MAX_WARPS + w] = e;
      lt += mw[BQ + tid] * e;
    }
    wgt[BQ * MAX_WARPS + tid] = 1.f / fmaxf(lt, L_FLOOR);
  }
  __syncthreads();
  float* ob = out + ((static_cast<int64_t>(bi) * h + hh) * t) * D;
  for (int idx = tid; idx < QV; idx += blockDim.x) {
    const int r = idx / (D / 4), c = 4 * (idx % (D / 4));
    if (q_row0 + r >= t) continue;        // padded query row: never written
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < W; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(
          tiles0 + w * tile_floats + r * RS + c);
      const float e = wgt[r * MAX_WARPS + w];
      acc.x += x.x * e;
      acc.y += x.y * e;
      acc.z += x.z * e;
      acc.w += x.w * e;
    }
    const float inv = wgt[BQ * MAX_WARPS + r];
    *reinterpret_cast<float4*>(ob + static_cast<int64_t>(q_row0 + r) * D + c) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
}

Strides strides_of(const int64_t* st) {
  return st != nullptr ? Strides{st[0], st[1], st[2]} : Strides{0, 0, 0};
}

template <int D, typename Src>
int launch_kernel(dim3 grid, int warps, cudaStream_t stream, const float* q,
                  Strides qs, Src k, Src v, const float* kn, Strides kns,
                  const float* vn, Strides vns, float* out, const int* offset,
                  int h, int kv_h, int t, int S, float scale, int window,
                  bool vec) {
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<D, Src>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  flash_attn_kernel<D, Src><<<grid, warps * 32, smem_bytes(D, warps), stream>>>(
      q, qs, k, v, kn, kns, vn, vns, out, offset, h, kv_h, t, S, scale,
      window, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename Src>
int launch(int d, const float* q, const int64_t* qs, Src k, Src v,
           const float* kn, const int64_t* kns, const float* vn,
           const int64_t* vns, float* out, const int* offset, int b, int h,
           int kv_h, int t, int S, float scale, int window, int warps,
           cudaStream_t stream) {
  if ((kn == nullptr) != (vn == nullptr) || (kn != nullptr && t > S) ||
      warps < 1 || warps > MAX_WARPS ||
      smem_bytes(d, warps) > static_cast<size_t>(MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t + BQ - 1) / BQ, h, b);
  const Strides QS = strides_of(qs), KNS = strides_of(kns),
                VNS = strides_of(vns);
  const bool vec = repro::aligned16(q, {QS.b * 4, QS.h * 4, QS.s * 4}) &&
                   repro::aligned16(k) && repro::aligned16(v) &&
                   repro::aligned16(kn, {KNS.b * 4, KNS.h * 4, KNS.s * 4}) &&
                   repro::aligned16(vn, {VNS.b * 4, VNS.h * 4, VNS.s * 4});
  switch (d) {
    case 32: return launch_kernel<32, Src>(grid, warps, stream, q, QS, k, v, kn, KNS, vn, VNS, out, offset, h, kv_h, t, S, scale, window, vec);
    case 64: return launch_kernel<64, Src>(grid, warps, stream, q, QS, k, v, kn, KNS, vn, VNS, out, offset, h, kv_h, t, S, scale, window, vec);
    case 128: return launch_kernel<128, Src>(grid, warps, stream, q, QS, k, v, kn, KNS, vn, VNS, out, offset, h, kv_h, t, S, scale, window, vec);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// window <= 0 means no sliding window.  warps: warps a block (1-8).
REPRO_API int flash_attn_launch(const void* q, const int64_t* qs,
                                const void* k, const int64_t* ks,
                                const void* v, const int64_t* vs,
                                const void* kn, const int64_t* kns,
                                const void* vn, const int64_t* vns,
                                void* out, const void* offset, int b, int h,
                                int kv_h, int t, int S, int d, float scale,
                                int window, int kv_bf16, int warps,
                                void* stream) {
  auto Q = static_cast<const float*>(q);
  auto KN = static_cast<const float*>(kn);
  auto VN = static_cast<const float*>(vn);
  auto O = static_cast<float*>(out);
  auto off = static_cast<const int*>(offset);
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch(d, Q, qs, contig<__nv_bfloat16>(k, ks),
                  contig<__nv_bfloat16>(v, vs), KN, kns, VN, vns, O, off, b,
                  h, kv_h, t, S, scale, window, warps, st);
  return launch(d, Q, qs, contig<float>(k, ks), contig<float>(v, vs), KN, kns,
                VN, vns, O, off, b, h, kv_h, t, S, scale, window, warps, st);
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
    int warps, void* stream) {
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
                  O, off, b, h, kv_h, t, S, scale, window, warps, st);
  return launch(d, Q, qs, paged<float>(k, ks, T, bt_s, ps),
                paged<float>(v, vs, T, bt_s, ps), KN, kns, VN, vns, O, off, b,
                h, kv_h, t, S, scale, window, warps, st);
}
