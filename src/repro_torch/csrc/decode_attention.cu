// Single-token GQA decode attention against a contiguous or a paged KV
// cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel
// (the pallas_call in decode_attention_pallas), ::_paged_decode_kernel
// (paged_decode_attention_pallas) and ::_paged_decode_quant_kernel
// (paged_decode_attention_quant_pallas).  One query per (slot, head), f32
// or bf16 (widened exactly; the output is rounded to the query's type, to
// nearest even, as astype does), against the slot's keys at positions
// < cache_len[slot] only (and, with a sliding window, >= cache_len[slot] -
// window), online softmax in f32 with the JAX kernels' constants (masked
// score -1e30, denominator floor 1e-30, scale = d**-0.5 from the wrapper).
// A windowed contiguous bf16 cache is read as the JAX model reads it there
// (its XLA decode, the Pallas kernel taking no window): the probabilities
// against the row's maximum, rounded to bf16 before P.V (the RP
// instantiation below).
// The paged forms read key j of slot b from pool page bt[b, j / ps], row
// j % ps; the int8 form dequantizes each value as f32(bf16(f32(int8) *
// bf16(scale))), the rounding of the JAX paged int8 kernel and of a bf16
// dequantized copy.
//
// Bound on the card: bytes.  Each (slot, head) streams cache_len keys and
// values once (2 bytes each in bf16, 1 in int8 plus a 4-byte scale per
// row) and does 4*d flops per key, far below the card's flop/byte balance;
// at serving shapes (4 slots x 24 heads x <= 256 keys) that is about a
// microsecond, so the time is launch latency plus the longest chain of
// dependent steps of one (slot, head): a cache_len load, a block-table
// load, a row copy, the scores, the softmax, P.V and the merges.  The first
// design scored a 32-key tile one key at a time (a row load and a 5-level
// butterfly per key, then 32 serial shuffle-and-load steps for P.V), read
// each element through a page lookup, and split a slot's keys over the 4
// warps of one block: about 30 us a call.
//
// Design, for that chain:
// - A tile of 32 keys, one a lane.  Lane j resolves key j's K and V rows
//   once (for a paged cache one block-table load and one division; for
//   int8 its two scales, rounded to bf16), dead keys as null; then the
//   warp copies the tile's rows into shared memory with 16-byte cp.async
//   in the rows' own type (all of a tile's loads in flight at once; dead
//   rows stored as zeros, never loaded).  Operands not 16-byte aligned are
//   copied element by element.
// - Scores without a butterfly per key: lane j dots its own key's row,
//   read from shared memory 16 bytes at a time (rows padded by 16 bytes,
//   so 32 lanes reading 32 rows meet 32 banks), with the query, held in
//   shared memory as f32, broadcast.  A tile then needs one warp_max and
//   one warp_sum.  Four accumulators, element e into e % 4, combined as
//   (a0 + a1) + (a2 + a3).
// - P.V from shared memory: the tile's probabilities go to shared memory,
//   the lanes split the head dim and walk the live rows of the V tile in
//   key order: no global load and no shuffle in the loop.
// - More warps on a slot: the keys of a (slot, head) are split by absolute
//   tile index over the W warps of its block (kernels/decode_attention/
//   plan.py): warp w takes the tiles with kt % W == w.  The warps merge
//   their (m, l, acc) through shared memory in warp order: one launch, no
//   workspace, no atomics.  A warp with no live tile holds (-1e30, 0, 0) and
//   adds exactly 0.  W is a constant of the head dim, so a slot's bits
//   depend on its own keys alone: decoded alone or in a ragged batch, at
//   any S or page size.
// The tiles walk logical key positions and only the staging asks the
// storage (ContigKV or PagedKV, common.cuh) where a row lies, so the paged
// forms give the contiguous kernel's numbers bit for bit for any page size
// (the int8 form those of the contiguous kernel on the bf16 dequantized
// copy: the same f32 values in the same order).  Contiguous caches are read
// through strides, so the (b, S, kv_h, d) layout needs no transpose copy.
#include <type_traits>

#include "common.cuh"

namespace {

using repro::L_FLOOR;
using repro::NEG_INF;

constexpr int TK = 32;            // keys a tile: one a lane
constexpr int MAX_WARPS = 8;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may take

// Bytes of a staged row: the row in its own type and 16 bytes of padding
// (a row stride of 16 mod 128 bytes: 8 lanes reading 16 bytes of 8 rows
// cover the 32 banks).
template <int D, typename KV>
__host__ __device__ constexpr int row_bytes() {
  return D * static_cast<int>(sizeof(KV)) + 16;
}

// Shared memory of a block (plan.py smem_bytes): the f32 query; per warp
// its K and V tiles, the tile's row sources (K, V pointers), V scales and
// probabilities; then each warp's (acc[D], m, l).
template <int D, typename KV>
__host__ __device__ constexpr size_t warp_bytes() {
  return 2 * TK * row_bytes<D, KV>() + 2 * TK * sizeof(void*) +
         2 * TK * sizeof(float);
}

template <int D, typename KV>
size_t smem_bytes(int warps) {
  return D * sizeof(float) + warps * warp_bytes<D, KV>() +
         warps * (D + 2) * sizeof(float);
}

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

// x rounded to bf16 (to nearest even) and widened back: the bits of
// __float2bfloat16_rn for any non-NaN x, in integer operations, which issue
// at four times the rate of the conversion instruction.
__device__ __forceinline__ float round_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// Element i of a chunk of staged values (w: its 32-bit words) as f32: f32
// and bf16 widen; int8 dequantizes with the row's bf16-rounded scale as
// f32(bf16(f32(int8) * scale)).  The int8 byte is widened exactly without
// the conversion instruction: 2^23 + (x + 128) as float bits, less
// 2^23 + 128.
template <typename KV>
__device__ __forceinline__ float elem(const uint32_t* w, int i, float sc) {
  if constexpr (std::is_same_v<KV, float>) {
    return __uint_as_float(w[i]);
  } else if constexpr (std::is_same_v<KV, __nv_bfloat16>) {
    return __uint_as_float(i % 2 == 0 ? w[i / 2] << 16
                                      : w[i / 2] & 0xffff0000u);
  } else {
    const uint32_t biased = w[i / 4] ^ 0x80808080u;   // x + 128 a byte
    const float x = __uint_as_float(__byte_perm(biased, 0x4b000000u,
                                                0x7440 + i % 4)) -
                    8388736.f;
    return round_bf16(x * sc);
  }
}

// N consecutive staged values of type KV from shared memory as f32, in one
// load of N * sizeof(KV) bytes (1-16).
template <typename KV, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float sc,
                                          float (&x)[N]) {
  constexpr int B = N * static_cast<int>(sizeof(KV));
  constexpr int NW = B >= 4 ? B / 4 : 1;
  uint32_t w[NW];
  if constexpr (B == 16) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (B == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x; w[1] = t.y;
  } else if constexpr (B == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (B == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w[0] = *p;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = elem<KV>(w, i, sc);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage key tile kt of one warp: lane j resolves key kt * TK + j's rows
// (null for a dead key: at or past n_keys or below the window's lo) into
// the warp's `src`, its K scale into ksc and its V scale into vsc_s; then
// the lanes copy the live rows into k_s, v_s (16 bytes a cp.async, or
// element by element when an operand is not 16-byte aligned) and store
// zeros for the dead ones.
template <int D, bool WIN, typename KV, typename Rows>
__device__ __forceinline__ void stage_tile(int kt, int n_keys, int lo,
                                           Rows k_rows, Rows v_rows,
                                           unsigned char* k_s,
                                           unsigned char* v_s,
                                           const unsigned char** src,
                                           float* vsc_s, float& ksc,
                                           bool vec) {
  constexpr int RB = row_bytes<D, KV>();
  constexpr int ROW = D * static_cast<int>(sizeof(KV));
  const int lane = threadIdx.x % 32;
  const int key = kt * TK + lane;
  const unsigned char* kp = nullptr;
  const unsigned char* vp = nullptr;
  ksc = 1.f;
  float vsc = 1.f;
  if (key < n_keys && (!WIN || key >= lo)) {
    const auto kr = k_rows(key);
    const auto vr = v_rows(key);
    kp = reinterpret_cast<const unsigned char*>(kr.p);
    vp = reinterpret_cast<const unsigned char*>(vr.p);
    ksc = kr.sc;
    vsc = vr.sc;
  }
  __syncwarp();   // the previous tile's rows, sources and scales are free
  src[lane] = kp;
  src[TK + lane] = vp;
  vsc_s[lane] = vsc;
  __syncwarp();
  if (vec) {
    constexpr int CH = ROW / 16;   // 16-byte chunks a row
#pragma unroll 4
    for (int i = 0; i < CH; ++i) {
      const int idx = lane + 32 * i, r = idx / CH, c = idx % CH;
      const unsigned char* from[2] = {src[r], src[TK + r]};
      unsigned char* to[2] = {k_s + r * RB + 16 * c, v_s + r * RB + 16 * c};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (from[x] != nullptr)
          cp_async16(to[x], from[x] + 16 * c);
        else
          *reinterpret_cast<uint4*>(to[x]) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  } else {   // the elements' bits, as unsigned integers of their size
    using U = std::conditional_t<
        sizeof(KV) == 4, uint32_t,
        std::conditional_t<sizeof(KV) == 2, uint16_t, uint8_t>>;
    for (int idx = lane; idx < TK * D; idx += 32) {
      const int r = idx / D, e = idx % D;
      const unsigned char* from[2] = {src[r], src[TK + r]};
      unsigned char* to[2] = {k_s + r * RB, v_s + r * RB};
#pragma unroll
      for (int x = 0; x < 2; ++x)
        reinterpret_cast<U*>(to[x])[e] =
            from[x] != nullptr ? reinterpret_cast<const U*>(from[x])[e] : U(0);
    }
  }
}

// WIN: a sliding window is set.  A separate instantiation, so the
// windowless kernel keeps its code (a compare per key cost the first
// design 12-17 % on an H100 at 700 W).  QT: the query and output type.
// RP (a contiguous bf16 cache with a window, always): the probabilities are
// taken against the row's global maximum and rounded to bf16 before P.V,
// the denominator summing them unrounded: the JAX model's windowed decode
// read (attention.decode_attention_xla, p.astype(v.dtype)).  A first pass
// over the row's tiles finds the maximum (each warp its own tiles, then
// the block); the second pass is the loop below with the maximum fixed, so
// alpha is 1 and the warps merge at one maximum.
// Grid (h, b); W = blockDim.x / 32 warps a block.
template <int D, bool WIN, bool RP, typename Src, typename QT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
decode_attn_kernel(const QT* __restrict__ q, int64_t q_sb, int64_t q_sh,
                   Src k, Src v, QT* __restrict__ out,
                   const int* __restrict__ cache_len, int h, int kv_h, int S,
                   float scale, int window, bool vec) {
  using KV = typename Src::value_type;
  constexpr int RB = row_bytes<D, KV>();
  constexpr int EPL = D / 32;              // head-dim elements a lane in P.V
  constexpr int QC = 16 / sizeof(KV);      // values a 16-byte row chunk
  extern __shared__ __align__(16) unsigned char smem[];

  const int W = blockDim.x / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hh = blockIdx.x, bi = blockIdx.y;
  const int kvh = hh / (h / kv_h);

  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* wbase = smem + D * sizeof(float) + warp * warp_bytes<D, KV>();
  unsigned char* k_s = wbase;
  unsigned char* v_s = k_s + TK * RB;
  const unsigned char** src =
      reinterpret_cast<const unsigned char**>(v_s + TK * RB);
  float* vsc_s = reinterpret_cast<float*>(src + 2 * TK);
  float* p_s = vsc_s + TK;
  float* st = reinterpret_cast<float*>(smem + D * sizeof(float) +
                                       W * warp_bytes<D, KV>());

  const int cl = cache_len[bi];
  const int n_keys = min(cl, S);
  const int lo = WIN ? max(0, cl - window) : 0;
  const int kt_begin = lo / TK, kt_end = (n_keys + TK - 1) / TK;
  int kt = kt_begin + (warp - kt_begin % W + W) % W;   // the first kt % W == warp

  const auto k_rows = k.rows(bi, kvh);
  const auto v_rows = v.rows(bi, kvh);
  float ksc = 1.f;
  if (kt < kt_end)   // the first tile copies while the query is loaded
    stage_tile<D, WIN, KV>(kt, n_keys, lo, k_rows, v_rows, k_s, v_s, src,
                           vsc_s, ksc, vec);
  const QT* qb = q + bi * q_sb + hh * q_sh;
  for (int e = tid; e < D; e += blockDim.x) q_s[e] = repro::to_float(qb[e]);
  __syncthreads();

  // the score of lane j's key in the staged tile t (NEG_INF when dead):
  // key j's row dotted with the query
  auto score = [&](int t) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    const unsigned char* kr = k_s + lane * RB;
#pragma unroll 4
    for (int c = 0; c < D / QC; ++c) {
      float x[QC];
      load_vals<KV, QC>(kr + 16 * c, ksc, x);
#pragma unroll
      for (int i = 0; i < QC; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + c * QC + i);
        a[0] = fmaf(qv.x, x[i], a[0]);
        a[1] = fmaf(qv.y, x[i + 1], a[1]);
        a[2] = fmaf(qv.z, x[i + 2], a[2]);
        a[3] = fmaf(qv.w, x[i + 3], a[3]);
      }
    }
    const int key = t * TK + lane;
    const bool live = key < n_keys && (!WIN || key >= lo);
    return live ? ((a[0] + a[1]) + (a[2] + a[3])) * scale : NEG_INF;
  };

  float m = NEG_INF, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  if constexpr (RP) {   // the first pass: the row's maximum score
    float mw = NEG_INF;
    for (int t = kt; t < kt_end; t += W) {
      if (t != kt)
        stage_tile<D, WIN, KV>(t, n_keys, lo, k_rows, v_rows, k_s, v_s, src,
                               vsc_s, ksc, vec);
      if (vec) cp_async_wait<0>();
      __syncwarp();
      mw = fmaxf(mw, repro::warp_max(score(t)));
    }
    if (lane == 0) st[warp] = mw;
    __syncthreads();
    for (int w = 0; w < W; ++w) m = fmaxf(m, st[w]);
    __syncthreads();   // st is written again only by the merge
    if (kt + W < kt_end)   // the warp staged later tiles: its first again
      stage_tile<D, WIN, KV>(kt, n_keys, lo, k_rows, v_rows, k_s, v_s, src,
                             vsc_s, ksc, vec);
  }

  while (kt < kt_end) {
    if (vec) cp_async_wait<0>();
    __syncwarp();   // every lane's copies and zero rows are visible
    const int k0 = kt * TK, key = k0 + lane;
    const bool live = key < n_keys && (!WIN || key >= lo);
    const float s = score(kt);
    const float m_new = RP ? m : fmaxf(m, repro::warp_max(s));
    const float p = live ? expf(s - m_new) : 0.f;
    const float alpha = RP ? 1.f : expf(m - m_new);
    l = l * alpha + repro::warp_sum(p);
    m = m_new;
    p_s[lane] = RP ? round_bf16(p) : p;
    __syncwarp();
    // P.V over the tile's rows up to its last live key, in key order
    const int jn = min(TK, n_keys - k0);
    float pv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) pv[e] = 0.f;
    const unsigned char* vr = v_s + lane * EPL * sizeof(KV);
#pragma unroll 8
    for (int j = 0; j < jn; ++j) {
      float x[EPL];
      load_vals<KV, EPL>(vr + j * RB, vsc_s[j], x);
      const float pj = p_s[j];
#pragma unroll
      for (int e = 0; e < EPL; ++e) pv[e] = fmaf(pj, x[e], pv[e]);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = fmaf(acc[e], alpha, pv[e]);
    kt += W;
    if (kt < kt_end)
      stage_tile<D, WIN, KV>(kt, n_keys, lo, k_rows, v_rows, k_s, v_s, src,
                             vsc_s, ksc, vec);
  }

  // the warps' states, merged in warp order
  float* mine = st + warp * (D + 2);
#pragma unroll
  for (int e = 0; e < EPL; ++e) mine[lane * EPL + e] = acc[e];
  if (lane == 0) {
    mine[D] = m;
    mine[D + 1] = l;
  }
  __syncthreads();
  QT* ob = out + (static_cast<int64_t>(bi) * h + hh) * D;
  for (int e = tid; e < D; e += blockDim.x) {
    float mt = NEG_INF;
    for (int w = 0; w < W; ++w) mt = fmaxf(mt, st[w * (D + 2) + D]);
    float lt = 0.f, o = 0.f;
    for (int w = 0; w < W; ++w) {
      const float* sw = st + w * (D + 2);
      const float c = expf(sw[D] - mt);
      lt = fmaf(sw[D + 1], c, lt);
      o = fmaf(sw[e], c, o);
    }
    store(ob + e, o * (1.f / fmaxf(lt, L_FLOOR)));
  }
}

template <int D, bool WIN, bool RP, typename Src, typename QT>
int launch_kernel(int b, int h, int warps, cudaStream_t stream,
                  const QT* q, const int64_t* qs, Src k, Src v, QT* out,
                  const int* cache_len, int kv_h, int S, float scale,
                  int window, bool vec) {
  using KV = typename Src::value_type;
  auto kernel = decode_attn_kernel<D, WIN, RP, Src, QT>;
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  kernel<<<dim3(h, b), warps * 32, smem_bytes<D, KV>(warps), stream>>>(
      q, qs[0], qs[1], k, v, out, cache_len, h, kv_h, S, scale, window, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename Src, typename QT>
int launch_d(int b, int h, int warps, cudaStream_t stream,
             const QT* q, const int64_t* qs, Src k, Src v, QT* out,
             const int* cache_len, int kv_h, int S, float scale, int window) {
  using KV = typename Src::value_type;
  if (warps < 1 || warps > MAX_WARPS ||
      smem_bytes<D, KV>(warps) > static_cast<size_t>(MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = repro::aligned16(k) && repro::aligned16(v);
  if (window < 0)
    return launch_kernel<D, false, false>(b, h, warps, stream, q, qs, k, v,
                                          out, cache_len, kv_h, S, scale,
                                          window, vec);
  constexpr bool RP = std::is_same_v<Src, repro::ContigKV<__nv_bfloat16>>;
  return launch_kernel<D, true, RP>(b, h, warps, stream, q, qs, k, v, out,
                                    cache_len, kv_h, S, scale, window, vec);
}

template <typename Src, typename QT>
int launch(int d, const void* q, const int64_t* qs, Src k, Src v, void* out,
           const int* cache_len, int b, int h, int kv_h, int S, float scale,
           int window, int warps, cudaStream_t stream) {
  auto Q = static_cast<const QT*>(q);
  auto O = static_cast<QT*>(out);
  switch (d) {
    case 32: return launch_d<32>(b, h, warps, stream, Q, qs, k, v, O, cache_len, kv_h, S, scale, window);
    case 64: return launch_d<64>(b, h, warps, stream, Q, qs, k, v, O, cache_len, kv_h, S, scale, window);
    case 128: return launch_d<128>(b, h, warps, stream, Q, qs, k, v, O, cache_len, kv_h, S, scale, window);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Src>
int launch_q(int q_bf16, int d, const void* q, const int64_t* qs, Src k,
             Src v, void* out, const int* cache_len, int b, int h, int kv_h,
             int S, float scale, int window, int warps,
             cudaStream_t stream) {
  if (q_bf16)
    return launch<Src, __nv_bfloat16>(d, q, qs, k, v, out, cache_len, b, h,
                                      kv_h, S, scale, window, warps, stream);
  return launch<Src, float>(d, q, qs, k, v, out, cache_len, b, h, kv_h, S,
                            scale, window, warps, stream);
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

// q: (b, h, 1, d) f32 or bf16 (q_bf16 = 1) with element strides qs =
// (batch, head); k, v: (b, kv_h, S, d) bf16 (kv_bf16 = 1) or f32 with
// strides (batch, head, row), last dims contiguous; cache_len: (b,) int32
// live lengths.  out: (b, h, d) contiguous in q's type.  window: sliding
// window (keys at positions >= cache_len - window), or -1 for none; a
// window on a bf16 cache rounds the probabilities to bf16 against the
// row's maximum before P.V (the RP instantiation).  warps: the plan
// (kernels/decode_attention/plan.py), W warps a block for each (slot,
// head).
REPRO_API int decode_attn_launch(const void* q, const int64_t* qs,
                                 const void* k, const int64_t* ks,
                                 const void* v, const int64_t* vs, void* out,
                                 const void* cache_len, int b, int h,
                                 int kv_h, int S, int d, float scale,
                                 int window, int kv_bf16, int q_bf16,
                                 int warps, void* stream) {
  auto cl = static_cast<const int*>(cache_len);
  auto st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch_q(q_bf16, d, q, qs, contig<__nv_bfloat16>(k, ks),
                    contig<__nv_bfloat16>(v, vs), out, cl, b, h, kv_h, S,
                    scale, window, warps, st);
  return launch_q(q_bf16, d, q, qs, contig<float>(k, ks), contig<float>(v, vs),
                  out, cl, b, h, kv_h, S, scale, window, warps, st);
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
    int d, float scale, int window, int kv_kind, int q_bf16, int warps,
    void* stream) {
  auto cl = static_cast<const int*>(cache_len);
  auto T = static_cast<const int*>(bt);
  auto st = static_cast<cudaStream_t>(stream);
  const int S = n_pages * ps;
  switch (kv_kind) {
    case 0:
      return launch_q(q_bf16, d, q, qs,
                      paged<float>(k, ks, nullptr, nullptr, T, bt_s, ps),
                      paged<float>(v, vs, nullptr, nullptr, T, bt_s, ps), out,
                      cl, b, h, kv_h, S, scale, window, warps, st);
    case 1:
      return launch_q(
          q_bf16, d, q, qs,
          paged<__nv_bfloat16>(k, ks, nullptr, nullptr, T, bt_s, ps),
          paged<__nv_bfloat16>(v, vs, nullptr, nullptr, T, bt_s, ps), out,
          cl, b, h, kv_h, S, scale, window, warps, st);
    case 2:
      if (k_sc == nullptr || v_sc == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_q(q_bf16, d, q, qs,
                      paged<int8_t>(k, ks, k_sc, kss, T, bt_s, ps),
                      paged<int8_t>(v, vs, v_sc, vss, T, bt_s, ps), out, cl,
                      b, h, kv_h, S, scale, window, warps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
