"""KV cache writes, contiguous and paged, the int8 paged chunk read, the
paper's Fig. 6b attention baselines and the split-K decode reads.

Counterpart of ``repro/models/attention.py``:

* ``attention_skip`` / ``attention_naive`` — whole-prompt attention in plain
  PyTorch on (q-chunk, kv-chunk) tiles (``Ctx.attn="skip"``/``"naive"``):
  only the causally live tiles, or every tile with the mask applied
  afterwards (2x the useful FLOPs), each an online softmax over its tiles;
  the live-tile one carries the flash backward (``FlashSkip``) training
  differentiates through;
* ``splitk_decode_attention`` and its paged and paged-int8 variants — the
  decode reads of ``Ctx.kv_splits`` (gather the pages, then split-K);

* contiguous writes — ``update_cache_slice`` / ``update_kv_cache`` and the
  admission wave's masked ``write_rows``, in place;
* the paged cache — a global pool of fixed-size pages addressed through
  per-slot block tables: ``paged_update_kv_cache`` / ``paged_update_kv_scales``
  (in place), ``copy_kv_page`` (the prefix-sharing copy-on-write split, in
  place), and ``paged_chunk_prefill_attention_quant``, the int8 pool's
  chunk read (gather, dequantize, then the contiguous chunk kernel).

The attention itself is the kernel wrappers' (``kernels/flash_prefill/ops.py``
and ``kernels/decode_attention/ops.py``), which the model calls directly:
each launches its CUDA kernel for a CUDA tensor and takes its plain version
for a CPU tensor.  Layouts are the JAX package's: attention operands
(b, h, t, d), caches (b, S, kv_h, hd), page pools (num_pages, page_size,
kv_h, hd), block tables (b, n_pages) int32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import (dequant_bf16,
                                                      gather_pages_ref,
                                                      gather_scale_pages_ref)
from repro_torch.kernels.flash_prefill import ops as fp_ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Whole-prompt attention: the Fig. 6b baselines
# ---------------------------------------------------------------------------

def live_tile_pairs(n_q: int, n_kv: int, q_chunk: int, kv_chunk: int,
                    causal: bool, window) -> list:
    """The (q-chunk, kv-chunk) tiles holding any unmasked position, in
    order — the RPA "a mask never generates work" set."""
    pairs = []
    for i in range(n_q):
        q_lo, q_hi = i * q_chunk, (i + 1) * q_chunk - 1
        for j in range(n_kv):
            k_lo, k_hi = j * kv_chunk, (j + 1) * kv_chunk - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi < q_lo - window + 1:
                continue
            pairs.append((i, j))
    return pairs


def _tiles(s: int, q_chunk: int, kv_chunk: int):
    """(q_chunk, kv_chunk, n_q, n_kv) for a length-s prompt; a size that
    does not divide s falls back to one chunk, as in JAX."""
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, s)
    if s % q_chunk:
        q_chunk = s
    if s % kv_chunk:
        kv_chunk = s
    return q_chunk, kv_chunk, s // q_chunk, s // kv_chunk


def _tile_step(carry, qg_blk, k_blk, v_blk, q_start, k_start, scale, causal,
               window):
    """One online-softmax step of a q tile against a kv tile: (acc, m, l)
    -> updated.  q tile (b, kv_h, g, qc, d); K/V tiles (b, kv_h, kc, d)."""
    acc, m, l = carry
    qc, kc = qg_blk.shape[3], k_blk.shape[2]
    dev = qg_blk.device
    q_ids = q_start + torch.arange(qc, device=dev)[:, None]
    k_ids = k_start + torch.arange(kc, device=dev)[None, :]
    mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_ids <= q_ids)
    if window is not None:
        mask = mask & (k_ids > q_ids - window)
    sc = torch.matmul(qg_blk, k_blk[:, :, None].transpose(-1, -2)) * scale
    sc = torch.where(mask, sc, NEG_INF)
    m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
    p = torch.where(mask, torch.exp(sc - m_new), 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(p, v_blk[:, :, None])
    return acc, m_new, l


def _flash_tiles(q, k, v, pairs, q_chunk, kv_chunk, causal, window,
                 with_lse=False):
    """Online softmax of every q tile over its kv tiles in ``pairs``
    order: (b, h, s, d) out in q's dtype (and, ``with_lse``, the f32
    log-sum-exp (b, kv_h, g, s, 1) of each query's scores)."""
    b, h, s, d = q.shape
    qg = q.to(torch.float32).reshape(b, k.shape[1], h // k.shape[1], s, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    scale = 1.0 / float(d) ** 0.5
    shape = qg.shape[:3] + (q_chunk,)
    carries = {}
    for i, j in pairs:
        c = carries.get(i)
        if c is None:
            c = (qg.new_zeros(shape + (d,)),
                 qg.new_full(shape + (1,), NEG_INF),
                 qg.new_zeros(shape + (1,)))
        qs, ks = i * q_chunk, j * kv_chunk
        carries[i] = _tile_step(c, qg[:, :, :, qs:qs + q_chunk],
                                kf[:, :, ks:ks + kv_chunk],
                                vf[:, :, ks:ks + kv_chunk], qs, ks, scale,
                                causal, window)
    out = qg.new_zeros(qg.shape)
    lse = qg.new_full(qg.shape[:4] + (1,), NEG_INF)
    for i, (acc, m, l) in carries.items():
        l_safe = l.clamp_min(1e-30)
        out[:, :, :, i * q_chunk:(i + 1) * q_chunk] = acc / l_safe
        lse[:, :, :, i * q_chunk:(i + 1) * q_chunk] = m + torch.log(l_safe)
    out = out.reshape(b, h, s, d).to(q.dtype)
    return (out, lse) if with_lse else out


class FlashSkip(torch.autograd.Function):
    """The live-tile attention with the reference's flash VJP
    (``_make_flash`` in ``repro/models/attention.py``): the forward saves
    only (q, k, v, out, logsumexp), never a score matrix, and the backward
    recomputes each live tile in ``pairs`` order (FlashAttention-2):
    p = exp(s - lse), dV += p^T dO, dP = dO V^T, dS = p (dP - D) scale with
    D = rowsum(dO * O), dS cast to q's dtype before dQ += dS K and
    dK += dS^T Q; dQ, dK, dV accumulate in f32.  The reference's
    ``_data_entangled`` and ``optimization_barrier`` only steer XLA's
    buffer planning (no stacked masks, no hoisted tiles) and change no
    value, so they have no counterpart here."""

    @staticmethod
    def forward(ctx, q, k, v, pairs, q_chunk, kv_chunk, causal, window):
        out, lse = _flash_tiles(q, k, v, pairs, q_chunk, kv_chunk, causal,
                                window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.geom = (pairs, q_chunk, kv_chunk, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        pairs, q_chunk, kv_chunk, causal, window = ctx.geom
        b, h, s, d = q.shape
        kv_h = k.shape[1]
        gsz = h // kv_h
        scale = 1.0 / float(d) ** 0.5
        qg = q.reshape(b, kv_h, gsz, s, d)
        dog = dout.reshape(b, kv_h, gsz, s, d)
        dmat = (dog.float() * out.reshape(b, kv_h, gsz, s, d).float()
                ).sum(dim=-1, keepdim=True)
        dq = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        dev = q.device
        for i, j in pairs:
            qs, ks = i * q_chunk, j * kv_chunk
            q_blk = qg[:, :, :, qs:qs + q_chunk]
            k_blk = k[:, :, None, ks:ks + kv_chunk]
            v_blk = v[:, :, None, ks:ks + kv_chunk]
            do_blk = dog[:, :, :, qs:qs + q_chunk]
            l_blk = lse[:, :, :, qs:qs + q_chunk]
            d_blk = dmat[:, :, :, qs:qs + q_chunk]
            q_ids = qs + torch.arange(q_chunk, device=dev)[:, None]
            k_ids = ks + torch.arange(kv_chunk, device=dev)[None, :]
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = mask & (k_ids <= q_ids)
            if window is not None:
                mask = mask & (k_ids > q_ids - window)
            sc = (q_blk.float() @ k_blk.float().transpose(-1, -2)) * scale
            p = torch.where(mask, torch.exp(sc - l_blk), 0.0)
            # (b, kv_h, g, qc, kc) -> sums over the group and its queries
            pm = p.to(do_blk.dtype).reshape(b, kv_h, gsz * q_chunk, kv_chunk)
            dv_j = pm.transpose(-1, -2).float() @ do_blk.reshape(
                b, kv_h, gsz * q_chunk, d).float()
            dp = do_blk.float() @ v_blk.float().transpose(-1, -2)
            ds = p * (dp - d_blk) * scale
            ds_c = ds.to(q.dtype)
            dq_i = ds_c.float() @ k_blk.float()
            dk_j = ds_c.reshape(b, kv_h, gsz * q_chunk, kv_chunk).transpose(
                -1, -2).float() @ q_blk.reshape(
                b, kv_h, gsz * q_chunk, d).float()
            dq[:, :, :, qs:qs + q_chunk] += dq_i
            dk[:, :, ks:ks + kv_chunk] += dk_j
            dv[:, :, ks:ks + kv_chunk] += dv_j
        return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None)


def attention_skip(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window=None, q_chunk: int = 512,
                   kv_chunk: int = 512) -> torch.Tensor:
    """Causal-skip attention: one online softmax over only the live tiles
    (``live_tile_pairs``).  q: (b, h, s, d); k, v: (b, kv_h, s, d) ->
    (b, h, s, d); GQA grouped.  JAX's ``attention_xla_skip``, with its
    flash VJP (:class:`FlashSkip`): differentiable in O(s d) memory."""
    q_chunk, kv_chunk, n_q, n_kv = _tiles(q.shape[2], q_chunk, kv_chunk)
    pairs = live_tile_pairs(n_q, n_kv, q_chunk, kv_chunk, causal, window)
    return FlashSkip.apply(q, k, v, pairs, q_chunk, kv_chunk, causal,
                           window)


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, q_chunk: int = 512,
                    kv_chunk: int = 512) -> torch.Tensor:
    """The Fig. 6b baseline: every (q, kv) tile computed, the mask applied
    afterwards (2x the useful FLOPs of the skip schedule).  Counterpart of
    JAX's ``attention_xla_naive``."""
    q_chunk, kv_chunk, n_q, n_kv = _tiles(q.shape[2], q_chunk, kv_chunk)
    pairs = [(i, j) for i in range(n_q) for j in range(n_kv)]
    return _flash_tiles(q, k, v, pairs, q_chunk, kv_chunk, causal, window)


# ---------------------------------------------------------------------------
# In-place cache writes
# ---------------------------------------------------------------------------

def _row_index(cache: torch.Tensor, t: int, pos):
    """(rows, cols) advanced index of t positions per row starting at
    ``pos`` (int or (b,)), each start clamped to [0, S - t] exactly as
    ``jax.lax.dynamic_update_slice`` clamps it: an inactive serving lane
    parked at position S writes row S - 1, never out of bounds."""
    b, S = cache.shape[:2]
    start = torch.as_tensor(pos, device=cache.device).long().reshape(-1)
    start = start.expand(b).clamp(0, S - t)
    cols = start[:, None] + torch.arange(t, device=cache.device)
    rows = torch.arange(b, device=cache.device)[:, None]
    return rows, cols


def update_cache_slice(cache: torch.Tensor, new: torch.Tensor, pos
                       ) -> torch.Tensor:
    """Write ``new`` (b, t, ...) into ``cache`` (b, S, ...) at sequence
    offset ``pos`` (scalar, or (b,) per-row offsets), in place; returns
    ``cache``."""
    rows, cols = _row_index(cache, new.shape[1], pos)
    cache[rows, cols] = new.to(cache.dtype)
    return cache


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write new KV at ``pos`` into (b, S, kv_h, hd) caches, in place."""
    return (update_cache_slice(k_cache, k_new, pos),
            update_cache_slice(v_cache, v_new, pos))


def write_rows(cache: torch.Tensor, new: torch.Tensor, offsets, mask
               ) -> torch.Tensor:
    """Admission-wave write, in place: row i with ``mask[i]`` takes
    ``new[i]`` at ``offsets[i]`` (clamped like ``update_cache_slice``);
    masked rows keep their contents.  No host sync: the untouched rows are
    rewritten with their own values."""
    rows, cols = _row_index(cache, new.shape[1], offsets)
    keep = ~torch.as_tensor(mask, device=cache.device).reshape(
        (-1,) + (1,) * (new.dim() - 1))
    cache[rows, cols] = torch.where(keep, cache[rows, cols],
                                    new.to(cache.dtype))
    return cache


# ---------------------------------------------------------------------------
# Paged KV cache: global page pool + per-slot block tables
# ---------------------------------------------------------------------------
#
# Storage contract (the JAX package's): slot i's flat token position p lives
# at pool[bt[i, p // page_size], p % page_size].  Page 0 is the reserved
# null page: no slot owns it, dead block-table entries name it, and every
# write without a live target (a masked admission row, a position past the
# table) lands in it.

def gather_kv_pages_dequant(pool: torch.Tensor, scale_pool: torch.Tensor,
                            block_table: torch.Tensor, dtype: torch.dtype
                            ) -> torch.Tensor:
    """A slot's int8 pages dequantized with their scale plane: (b, kv_h,
    S', hd) in ``dtype`` (the chunk paths read f32(int8) * f32(scale))."""
    vals = gather_pages_ref(pool, block_table)
    scales = gather_scale_pages_ref(scale_pool, block_table)
    return vals.to(dtype) * scales[..., None].to(dtype)


def copy_kv_page(pool: torch.Tensor, src: int, dst: int, *,
                 page_axis: int = 0) -> torch.Tensor:
    """Copy page ``src`` onto page ``dst`` of a paged KV plane, in place —
    the device half of the serving engine's copy-on-write split: a slot
    granted a partly shared boundary page writes into a private copy, so
    the donor's readers never see its writes.  Every other page is
    untouched.  Returns ``pool``."""
    pool.select(page_axis, dst).copy_(pool.select(page_axis, src))
    return pool


def _paged_write_targets(block_table: torch.Tensor, pos, b: int, t: int,
                         page_size: int, write_mask=None):
    """(page, slot) targets of t tokens per row starting at flat position
    ``pos`` (int or (b,)): token j of row i goes to page
    bt[i, (pos[i] + j) // page_size] at (pos[i] + j) % page_size.  Rows
    with ``write_mask[i]`` False and positions past the table go to the
    null page 0, slot 0."""
    dev = block_table.device
    n_pages = block_table.shape[1]
    p = torch.as_tensor(pos, dtype=torch.long, device=dev).reshape(-1)
    flat = p.expand(b)[:, None] + torch.arange(t, device=dev)       # (b, t)
    pi, oi = flat // page_size, flat % page_size
    valid = pi < n_pages
    if write_mask is not None:
        valid = valid & torch.as_tensor(write_mask, dtype=torch.bool,
                                        device=dev).reshape(-1, 1)
    pages = torch.gather(block_table.long(), 1, pi.clamp(max=n_pages - 1))
    return torch.where(valid, pages, 0), torch.where(valid, oi, 0)


def paged_update_kv_cache(k_pool: torch.Tensor, v_pool: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          block_table: torch.Tensor, pos, write_mask=None):
    """Scatter new KV (b, t, kv_h, hd) into the pools (P, ps, kv_h, hd) at
    their (page, slot) targets (``_paged_write_targets``), in place; a slot
    that owns no pages has an all-zero table row, so its writes land in the
    null page.  Returns the pools."""
    b, t = k_new.shape[:2]
    pages, oi = _paged_write_targets(block_table, pos, b, t,
                                     k_pool.shape[1], write_mask)
    k_pool[pages, oi] = k_new.to(k_pool.dtype)
    v_pool[pages, oi] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def paged_update_kv_scales(k_scale_pool: torch.Tensor,
                           v_scale_pool: torch.Tensor, ks_new: torch.Tensor,
                           vs_new: torch.Tensor, block_table: torch.Tensor,
                           pos, write_mask=None):
    """The int8 pools' companion: scatter per-(token, head) scales
    (b, t, kv_h) into the (P, ps, kv_h) planes with the same targets, in
    place."""
    b, t = ks_new.shape[:2]
    pages, oi = _paged_write_targets(block_table, pos, b, t,
                                     k_scale_pool.shape[1], write_mask)
    k_scale_pool[pages, oi] = ks_new.to(k_scale_pool.dtype)
    v_scale_pool[pages, oi] = vs_new.to(v_scale_pool.dtype)
    return k_scale_pool, v_scale_pool


def paged_chunk_prefill_attention_quant(q, k_pool, v_pool, k_scale_pool,
                                        v_scale_pool, block_table, offset,
                                        k_fresh, v_fresh, *, window=None):
    """Chunk-vs-prefix attention against the int8 paged cache: gather and
    dequantize the rows to f32 (as the contiguous int8 chunk path reads
    them), then the contiguous chunk kernel with the chunk's fresh K/V.
    The JAX package has no kernel for this step either."""
    k = gather_kv_pages_dequant(k_pool, k_scale_pool, block_table, q.dtype)
    v = gather_kv_pages_dequant(v_pool, v_scale_pool, block_table, q.dtype)
    return fp_ops.flash_chunk_prefill(q, k, v, k_fresh, v_fresh, offset,
                                      window=window)


# ---------------------------------------------------------------------------
# Split-K decode reads (Ctx.kv_splits)
# ---------------------------------------------------------------------------

def splitk_decode_attention(q, k, v, cache_len, *, ctx, window=None):
    """Single-token attention by split-K (``Ctx.kv_splits`` chunks; over
    ``Ctx.kv_group`` when set).  q: (b, h, 1, d); k, v: (b, kv_h, S, d)."""
    return da_ops.splitk_decode(q, k, v, cache_len, kv_splits=ctx.kv_splits,
                                window=window, group=ctx.kv_group,
                                group_size=ctx.kv_group_size)


def paged_splitk_decode_attention(q, k_pool, v_pool, block_table, cache_len,
                                  *, ctx, window=None):
    """The paged read: gather the slots' pages into rows in q's dtype, then
    split-K (JAX's ``paged_decode_attention`` with ``kv_splits``)."""
    k = gather_pages_ref(k_pool, block_table).to(q.dtype)
    v = gather_pages_ref(v_pool, block_table).to(q.dtype)
    return splitk_decode_attention(q, k, v, cache_len, ctx=ctx, window=window)


def paged_splitk_decode_attention_quant(q, k_pool, v_pool, k_scale_pool,
                                        v_scale_pool, block_table, cache_len,
                                        *, ctx, window=None):
    """The paged int8 read: gather the pages and their scales, dequantize
    through bf16 (the contiguous int8 decode read), then split-K."""
    k = dequant_bf16(gather_pages_ref(k_pool, block_table),
                     gather_scale_pages_ref(k_scale_pool, block_table))
    v = dequant_bf16(gather_pages_ref(v_pool, block_table),
                     gather_scale_pages_ref(v_scale_pool, block_table))
    return splitk_decode_attention(q, k, v, cache_len, ctx=ctx, window=window)
