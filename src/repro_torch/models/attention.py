"""KV cache writes, contiguous and paged, and the int8 paged chunk read.

Counterpart of the cache half of ``repro/models/attention.py``:

* contiguous writes — ``update_cache_slice`` / ``update_kv_cache`` and the
  admission wave's masked ``write_rows``, in place;
* the paged cache — a global pool of fixed-size pages addressed through
  per-slot block tables: ``paged_update_kv_cache`` / ``paged_update_kv_scales``
  (in place), and ``paged_chunk_prefill_attention_quant``, the int8 pool's
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

from repro_torch.kernels.decode_attention.ref import (gather_pages_ref,
                                                      gather_scale_pages_ref)
from repro_torch.kernels.flash_prefill import ops as fp_ops


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
