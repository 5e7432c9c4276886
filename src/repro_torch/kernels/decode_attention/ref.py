"""Plain PyTorch versions of the decode attention kernels, contiguous and
paged (f32, same masking and floor as the kernels; see ``flash_prefill.ref``),
and the page-gather helpers (counterparts of
``repro/kernels/decode_attention/ref.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill.ref import masked_attention


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor, *,
                         window: int | None = None) -> torch.Tensor:
    """q: (b, h, 1, d); k, v: (b, kv_h, S, d); cache_len: (b,) live lengths.
    Positions in [0, cache_len) are live; with a window only the last
    ``window`` of them."""
    S = k.shape[2]
    pos = torch.arange(S, device=q.device)
    cl = cache_len.to(q.device).long()[:, None]
    mask = pos[None, :] < cl
    if window is not None:
        mask = mask & (pos[None, :] >= cl - window)
    return masked_attention(q, k, v, mask[:, None, None, None, :])


def gather_pages_ref(pool: torch.Tensor, block_tables: torch.Tensor
                     ) -> torch.Tensor:
    """Per-slot contiguous rows from the page pool: pool (P, ps, kv_h, d),
    block_tables (b, n_pages) -> (b, kv_h, n_pages * ps, d).  Dead entries
    gather the null page; their positions lie at or past the slot's live
    length, which the caller masks."""
    g = pool[block_tables.long()]                  # (b, n, ps, kv_h, d)
    return g.flatten(1, 2).transpose(1, 2)


def gather_scale_pages_ref(scale_pool: torch.Tensor,
                           block_tables: torch.Tensor) -> torch.Tensor:
    """Per-slot contiguous scale rows: scale_pool (P, ps, kv_h),
    block_tables (b, n_pages) -> (b, kv_h, n_pages * ps)."""
    return scale_pool[block_tables.long()].flatten(1, 2).transpose(1, 2)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               cache_len: torch.Tensor, *,
                               window: int | None = None) -> torch.Tensor:
    """Gather the pages into contiguous rows, then the contiguous version.
    q: (b, h, 1, d); pools: (P, ps, kv_h, d); block_tables: (b, n_pages)."""
    return decode_attention_ref(q, gather_pages_ref(k_pool, block_tables),
                                gather_pages_ref(v_pool, block_tables),
                                cache_len, window=window)


def dequant_bf16(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 (..., d) x f32 (...) -> bf16: the product of the bf16 value and
    the bf16 scale, rounded to bf16 (exact in f32 before the rounding) —
    the contiguous int8 cache's decode read."""
    return values.to(torch.bfloat16) * scales[..., None].to(torch.bfloat16)


def paged_decode_attention_quant_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     k_scale_pool: torch.Tensor,
                                     v_scale_pool: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     cache_len: torch.Tensor, *,
                                     window: int | None = None
                                     ) -> torch.Tensor:
    """Gather int8 pages and their scales, dequantize through bf16
    (:func:`dequant_bf16`), then the contiguous version.  Pools:
    (P, ps, kv_h, d) int8; scale pools: (P, ps, kv_h) f32."""
    k = dequant_bf16(gather_pages_ref(k_pool, block_tables),
                     gather_scale_pages_ref(k_scale_pool, block_tables))
    v = dequant_bf16(gather_pages_ref(v_pool, block_tables),
                     gather_scale_pages_ref(v_scale_pool, block_tables))
    return decode_attention_ref(q, k, v, cache_len, window=window)
