"""Public wrappers of the decode attention kernels (counterparts of
``repro/kernels/decode_attention/ops.py::decode_attention``,
``::decode_attention_paged`` and ``::decode_attention_paged_quant``).  The
kernels stop at each slot's live length, so the cache is never padded; a
CUDA tensor launches the kernel, a CPU tensor takes the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels import on_card, per_row
from repro_torch.kernels.decode_attention import kernel, ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len, *, window: int | None = None) -> torch.Tensor:
    """Single-token GQA attention against a partially filled cache.
    q: (b, h, 1, d); k, v: (b, kv_h, S, d); cache_len: int or (b,) live
    lengths (ragged continuous batch); with ``window``, only the last
    ``window`` live positions of each row are attended."""
    cl = per_row(cache_len, q)
    if on_card(q, "decode_attention"):
        return kernel.decode_attention_cuda(q, k, v, cl, window=window)
    return ref.decode_attention_ref(q, k, v, cl, window=window)


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           cache_len, *, window: int | None = None
                           ) -> torch.Tensor:
    """Single-token GQA attention against a paged cache.  q: (b, h, 1, d);
    k_pool, v_pool: (P, ps, kv_h, d), the page pool every slot shares;
    block_tables: (b, n_pages) int32 page ids (dead entries name the null
    page 0); cache_len: int or (b,) live lengths."""
    cl = per_row(cache_len, q)
    if on_card(q, "decode_attention_paged"):
        return kernel.decode_attention_paged_cuda(q, k_pool, v_pool,
                                                  block_tables, cl,
                                                  window=window)
    return ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tables, cl,
                                          window=window)


def decode_attention_paged_quant(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 k_scale_pool: torch.Tensor,
                                 v_scale_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 cache_len, *, window: int | None = None
                                 ) -> torch.Tensor:
    """As :func:`decode_attention_paged` on int8 pools with their
    (P, ps, kv_h) f32 per-(token, head) scale planes; values dequantize
    through bf16, as the contiguous int8 cache's decode read."""
    cl = per_row(cache_len, q)
    if on_card(q, "decode_attention_paged_quant"):
        return kernel.decode_attention_paged_quant_cuda(
            q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, cl,
            window=window)
    return ref.paged_decode_attention_quant_ref(
        q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, cl,
        window=window)
