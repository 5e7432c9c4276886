"""Public wrappers of the prompt and chunk attention kernels (counterparts of
``repro/kernels/flash_prefill/ops.py::flash_prefill``,
``::flash_chunk_prefill`` and ``::flash_chunk_prefill_paged``).  The
kernels mask ragged lengths themselves, so no operand is padded; a CUDA
tensor launches the kernel, a CPU tensor takes the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels import on_card, per_row
from repro_torch.kernels.flash_prefill import kernel, ref


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention.
    q: (b, h, s, d); k, v: (b, kv_h, s, d)."""
    if on_card(q, "flash_prefill"):
        return kernel.flash_prefill_cuda(q, k, v, window=window)
    return ref.flash_prefill_ref(q, k, v, window=window)


def flash_chunk_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor, offset, *,
                        window: int | None = None) -> torch.Tensor:
    """Chunked-prefill GQA attention: row i's chunk queries at absolute
    positions offset[i] + [0, t) against its cache row, whose span
    [start, start + t) (start = offset[i] clamped to [0, S - t]) is read from
    the chunk's fresh K/V instead — the JAX model's cache cast to f32 with
    the chunk overlaid, without the copy.  q: (b, h, t, d); k, v:
    (b, kv_h, S, d) cache; k_new, v_new: (b, kv_h, t, d) f32; offset: int or
    (b,) tensor."""
    off = per_row(offset, q)
    if on_card(q, "flash_chunk_prefill"):
        return kernel.flash_chunk_prefill_cuda(q, k, v, k_new, v_new, off,
                                               window=window)
    return ref.flash_chunk_prefill_ref(q, k, v, k_new, v_new, off,
                                       window=window)


def flash_chunk_prefill_paged(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, block_tables: torch.Tensor,
                              offset, k_fresh: torch.Tensor,
                              v_fresh: torch.Tensor, *,
                              window: int | None = None) -> torch.Tensor:
    """Paged chunked-prefill GQA attention: row i's chunk queries at
    absolute positions offset[i] + [0, t) against its [0, offset[i]) prefix
    in the page pool, read through its block-table row, and its own causal
    triangle from the chunk's fresh K/V.  q: (b, h, t, d); k_pool, v_pool:
    (P, ps, kv_h, d); block_tables: (b, n_pages) int32 (dead entries name
    the null page 0); offset: int or (b,); k_fresh, v_fresh:
    (b, kv_h, t, d) f32."""
    off = per_row(offset, q)
    if on_card(q, "flash_chunk_prefill_paged"):
        return kernel.flash_chunk_prefill_paged_cuda(
            q, k_pool, v_pool, block_tables, off, k_fresh, v_fresh,
            window=window)
    return ref.flash_chunk_prefill_paged_ref(q, k_pool, v_pool, block_tables,
                                             off, k_fresh, v_fresh,
                                             window=window)
