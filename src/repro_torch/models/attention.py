"""Attention for the serving phases, on a contiguous KV cache.

Counterpart of the contiguous part of ``repro/models/attention.py``:

* prompt prefill — ``prefill_attention`` (causal flash attention kernel);
* chunked prefill — ``chunk_prefill_attention``: a prompt chunk at a
  per-row cache offset attends the row's written prefix plus its own causal
  triangle (chunk attention kernel);
* decode — ``decode_attention``: one token per row against its live cache
  prefix (decode attention kernel; the plain path with a sliding window,
  as in the JAX package);
* cache writes — ``update_cache_slice`` / ``update_kv_cache`` and the
  admission wave's masked ``write_rows``, in place.

Layouts are the JAX package's: attention operands (b, h, t, d), caches
(b, S, kv_h, hd).  The plain formulations keep the JAX names of the XLA
paths they stand for; they are the kernels' plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitlinear import check_impl
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ref import (flash_chunk_prefill_ref,
                                                   flash_prefill_ref)

# the plain formulations under the names of the JAX XLA paths
attention_xla_skip = flash_prefill_ref
chunk_prefill_attention_xla = flash_chunk_prefill_ref
decode_attention_xla = decode_attention_ref


def prefill_attention(q, k, v, *, window=None, impl="kernel"):
    """Causal GQA attention over a prompt: q (b, h, s, d), k/v (b, kv_h, s, d)."""
    check_impl(impl, q)
    if impl == "kernel":
        return fp_ops.flash_prefill(q, k, v, window=window)
    return attention_xla_skip(q, k, v, window=window)


def chunk_prefill_attention(q, k, v, k_new, v_new, offset, *, window=None,
                            impl="kernel"):
    """Chunk-vs-prefix attention: q (b, h, t, d) at absolute positions
    offset[i] + [0, t) against the cache rows k/v (b, kv_h, S, d), the
    chunk's own span read from its fresh K/V k_new/v_new (b, kv_h, t, d)."""
    check_impl(impl, q)
    if impl == "kernel":
        return fp_ops.flash_chunk_prefill(q, k, v, k_new, v_new, offset,
                                          window=window)
    off = torch.as_tensor(offset, dtype=torch.int32).reshape(-1)
    return chunk_prefill_attention_xla(q, k, v, k_new, v_new,
                                       off.expand(q.shape[0]), window=window)


def decode_attention(q, k, v, cache_len, *, window=None, impl="kernel"):
    """Single-token attention: q (b, h, 1, d) vs k/v (b, kv_h, S, d) with
    (b,) live lengths.  The kernel has no sliding window; with one, the
    plain path runs (as in the JAX package)."""
    check_impl(impl, q)
    if impl == "kernel" and window is None:
        return da_ops.decode_attention(q, k, v, cache_len)
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    return decode_attention_xla(q, k, v, cl.reshape(-1).expand(q.shape[0]),
                                window=window)


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
