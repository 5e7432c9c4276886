"""Public wrappers of the prompt and chunk attention kernels (counterparts of
``repro/kernels/flash_prefill/ops.py::flash_prefill`` and
``::flash_chunk_prefill``).  The kernels mask ragged lengths themselves, so
no operand is padded; a CUDA tensor launches the kernel, a CPU tensor takes
the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill import kernel, ref


def _device_path(q: torch.Tensor, what: str) -> bool:
    if q.is_cuda:
        return True
    if q.device.type != "cpu":
        raise ValueError(f"{what} has no path for device {q.device}")
    return False


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention.
    q: (b, h, s, d); k, v: (b, kv_h, s, d)."""
    if _device_path(q, "flash_prefill"):
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
    off = torch.as_tensor(offset, dtype=torch.int32, device=q.device)
    off = off.reshape(-1).expand(q.shape[0]).contiguous()
    if _device_path(q, "flash_chunk_prefill"):
        return kernel.flash_chunk_prefill_cuda(q, k, v, k_new, v_new, off,
                                               window=window)
    return ref.flash_chunk_prefill_ref(q, k, v, k_new, v_new, off,
                                       window=window)
