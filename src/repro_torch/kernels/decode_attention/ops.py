"""Public wrapper of the decode attention kernel (counterpart of
``repro/kernels/decode_attention/ops.py::decode_attention``).  The kernel
stops at each slot's live length, so the cache is never padded; a CUDA
tensor launches the kernel, a CPU tensor takes the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel, ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len) -> torch.Tensor:
    """Single-token GQA attention against a partially filled cache.
    q: (b, h, 1, d); k, v: (b, kv_h, S, d); cache_len: int or (b,) live
    lengths (ragged continuous batch)."""
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    cl = cl.reshape(-1).expand(q.shape[0]).contiguous()
    if q.is_cuda:
        return kernel.decode_attention_cuda(q, k, v, cl)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention has no path for device {q.device}")
    return ref.decode_attention_ref(q, k, v, cl)
