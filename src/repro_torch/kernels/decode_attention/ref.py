"""Plain PyTorch version of the decode attention kernel (dense f32, same
masking and floor as the kernel; see ``flash_prefill.ref``)."""

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
