"""Plain PyTorch versions of the prompt and chunk attention kernels.

Dense f32 formulation of the kernels' function: scores q.k * d**-0.5,
masked scores -1e30, p = exp(s - rowmax) on live keys only, and the output
sum(p v) / max(sum p, 1e-30) — a row with no live key gives zeros, as the
kernels do.  GQA is computed grouped (q viewed as (b, kv_h, group, t, d)),
so no KV head is copied.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q: (b, h, t, d); k, v: (b, kv_h, S, d); mask: broadcastable to
    (b, 1, 1, t, S), True where query row may attend key -> (b, h, t, d) in
    q's dtype."""
    b, h, t, d = q.shape
    kv_h = k.shape[1]
    qg = q.float().reshape(b, kv_h, h // kv_h, t, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * (1.0 / float(d) ** 0.5)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    out = out / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h, t, d).to(q.dtype)


def _positions_mask(q_pos: torch.Tensor, S: int, window) -> torch.Tensor:
    """q_pos: (b, t) absolute query positions -> (b, 1, 1, t, S) mask."""
    k_pos = torch.arange(S, device=q_pos.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    return mask[:, None, None]


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int | None = None) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention over a prompt.
    q: (b, h, s, d); k, v: (b, kv_h, s, d)."""
    b, s = q.shape[0], q.shape[2]
    q_pos = torch.arange(s, device=q.device).expand(b, s)
    return masked_attention(q, k, v, _positions_mask(q_pos, k.shape[2], window))


def overlay_chunk(cache: torch.Tensor, new: torch.Tensor, offset: torch.Tensor
                  ) -> torch.Tensor:
    """The keys the chunk kernel attends: an f32 copy of the cache rows
    (b, kv_h, S, d) with positions [start, start + t) replaced by ``new``
    (b, kv_h, t, d), start = offset clamped to [0, S - t] — the JAX model's
    cast-and-overlay, which the kernel does without the copy."""
    b, t, S = new.shape[0], new.shape[2], cache.shape[2]
    start = offset.to(cache.device).long().clamp(0, S - t)
    cols = start[:, None] + torch.arange(t, device=cache.device)
    out = cache.float().clone()
    out[torch.arange(b, device=cache.device)[:, None], :, cols] = (
        new.float().transpose(1, 2))
    return out


def flash_chunk_prefill_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, offset: torch.Tensor, *,
                            window: int | None = None) -> torch.Tensor:
    """Chunk queries at absolute positions offset[i] + [0, t) against cache
    rows overlaid by the chunk's fresh K/V (see :func:`overlay_chunk`).
    q: (b, h, t, d); k, v: (b, kv_h, S, d); k_new, v_new: (b, kv_h, t, d);
    offset: (b,)."""
    t = q.shape[2]
    k, v = overlay_chunk(k, k_new, offset), overlay_chunk(v, v_new, offset)
    q_pos = offset.to(q.device).long()[:, None] + torch.arange(t, device=q.device)
    return masked_attention(q, k, v, _positions_mask(q_pos, k.shape[2], window))
