"""Plain PyTorch versions of the prompt and chunk attention kernels, on
contiguous rows and on a page pool.

f32 formulation of the kernels' function: scores q.k * d**-0.5, masked
scores -1e30, the softmax over live keys only, and the output
sum(p v) / max(sum p, 1e-30) — a row with no live key gives zeros, as the
kernels do.  GQA is computed grouped (q viewed as (b, kv_h, group, t, d)),
so no KV head is copied.  Keys are taken in tiles of ``KEY_TILE`` with an
online softmax, as the kernels take them: a tile wholly past every live key
changes nothing, so rows that hold the same live keys give the same bits
whatever their length — a page pool gathered to n_pages * page_size rows
gives what the contiguous cache gives.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
KEY_TILE = 32


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q: (b, h, t, d); k, v: (b, kv_h, S, d); mask: broadcastable to
    (b, 1, 1, t, S), True where query row may attend key -> (b, h, t, d) in
    q's dtype.  Masked keys must hold finite values."""
    b, h, t, d = q.shape
    kv_h, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kv_h, h // kv_h, t, d)
    mask = mask.expand(b, 1, 1, t, S)
    m = torch.full((b, kv_h, h // kv_h, t, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for s0 in range(0, S, KEY_TILE):
        mt = mask[..., s0:s0 + KEY_TILE]
        kt, vt = k[:, :, s0:s0 + KEY_TILE].float(), v[:, :, s0:s0 + KEY_TILE].float()
        pad = KEY_TILE - mt.shape[-1]
        if pad:   # a short last tile computes at the full tile shape
            mt = torch.nn.functional.pad(mt, (0, pad))
            kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
            vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kt) * (1.0 / float(d) ** 0.5)
        s = torch.where(mt, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mt, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgqs,bksd->bkgqd", p, vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
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


def flash_chunk_prefill_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  offset: torch.Tensor, k_fresh: torch.Tensor,
                                  v_fresh: torch.Tensor, *,
                                  window: int | None = None) -> torch.Tensor:
    """Chunk attention against the page pool: gather each row's pages into
    contiguous rows, then :func:`flash_chunk_prefill_ref` with the chunk's
    fresh K/V.  q: (b, h, t, d); pools: (P, ps, kv_h, d); block_tables:
    (b, n_pages); offset: (b,); k_fresh, v_fresh: (b, kv_h, t, d)."""
    # imported here: the decode package's plain version imports this module
    from repro_torch.kernels.decode_attention.ref import gather_pages_ref
    return flash_chunk_prefill_ref(
        q, gather_pages_ref(k_pool, block_tables),
        gather_pages_ref(v_pool, block_tables), k_fresh, v_fresh, offset,
        window=window)
