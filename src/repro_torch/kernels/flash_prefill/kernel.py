"""Launches of the prompt and chunk attention CUDA kernels
(``csrc/flash_prefill.cu``).

Replace ``repro/kernels/flash_prefill/kernel.py::_flash_kernel``,
``::_chunk_kernel`` and ``::_paged_chunk_kernel``; the source note in
``flash_prefill.cu`` says what bounds them on the card and how the design
answers.  Every operand is read through its strides (the last dim must be
contiguous), so the transposed views of the (b, S, kv_h, d) layout are never
copied, and the chunk kernels read the cache (contiguous rows or a page pool
through its block table) in its own dtype, taking the chunk's span from the
fresh K/V operand.  The warps a block come from ``plan.WARPS`` by head
dim.  The query and the chunk's fresh K/V may be f32 or bf16: they are
widened to f32 (exactly) for the launch, which computes in f32, and the
output is rounded to the query's dtype, as the JAX kernels store it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import plan

HEAD_DIMS = (32, 64, 128)
ACT_DTYPES = (torch.float32, torch.bfloat16)


def _warps(d: int) -> int:
    """Warps a block of the launch at head dim d."""
    plan.check_warps(d, plan.WARPS[d])
    return plan.WARPS[d]


def _check(what, name, x, dev, dtypes):
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"{what}: {name} must be a CUDA tensor on {dev}")
    if x.dtype not in dtypes or x.dim() != 4 or x.stride(3) != 1:
        raise ValueError(f"{what}: {name} must be 4-D {'/'.join(map(str, dtypes))}"
                         " with a contiguous last dim")


def _check_chunk(what, q, k_new, v_new, offset, kv_h, S):
    b, _, t, d = q.shape
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        _check(what, name, x, q.device, ACT_DTYPES)
        if x.shape != (b, kv_h, t, d):
            raise ValueError(f"{what}: {name} must be {(b, kv_h, t, d)}")
    if t > S:
        raise ValueError(f"{what}: chunk of {t} rows exceeds the {S}-row "
                         "cache")
    if (offset.dtype != torch.int32 or offset.shape != (b,)
            or offset.device != q.device or not offset.is_contiguous()):
        raise ValueError(f"{what}: offset must be a contiguous (b,) int32 "
                         "CUDA tensor")


def _launch(q, k, v, k_new, v_new, offset, window, what):
    dev, dtype = q.device, q.dtype
    _check(what, "q", q, dev, ACT_DTYPES)
    for name, x in (("k", k), ("v", v)):
        _check(what, name, x, dev, ACT_DTYPES)
    b, h, t, d = q.shape
    kv_h, S = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.dtype != v.dtype or k.shape[0] != b
            or k.shape[3] != d or h % kv_h):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not match")
    if k_new is not None:
        _check_chunk(what, q, k_new, v_new, offset, kv_h, S)
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out.to(dtype)
    fresh = k_new is not None
    q = q.float()                   # widened exactly, as are the fresh K/V
    if fresh:
        k_new, v_new = k_new.float(), v_new.float()
    err = build.load().flash_attn_launch(
        q.data_ptr(), build.strides(q), k.data_ptr(), build.strides(k),
        v.data_ptr(), build.strides(v),
        k_new.data_ptr() if fresh else None,
        build.strides(k_new) if fresh else None,
        v_new.data_ptr() if fresh else None,
        build.strides(v_new) if fresh else None, out.data_ptr(),
        None if offset is None else offset.data_ptr(), b, h, kv_h, t, S, d,
        1.0 / float(d) ** 0.5, -1 if window is None else int(window),
        int(k.dtype == torch.bfloat16), _warps(d),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    return out.to(dtype)


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int | None = None) -> torch.Tensor:
    """Causal GQA attention over a prompt.  q: (b, h, s, d); k, v:
    (b, kv_h, s, d), f32 or bf16 on the card -> (b, h, s, d) in q's
    dtype."""
    out = _launch(q, k, v, None, None, None, window, "flash_prefill")
    if out.numel():
        flash_prefill_cuda.launches += 1
    return out


def flash_chunk_prefill_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, offset: torch.Tensor, *,
                             window: int | None = None) -> torch.Tensor:
    """Chunk queries at absolute positions offset[i] + [0, t) against their
    cache rows, the chunk's own span taken from its fresh K/V.  q:
    (b, h, t, d) f32; k, v: (b, kv_h, S, d) bf16 or f32 cache; k_new, v_new:
    (b, kv_h, t, d) f32; offset: (b,) int32, all on the card -> (b, h, t, d)
    f32."""
    out = _launch(q, k, v, k_new, v_new, offset, window,
                  "flash_chunk_prefill")
    if out.numel():
        flash_chunk_prefill_cuda.launches += 1
    return out


def flash_chunk_prefill_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   offset: torch.Tensor, k_fresh: torch.Tensor,
                                   v_fresh: torch.Tensor, *,
                                   window: int | None = None) -> torch.Tensor:
    """Chunk queries at absolute positions offset[i] + [0, t) against row
    i's prefix in the page pool, the chunk's own span from its fresh K/V.
    q: (b, h, t, d) f32 or bf16; k_pool, v_pool: (P, ps, kv_h, d) bf16 or
    f32; block_tables: (b, n_pages) int32 (every entry a valid page);
    offset: (b,) int32; k_fresh, v_fresh: (b, kv_h, t, d) f32 or bf16, all
    on the card -> (b, h, t, d) in q's dtype."""
    what = "flash_chunk_prefill_paged"
    dev, dtype = q.device, q.dtype
    _check(what, "q", q, dev, ACT_DTYPES)
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check(what, name, x, dev, (torch.float32, torch.bfloat16))
    b, h, t, d = q.shape
    _, ps, kv_h, _ = k_pool.shape
    if (k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype
            or k_pool.shape[3] != d or h % kv_h):
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (block_tables.device != dev or block_tables.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.stride(1) != 1):
        raise ValueError(f"{what}: block_tables must be a (b, n_pages) int32 "
                         "CUDA tensor with contiguous rows")
    n_pages = block_tables.shape[1]
    _check_chunk(what, q, k_fresh, v_fresh, offset, kv_h, n_pages * ps)
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out.to(dtype)
    q, k_fresh, v_fresh = q.float(), k_fresh.float(), v_fresh.float()
    err = build.load().flash_attn_paged_launch(
        q.data_ptr(), build.strides(q), k_pool.data_ptr(),
        build.strides(k_pool), v_pool.data_ptr(), build.strides(v_pool),
        block_tables.data_ptr(), block_tables.stride(0), k_fresh.data_ptr(),
        build.strides(k_fresh), v_fresh.data_ptr(), build.strides(v_fresh),
        out.data_ptr(), offset.data_ptr(), b, h, kv_h, t, n_pages, ps, d,
        1.0 / float(d) ** 0.5, -1 if window is None else int(window),
        int(k_pool.dtype == torch.bfloat16), _warps(d),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, what)
    flash_chunk_prefill_paged_cuda.launches += 1
    return out.to(dtype)


flash_prefill_cuda.launches = 0
flash_chunk_prefill_cuda.launches = 0
flash_chunk_prefill_paged_cuda.launches = 0
