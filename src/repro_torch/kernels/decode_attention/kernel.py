"""Launches of the decode attention CUDA kernels (``csrc/decode_attention.cu``).

Replace ``repro/kernels/decode_attention/kernel.py::_decode_kernel``,
``::_paged_decode_kernel`` and ``::_paged_decode_quant_kernel``; the source
note in ``decode_attention.cu`` says what bounds them on the card and how
the design answers.  The contiguous cache is read through its strides (last
dim contiguous), so the (b, kv_h, S, d) view of the (b, S, kv_h, d) cache is
never copied; a page pool (P, ps, kv_h, d) is read in place through the
block table.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)


def _check_query(what, q, cache_len):
    if not q.is_cuda or q.dtype != torch.float32 or q.dim() != 4 \
            or q.shape[2] != 1:
        raise ValueError(f"{what}: q must be a (b, h, 1, d) float32 CUDA "
                         "tensor")
    b, _, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    if q.stride(3) != 1:
        raise ValueError(f"{what}: last dims must be contiguous")
    if (cache_len.device != q.device or cache_len.dtype != torch.int32
            or cache_len.shape != (b,) or not cache_len.is_contiguous()):
        raise ValueError(f"{what}: cache_len must be a contiguous (b,) int32 "
                         f"tensor on {q.device}")


def _window_arg(window):
    return -1 if window is None else int(window)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache_len: torch.Tensor, *,
                          window: int | None = None) -> torch.Tensor:
    """q: (b, h, 1, d) f32; k, v: (b, kv_h, S, d) bf16 or f32; cache_len:
    (b,) int32, all on the card -> (b, h, 1, d) f32.  With ``window`` only
    the last ``window`` live keys of each row are read."""
    _check_query("decode_attention", q, cache_len)
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"decode_attention: {name} must be a CUDA tensor "
                             f"on {q.device}")
    if k.dtype != v.dtype or k.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("decode_attention: k and v must share a bf16 or f32 "
                         "dtype")
    b, h, _, d = q.shape
    kv_h, S = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.dim() != 4 or k.shape[0] != b
            or k.shape[3] != d or h % kv_h):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not match")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: last dims must be contiguous")
    out = torch.empty((b, h, 1, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    err = build.load().decode_attn_launch(
        q.data_ptr(), build.strides(q.squeeze(2)), k.data_ptr(),
        build.strides(k), v.data_ptr(), build.strides(v), out.data_ptr(),
        cache_len.data_ptr(), b, h, kv_h, S, d, 1.0 / float(d) ** 0.5,
        _window_arg(window), int(k.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _launch_paged(what, q, k_pool, v_pool, k_scale, v_scale, block_tables,
                  cache_len, window):
    _check_query(what, q, cache_len)
    b, h, _, d = q.shape
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables)):
        if x.device != q.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{q.device}")
    if (k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype
            or k_pool.dim() != 4 or k_pool.shape[3] != d
            or h % k_pool.shape[2]):
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pool.stride(3) != 1 or v_pool.stride(3) != 1:
        raise ValueError(f"{what}: the pools' last dims must be contiguous")
    _, ps, kv_h, _ = k_pool.shape
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b or block_tables.stride(1) != 1):
        raise ValueError(f"{what}: block_tables must be a (b, n_pages) int32 "
                         "tensor with contiguous rows")
    quant = k_scale is not None
    if quant:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (x.device != q.device or x.dtype != torch.float32
                    or x.shape != k_pool.shape[:3]):
                raise ValueError(f"{what}: {name} must be a {k_pool.shape[:3]}"
                                 f" float32 CUDA tensor")
        if k_pool.dtype != torch.int8:
            raise ValueError(f"{what}: scaled pools must be int8")
    elif k_pool.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: pools must be bf16 or f32")
    out = torch.empty((b, h, 1, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    err = build.load().decode_attn_paged_launch(
        q.data_ptr(), build.strides(q.squeeze(2)), k_pool.data_ptr(),
        build.strides(k_pool), v_pool.data_ptr(), build.strides(v_pool),
        # a (P, ps, kv_h) scale plane's strides, read as rows of length 1
        k_scale.data_ptr() if quant else None,
        build.strides(k_scale[..., None]) if quant else None,
        v_scale.data_ptr() if quant else None,
        build.strides(v_scale[..., None]) if quant else None, out.data_ptr(),
        cache_len.data_ptr(), block_tables.data_ptr(), block_tables.stride(0),
        b, h, kv_h, block_tables.shape[1], ps, d, 1.0 / float(d) ** 0.5,
        _window_arg(window), _KV_KIND[k_pool.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, what)
    return out


def decode_attention_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                cache_len: torch.Tensor, *,
                                window: int | None = None) -> torch.Tensor:
    """q: (b, h, 1, d) f32; k_pool, v_pool: (P, ps, kv_h, d) bf16 or f32;
    block_tables: (b, n_pages) int32 (every entry a valid page);
    cache_len: (b,) int32, all on the card -> (b, h, 1, d) f32."""
    out = _launch_paged("decode_attention_paged", q, k_pool, v_pool, None,
                        None, block_tables, cache_len, window)
    if out.numel():
        decode_attention_paged_cuda.launches += 1
    return out


def decode_attention_paged_quant_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                      v_pool: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      block_tables: torch.Tensor,
                                      cache_len: torch.Tensor, *,
                                      window: int | None = None
                                      ) -> torch.Tensor:
    """As :func:`decode_attention_paged_cuda` on int8 pools with their
    (P, ps, kv_h) f32 scale planes -> (b, h, 1, d) f32."""
    out = _launch_paged("decode_attention_paged_quant", q, k_pool, v_pool,
                        k_scale, v_scale, block_tables, cache_len, window)
    if out.numel():
        decode_attention_paged_quant_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_paged_cuda.launches = 0
decode_attention_paged_quant_cuda.launches = 0
