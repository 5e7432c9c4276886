"""Launch of the decode attention CUDA kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py::_decode_kernel``; the
source note in ``decode_attention.cu`` says what bounds it on the card and
how the design answers.  The cache is read through its strides (last dim
contiguous), so the (b, kv_h, S, d) view of the (b, S, kv_h, d) cache is
never copied.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache_len: torch.Tensor) -> torch.Tensor:
    """q: (b, h, 1, d) f32; k, v: (b, kv_h, S, d) bf16 or f32; cache_len:
    (b,) int32, all on the card -> (b, h, 1, d) f32."""
    for name, x in (("q", q), ("k", k), ("v", v), ("cache_len", cache_len)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"decode_attention: {name} must be a CUDA tensor "
                             f"on {q.device}")
    if q.dtype != torch.float32 or q.dim() != 4 or q.shape[2] != 1:
        raise ValueError("decode_attention: q must be (b, h, 1, d) float32")
    if k.dtype != v.dtype or k.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("decode_attention: k and v must share a bf16 or f32 "
                         "dtype")
    b, h, _, d = q.shape
    kv_h, S = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.dim() != 4 or k.shape[0] != b
            or k.shape[3] != d or h % kv_h):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: last dims must be contiguous")
    if (cache_len.dtype != torch.int32 or cache_len.shape != (b,)
            or not cache_len.is_contiguous()):
        raise ValueError("decode_attention: cache_len must be a contiguous "
                         "(b,) int32 tensor")
    out = torch.empty((b, h, 1, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    err = build.load().decode_attn_launch(
        q.data_ptr(), build.strides(q.squeeze(2)), k.data_ptr(),
        build.strides(k), v.data_ptr(), build.strides(v), out.data_ptr(),
        cache_len.data_ptr(), b, h, kv_h, S, d, 1.0 / float(d) ** 0.5,
        int(k.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
