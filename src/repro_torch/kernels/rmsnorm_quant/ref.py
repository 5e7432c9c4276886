"""Plain PyTorch version of the fused RMSNorm + int8 quant kernel (the
arithmetic of ``repro/kernels/rmsnorm_quant/ref.py``)."""

import torch

from repro_torch.core import ternary


def rmsnorm_quant_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """(..., d) -> ((..., d) int8, (..., 1) f32): f32 mean of squares,
    x * rsqrt(var + eps) * w, then the per-row absmax int8 quant."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ternary.absmax_quant(xf * torch.rsqrt(var + eps) * w.float())
