"""Plain PyTorch version of the fused RMSNorm + int8 quant kernel (the
arithmetic of ``repro/kernels/rmsnorm_quant/ref.py`` as the JAX package
runs it, jitted: the mean is the sum times 1/d, the scale is
``amax * (1/127)``)."""

import torch

from repro_torch.core import ternary
from repro_torch.kernels.rmsnorm_quant import plan


def rmsnorm_quant_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                      *, warps: int | None = None):
    """(..., d) -> ((..., d) int8, (..., 1) f32): f32 mean of squares,
    x * rsqrt(var + eps) * w, then the per-row absmax int8 quant.  With
    ``warps`` the sum of squares runs in the CUDA kernel's order for that
    many warps a row (``plan.sum_of_squares``)."""
    xf = x.float()
    d = x.shape[-1]
    if warps is None:
        ss = (xf * xf).sum(dim=-1, keepdim=True)
    else:
        ss = plan.sum_of_squares(xf.reshape(-1, d), warps).reshape(
            x.shape[:-1] + (1,))
    var = ss * (1.0 / d)
    return ternary.absmax_quant(xf * torch.rsqrt(var + eps) * w.float(),
                                reciprocal=True)
