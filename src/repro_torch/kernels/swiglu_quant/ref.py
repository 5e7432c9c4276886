"""Plain PyTorch version of the fused SwiGLU dequant/requant kernel (the
arithmetic of ``repro/kernels/swiglu_quant/ref.py``)."""

import torch

from repro_torch.core import ternary


def swiglu_quant_ref(gate_i32: torch.Tensor, up_i32: torch.Tensor,
                     gscale: torch.Tensor, uscale: torch.Tensor):
    """(m, f) int32 x2, (m, 1) f32 x2 -> ((m, f) int8, (m, 1) f32):
    g * sigmoid(g) * u with sigmoid written 1 / (1 + exp(-g)), as the
    kernel computes it, then the per-row absmax int8 quant."""
    g = gate_i32.float() * gscale
    u = up_i32.float() * uscale
    return ternary.absmax_quant(g * (1.0 / (1.0 + torch.exp(-g))) * u)
