"""Public wrapper of the fused RMSNorm + int8 quant (counterpart of
``repro/kernels/rmsnorm_quant/ops.py::rmsnorm_quant``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.rmsnorm_quant import kernel, ref


def rmsnorm_quant(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5):
    """The paper's RMS-MAX unit: (..., d) f32/bf16 -> ((..., d) int8,
    (..., 1) f32 scale), the norm in f32 with weight w and a per-row absmax
    quant.  A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if on_card(x, "rmsnorm_quant"):
        q, scale = kernel.rmsnorm_quant_cuda(x2, w, eps=eps)
    else:
        q, scale = ref.rmsnorm_quant_ref(x2, w, eps)
    return q.reshape(lead + (d,)), scale.reshape(lead + (1,))
