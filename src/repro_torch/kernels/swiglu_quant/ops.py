"""Public wrapper of the fused SwiGLU dequant/requant (counterpart of
``repro/kernels/swiglu_quant/ops.py::swiglu_quant``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.swiglu_quant import kernel, ref


def swiglu_quant(gate_i32: torch.Tensor, up_i32: torch.Tensor,
                 gscale: torch.Tensor, uscale: torch.Tensor):
    """The paper's TLMM-FUSE elementwise unit: int32 gate/up accumulators
    (..., f) and their f32 dequant scales (..., 1) -> ((..., f) int8,
    (..., 1) f32 scale) of SiLU(gate) * up.  A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    lead, f = gate_i32.shape[:-1], gate_i32.shape[-1]
    g2, u2 = gate_i32.reshape(-1, f), up_i32.reshape(-1, f)
    if on_card(gate_i32, "swiglu_quant"):
        q, scale = kernel.swiglu_quant_cuda(
            g2, u2, gscale.reshape(-1).contiguous(),
            uscale.reshape(-1).contiguous())
    else:
        q, scale = ref.swiglu_quant_ref(g2, u2, gscale.reshape(-1, 1),
                                        uscale.reshape(-1, 1))
    return q.reshape(lead + (f,)), scale.reshape(lead + (1,))
