"""Launch of the fused SwiGLU dequant/requant CUDA kernel
(``csrc/swiglu_quant.cu``).

Replaces ``repro/kernels/swiglu_quant/kernel.py::swiglu_quant_kernel``; the
source note in ``swiglu_quant.cu`` says what bounds it on the card and how
its design answers.  One block serves a row, in registers or, for rows
wider than ``plan.MAX_REGISTER_F``, staged in shared memory, or, wider
than ``plan.MAX_F``, read twice from global memory (``plan.py``);
16-byte loads are taken where gate's and up's rows start on 16 bytes, else
the kernel's scalar instantiation reads the same chunks.
"""

import torch

from repro_torch.kernels import build
from repro_torch.kernels.swiglu_quant import plan


def swiglu_quant_cuda(gate: torch.Tensor, up: torch.Tensor,
                      gscale: torch.Tensor, uscale: torch.Tensor):
    """(m, f) int32 gate and up accumulators, (m,) f32 dequant scales, on
    the card -> ((m, f) int8, (m, 1) f32 scales).  Rows wider than
    ``plan.MAX_F`` (29040) values are looped."""
    ts = (gate, up, gscale, uscale)
    if not all(t.is_cuda and t.device == gate.device for t in ts):
        raise ValueError("swiglu_quant_cuda takes CUDA tensors on one device")
    if gate.dtype != torch.int32 or up.dtype != torch.int32 \
            or gscale.dtype != torch.float32 or uscale.dtype != torch.float32:
        raise TypeError("swiglu_quant_cuda takes int32 accumulators and f32 "
                        "scales")
    if gate.dim() != 2 or gate.shape != up.shape or gate.stride(1) != 1 \
            or up.stride(1) != 1:
        raise ValueError("swiglu_quant_cuda takes two (m, f) accumulators "
                         "with unit stride along f")
    m, f = gate.shape
    plan.check(f)
    for s in (gscale, uscale):
        if s.shape != (m,) or not s.is_contiguous():
            raise ValueError(f"swiglu_quant_cuda: scales must be contiguous "
                             f"({m},), got {tuple(s.shape)}")
    q = torch.empty((m, f), dtype=torch.int8, device=gate.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=gate.device)
    if m == 0:
        return q, scale
    vec = plan.vector_ok((gate.data_ptr(), up.data_ptr()),
                         (4 * gate.stride(0), 4 * up.stride(0)), f)
    err = build.load().swiglu_quant_launch(
        gate.data_ptr(), gate.stride(0), up.data_ptr(), up.stride(0),
        gscale.data_ptr(), uscale.data_ptr(), q.data_ptr(), scale.data_ptr(),
        m, f, int(vec), torch.cuda.current_stream(gate.device).cuda_stream)
    build.check(err, "swiglu_quant")
    swiglu_quant_cuda.launches += 1
    return q, scale


swiglu_quant_cuda.launches = 0
