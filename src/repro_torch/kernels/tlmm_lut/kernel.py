"""Launch of the table-lookup TLMM CUDA kernel (``csrc/tlmm_lut.cu``).

Replaces ``repro/kernels/tlmm_lut/kernel.py::tlmm_lut_kernel``; the source
note in ``tlmm_lut.cu`` says what bounds it on the card and how its design
answers.  The grid comes from ``tlmm/plan.py`` ``plan_tlmm_lut``.
"""

import torch

from repro_torch.kernels.tlmm import plan as tlmm_plan
from repro_torch.kernels.tlmm.kernel import launch


def tlmm_lut_cuda(a_q: torch.Tensor, codes: torch.Tensor, *, g: int,
                  n: int) -> torch.Tensor:
    """(m, >= n) int8 x (rows, k) uint8 base-3 codes -> (m, k) int32, summed
    over reduction indices [0, n), n <= rows * g, by table lookup.  CUDA
    tensors only; the kernel masks every ragged edge itself.  An empty
    reduction gives zeros without a launch."""
    out, launched = launch("tlmm_lut", tlmm_plan.plan_tlmm_lut, a_q, codes,
                           g, n)
    tlmm_lut_cuda.launches += launched
    return out


tlmm_lut_cuda.launches = 0
