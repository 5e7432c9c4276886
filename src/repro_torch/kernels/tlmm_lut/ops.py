"""Public wrapper of the table-lookup ternary matmul (counterpart of
``repro/kernels/tlmm_lut/ops.py::tlmm_lut``)."""

from __future__ import annotations

import torch

from repro_torch.core import ternary
from repro_torch.kernels import on_card
from repro_torch.kernels.tlmm_lut import kernel, ref


def tlmm_lut(a_q: torch.Tensor, codes: torch.Tensor, *,
             g: int = ternary.PAPER_G) -> torch.Tensor:
    """Table-lookup ternary matmul (the paper's Method 3): (m, n) int8 x
    (rows, k) uint8 -> (m, k) int32, equal to ``tlmm`` on the same operands.

    Same contract as the JAX wrapper: the reduction runs over rows * g;
    activations missing there count as zero, and code rows missing below
    the activations' groups as the all-zero code, so the sum covers the
    first min(n, rows * g) activation columns.  A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    n_eff = min(a_q.shape[1], codes.shape[0] * g)
    if on_card(a_q, "tlmm_lut"):
        return kernel.tlmm_lut_cuda(a_q, codes, g=g, n=n_eff)
    return ref.tlmm_lut_ref(a_q, codes, g, n_eff)
