"""Public wrapper of the packed ternary matmul (counterpart of
``repro/kernels/tlmm/ops.py::tlmm``)."""

from __future__ import annotations

import torch

from repro_torch.core import ternary
from repro_torch.kernels import on_card
from repro_torch.kernels.tlmm import kernel, ref


def tlmm(a_q: torch.Tensor, codes: torch.Tensor, *, g: int = ternary.DEFAULT_G,
         n: int | None = None) -> torch.Tensor:
    """Packed ternary matmul: (m, n) int8 x (rows, k) uint8 -> (m, k) int32.

    Same contract as the JAX wrapper: the reduction runs over the first
    ``n`` activation columns (default all of them); codes may be row-padded
    past n (``bitlinear.ROW_MULTIPLE``), and activations missing below
    rows * g count as zero.  A CUDA tensor launches the kernel; a CPU tensor
    takes the plain version."""
    n_in = a_q.shape[1]
    n_eff = min(n if n is not None else n_in, n_in, codes.shape[0] * g)
    if on_card(a_q, "tlmm"):
        return kernel.tlmm_cuda(a_q, codes, g=g, n=n_eff)
    return ref.tlmm_ref(a_q, codes, g, n_eff)
