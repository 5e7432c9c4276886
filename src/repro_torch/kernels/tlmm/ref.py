"""Plain PyTorch version of the TLMM kernel."""

import torch

from repro_torch.core import ternary


def tlmm_ref(a_q: torch.Tensor, codes: torch.Tensor, g: int,
             n: int | None = None) -> torch.Tensor:
    """(m, >= n) int8 x packed (rows, k) uint8 -> (m, k) int32, summed over
    the first n reduction indices (n <= rows * g; default rows * g)."""
    n = n if n is not None else codes.shape[0] * g
    wt = ternary.unpack_ternary(codes, g, n)
    return ternary.ternary_matmul_ref(a_q[:, :n], wt)
