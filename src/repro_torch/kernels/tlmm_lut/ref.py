"""Plain PyTorch version of the table-lookup TLMM kernel."""

import torch

from repro_torch.core import ternary


def tlmm_lut_ref(a_q: torch.Tensor, codes: torch.Tensor, g: int,
                 n: int | None = None) -> torch.Tensor:
    """(m, >= n) int8 x packed (rows, k) uint8 -> (m, k) int32 by table
    lookup over the first n reduction indices (n <= rows * g; default
    rows * g)."""
    n = n if n is not None else codes.shape[0] * g
    return ternary.ternary_matmul_lut_ref(a_q[:, :n], codes[:-(-n // g)], g)
