"""Launch of the table-lookup TLMM CUDA kernel (``csrc/tlmm_lut.cu``).

Replaces ``repro/kernels/tlmm_lut/kernel.py::tlmm_lut_kernel``; the source
note in ``tlmm_lut.cu`` says what bounds it on the card and how its design
answers.
"""

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tlmm.kernel import check_operands


def tlmm_lut_cuda(a_q: torch.Tensor, codes: torch.Tensor, *, g: int,
                  n: int) -> torch.Tensor:
    """(m, >= n) int8 x (rows, k) uint8 base-3 codes -> (m, k) int32, summed
    over reduction indices [0, n), n <= rows * g, by table lookup.  CUDA
    tensors only; the kernel masks every ragged edge itself."""
    check_operands("tlmm_lut_cuda", a_q, codes, g, n)
    m, k, rows = a_q.shape[0], codes.shape[1], codes.shape[0]
    out = torch.zeros((m, k), dtype=torch.int32, device=a_q.device)
    if m == 0 or k == 0:
        return out
    lib = build.load()
    err = lib.tlmm_lut_launch(a_q.data_ptr(), a_q.stride(0), codes.data_ptr(),
                              codes.stride(0), out.data_ptr(), m, k, rows, n,
                              g, torch.cuda.current_stream(a_q.device
                                                           ).cuda_stream)
    build.check(err, "tlmm_lut")
    tlmm_lut_cuda.launches += 1
    return out


tlmm_lut_cuda.launches = 0
