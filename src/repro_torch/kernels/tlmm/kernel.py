"""Launch of the TLMM CUDA kernel (``csrc/tlmm.cu``).

Replaces ``repro/kernels/tlmm/kernel.py::tlmm_kernel``; the source note in
``tlmm.cu`` says what bounds it on the card and how its design answers.
"""

import torch

from repro_torch.kernels import build


def tlmm_cuda(a_q: torch.Tensor, codes: torch.Tensor, *, g: int,
              n: int) -> torch.Tensor:
    """(m, >= n) int8 x (rows, k) uint8 base-3 codes -> (m, k) int32, summed
    over reduction indices [0, n), n <= rows * g.  CUDA tensors only; the
    kernel masks every ragged edge itself."""
    if not (a_q.is_cuda and codes.device == a_q.device):
        raise ValueError("tlmm_cuda takes CUDA tensors on one device")
    if a_q.dtype != torch.int8 or codes.dtype != torch.uint8:
        raise TypeError(f"tlmm_cuda takes int8 activations and uint8 codes, "
                        f"got {a_q.dtype} and {codes.dtype}")
    if a_q.dim() != 2 or codes.dim() != 2:
        raise ValueError("tlmm_cuda takes 2-D operands")
    if a_q.stride(1) != 1 or codes.stride(1) != 1:
        raise ValueError("tlmm_cuda needs unit stride along the last dim")
    m, k, rows = a_q.shape[0], codes.shape[1], codes.shape[0]
    if not 0 <= n <= min(a_q.shape[1], rows * g):
        raise ValueError(f"reduction length {n} outside [0, "
                         f"{min(a_q.shape[1], rows * g)}]")
    out = torch.empty((m, k), dtype=torch.int32, device=a_q.device)
    if m == 0 or k == 0:
        return out
    lib = build.load()
    err = lib.tlmm_launch(a_q.data_ptr(), a_q.stride(0), codes.data_ptr(),
                          codes.stride(0), out.data_ptr(), m, k, rows, n, g,
                          torch.cuda.current_stream(a_q.device).cuda_stream)
    build.check(err, "tlmm")
    tlmm_cuda.launches += 1
    return out


tlmm_cuda.launches = 0
