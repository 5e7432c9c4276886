"""Launch of the TLMM CUDA kernel (``csrc/tlmm.cu``).

Replaces ``repro/kernels/tlmm/kernel.py::tlmm_kernel``; the source note in
``tlmm.cu`` says what bounds it on the card and how its design answers.
"""

import torch

from repro_torch.kernels import build


def check_operands(what: str, a_q: torch.Tensor, codes: torch.Tensor, g: int,
                   n: int) -> None:
    """Raise unless (m, >= n) int8 activations and (rows, k) uint8 codes lie
    on one CUDA device with unit stride along their last dim, and
    0 <= n <= min(a_q.shape[1], rows * g)."""
    if not (a_q.is_cuda and codes.device == a_q.device):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if a_q.dtype != torch.int8 or codes.dtype != torch.uint8:
        raise TypeError(f"{what} takes int8 activations and uint8 codes, "
                        f"got {a_q.dtype} and {codes.dtype}")
    if a_q.dim() != 2 or codes.dim() != 2:
        raise ValueError(f"{what} takes 2-D operands")
    if a_q.stride(1) != 1 or codes.stride(1) != 1:
        raise ValueError(f"{what} needs unit stride along the last dim")
    if not 0 <= n <= min(a_q.shape[1], codes.shape[0] * g):
        raise ValueError(f"reduction length {n} outside [0, "
                         f"{min(a_q.shape[1], codes.shape[0] * g)}]")


def tlmm_cuda(a_q: torch.Tensor, codes: torch.Tensor, *, g: int,
              n: int) -> torch.Tensor:
    """(m, >= n) int8 x (rows, k) uint8 base-3 codes -> (m, k) int32, summed
    over reduction indices [0, n), n <= rows * g.  CUDA tensors only; the
    kernel masks every ragged edge itself."""
    check_operands("tlmm_cuda", a_q, codes, g, n)
    m, k, rows = a_q.shape[0], codes.shape[1], codes.shape[0]
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
