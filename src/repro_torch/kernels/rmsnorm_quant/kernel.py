"""Launch of the fused RMSNorm + int8 quant CUDA kernel
(``csrc/rmsnorm_quant.cu``).

Replaces ``repro/kernels/rmsnorm_quant/kernel.py::rmsnorm_quant_kernel``;
the source note in ``rmsnorm_quant.cu`` says what bounds it on the card and
how its design answers.
"""

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_quant_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float):
    """(m, d) f32/bf16 x, (d,) f32/bf16 w, on the card -> ((m, d) int8,
    (m, 1) f32 scales)."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("rmsnorm_quant_cuda takes CUDA tensors on one device")
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise TypeError(f"rmsnorm_quant_cuda takes f32 or bf16, got "
                        f"{x.dtype} and {w.dtype}")
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError("rmsnorm_quant_cuda takes (m, d) x with unit stride "
                         "along d")
    m, d = x.shape
    if d == 0 or w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"rmsnorm_quant_cuda: w must be a contiguous ({d},) "
                         f"tensor with d > 0, got {tuple(w.shape)}")
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, scale
    err = build.load().rmsnorm_quant_launch(
        x.data_ptr(), x.stride(0), w.data_ptr(), q.data_ptr(),
        scale.data_ptr(), m, d, eps, int(x.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_quant")
    rmsnorm_quant_cuda.launches += 1
    return q, scale


rmsnorm_quant_cuda.launches = 0
