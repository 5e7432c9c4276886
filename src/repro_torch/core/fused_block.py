"""The TLMM-FUSE dataflow (paper Fig. 4a) as one composed kernel pipeline.

Counterpart of ``repro/core/fused_block.py``.  The FFN of a block on packed
ternary weights runs as four kernels with only int8/int32 tensors and
(m, 1) f32 row scales flowing between the norm and the down projection:

    x --rmsnorm_quant--> (int8, scale)
        |-tlmm gate--> int32 -+
        '-tlmm up  --> int32 -+-swiglu_quant--> (int8, scale)
                                   '-tlmm down--> int32 --dequant--> x.dtype

Each wrapper launches its CUDA kernel for a CUDA tensor and takes its plain
version for a CPU tensor.  ``unfused_reference`` is the same math through
the plain packed path (float activations between the linears).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import bitlinear
from repro_torch.kernels.rmsnorm_quant import ops as rq_ops
from repro_torch.kernels.swiglu_quant import ops as sq_ops
from repro_torch.kernels.tlmm import ops as tlmm_ops
from repro_torch.models import layers


def fused_ffn_packed(mlp: nn.ModuleDict, norm_w: torch.Tensor,
                     x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm + SwiGLU FFN over packed ternary weights, fused.

    mlp: {"gate", "up", "down"} PackedLinears without bias (each carries
    its pack group); norm_w: (d,) RMSNorm weight; x: (..., d) float.
    Returns the FFN output in x.dtype (the residual add is the caller's)."""
    gate, up, down = mlp["gate"], mlp["up"], mlp["down"]
    if any(p.b is not None for p in (gate, up, down)):
        raise ValueError("fused_ffn_packed takes linears without bias")
    lead, d = x.shape[:-1], x.shape[-1]
    # 1. RMS-MAX unit: norm + absmax + int8 in one pass
    xq, xs = rq_ops.rmsnorm_quant(x.reshape(-1, d), norm_w, eps=eps)
    # 2. TLMM: gate and up projections on the packed codes
    acc_g = tlmm_ops.tlmm(xq, gate.codes, g=gate.g, n=d)
    acc_u = tlmm_ops.tlmm(xq, up.codes, g=up.g, n=d)
    # 3. TLMM-FUSE elementwise unit: dequant, SiLU(gate) * up, requant
    hq, hs = sq_ops.swiglu_quant(acc_g, acc_u, xs * gate.gamma,
                                 xs * up.gamma)
    # 4. TLMM down projection + epilogue dequant
    acc_d = tlmm_ops.tlmm(hq, down.codes, g=down.g, n=hq.shape[-1])
    y = acc_d.float() * hs * down.gamma
    return y.to(x.dtype).reshape(lead + (y.shape[-1],))


def unfused_reference(mlp: nn.ModuleDict, norm_w: torch.Tensor,
                      x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """The same math through the packed path: rmsnorm rounded to x.dtype,
    each linear quantizing its own float input."""
    h = layers.rmsnorm(layers.RMSNorm(norm_w), x, eps)
    g = bitlinear.apply_packed(mlp["gate"], h, out_dtype=torch.float32)
    u = bitlinear.apply_packed(mlp["up"], h, out_dtype=torch.float32)
    act = torch.nn.functional.silu(g) * u
    return bitlinear.apply_packed(mlp["down"], act.to(x.dtype),
                                  out_dtype=x.dtype)
