"""Shared model layers: execution context, linear dispatch, RMSNorm, RoPE
(paper eq. 4/5), SwiGLU MLP and the token embedding.

Counterpart of ``repro/models/layers.py`` for attention-block decoders.
Parameters are ``nn.Module``s holding buffers; the functions are plain
functions on tensors, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core import bitlinear
from repro_torch.core.bitlinear import Linear, PackedLinear, PredecodedLinear

# whole-prompt attention of Ctx.attn: the kernel and the two Fig. 6b baselines
ATTNS = ("kernel", "skip", "naive")

@dataclasses.dataclass(frozen=True)
class Ctx:
    """Execution context threaded through the model.

    Every ternary matmul and attention call goes through a kernel wrapper
    (JAX's ``attn_impl="pallas"``), which launches the hand-written CUDA
    kernel for a CUDA tensor and takes the kernel's plain version for a CPU
    tensor.  ``matmul`` chooses the packed linears' kernel: ``"tlmm"``
    (JAX's ``impl="pallas"``) or the paper's table lookup ``"tlmm_lut"``
    (``impl="pallas_lut"``).  Both give the same int32 sums.  Pre-decoded
    linears (the serving engine's) ignore it, as in JAX.

    ``attn`` chooses the whole-prompt attention of ``prefill_step``:
    ``"kernel"`` (the flash prefill kernel, JAX's ``attn_impl="pallas"``),
    or the paper's Fig. 6b baselines in plain PyTorch, ``"skip"`` (only the
    causally live tiles, JAX's ``"xla"``) and ``"naive"`` (every tile, masked
    afterwards, ``"xla_naive"``), on ``attn_q_chunk`` x ``attn_kv_chunk``
    tiles.  Admission chunks and decode stay on their kernels, as both JAX
    XLA paths share theirs.

    ``kv_splits`` = K >= 1 routes every decode attention read through the
    split-K formulation (``kernels.decode_attention.ops.splitk_partials``
    and ``splitk_combine``) instead of the decode kernels, as in JAX.  With
    ``kv_group`` (a ``torch.distributed`` process group of
    ``kv_group_size`` ranks, the mesh's ``model`` axis; JAX's
    ``kv_shard_axis``/``kv_shard_size``) each rank computes K / size chunks
    and the partials are all-gathered in rank order before the combine.
    """
    act_dtype: torch.dtype = torch.float32
    matmul: str = "tlmm"
    attn: str = "kernel"
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 512
    kv_splits: int = 0
    kv_group: object = None
    kv_group_size: int = 1

    def __post_init__(self):
        if self.matmul not in bitlinear.MATMULS:
            raise ValueError(f"Ctx.matmul {self.matmul!r} not one of "
                             f"{bitlinear.MATMULS}")
        if self.attn not in ATTNS:
            raise ValueError(f"Ctx.attn {self.attn!r} not one of {ATTNS}")


# ---------------------------------------------------------------------------
# Linear dispatch
# ---------------------------------------------------------------------------

def linear_apply(p: nn.Module, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    if isinstance(p, PredecodedLinear):   # serving engine's hot path
        return bitlinear.apply_predecoded(p, x, out_dtype=x.dtype)
    if isinstance(p, PackedLinear):       # packed inference params
        return bitlinear.apply_packed(p, x, matmul=ctx.matmul,
                                      out_dtype=x.dtype)
    if isinstance(p, Linear):             # dense layer (untied LM head)
        y = x @ p.w.to(x.dtype)
        return y + p.b.to(y.dtype) if p.b is not None else y
    raise TypeError(f"not a linear: {type(p).__name__}")


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE — both of the paper's formulations
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, hd: int, theta: float
                ) -> torch.Tensor:
    """(s,) or (b, s) int positions -> (s, hd/2) or (b, s, hd/2) angles
    (the batched form carries ragged per-slot decode positions)."""
    t = torch.arange(hd // 2, dtype=torch.float32, device=positions.device)
    inv_freq = torch.pow(theta, -2.0 * t / hd)
    return positions.float()[..., None] * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor, style: str
               ) -> torch.Tensor:
    """x: (..., s, n_heads, hd); angles: (s, hd/2) or (b, s, hd/2).
    "consecutive" rotates contiguous halves (paper eq. 5), "interleaved"
    rotates adjacent pairs (eq. 4)."""
    cos = torch.cos(angles)[..., :, None, :].to(x.dtype)
    sin = torch.sin(angles)[..., :, None, :].to(x.dtype)
    hd = x.shape[-1]
    if style == "consecutive":
        x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if style == "interleaved":
        x1, x2 = x[..., 0::2], x[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.reshape(x.shape)
    raise ValueError(style)


# ---------------------------------------------------------------------------
# SwiGLU MLP (gate/up/down — the three TLMM sizes)
# ---------------------------------------------------------------------------

def mlp_apply(p: nn.ModuleDict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    if "gateup" in p:   # fused projection (pre-decoded serving hot path)
        g, u = linear_apply(p["gateup"], x, ctx).chunk(2, dim=-1)
    else:
        g = linear_apply(p["gate"], x, ctx)
        u = linear_apply(p["up"], x, ctx)
    h = torch.nn.functional.silu(g.float()) * u.float()
    return linear_apply(p["down"], h.to(x.dtype), ctx)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, tok: torch.Tensor):
        super().__init__()
        self.register_buffer("tok", tok)


def embed_apply(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.tok[tokens]
