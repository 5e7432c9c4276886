"""BitLinear — the paper's ternary linear layer, inference half.

Three forms of one linear, each an ``nn.Module`` holding its tensors as
buffers (counterpart of the dict pytrees of ``repro/core/bitlinear.py``):

* :class:`Linear`           — float master weights ``w`` (n_in, n_out) and an
                              optional bias ``b``; also the dense (unquantized)
                              layers such as an untied LM head.
* :class:`PackedLinear`     — base-3 packed uint8 ``codes`` (rows, n_out), the
                              per-tensor scale ``gamma``, ``b`` and the pack
                              group ``g`` the codes were made with: the
                              offline stage of TLMM.  :func:`apply_packed`
                              quantizes the activation to int8, runs the
                              packed ternary matmul and dequantizes.
* :class:`PredecodedLinear` — the codes decoded once into a dense ternary
                              matrix ``wt`` (f32 while exact, see
                              :func:`predecode`), with per-column ``gamma``:
                              the serving engine's form.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import ternary
from repro_torch.kernels.tlmm import ops as tlmm_ops
from repro_torch.kernels.tlmm_lut import ops as lut_ops

ROW_MULTIPLE = 64  # packed rows pad to this (mesh-shardable, as in JAX)
# the packed matmul of apply_packed: decode-to-int8 (JAX impl "pallas") or
# the paper's table lookup (JAX impl "pallas_lut")
MATMULS = ("tlmm", "tlmm_lut")


class Linear(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)


class PackedLinear(nn.Module):
    def __init__(self, codes: torch.Tensor, gamma: torch.Tensor,
                 b: torch.Tensor | None = None, *, g: int = ternary.DEFAULT_G):
        super().__init__()
        self.g = g   # trits per code byte: a property of the packed format
        self.register_buffer("codes", codes)
        self.register_buffer("gamma", gamma)
        self.register_buffer("b", b)


class PredecodedLinear(nn.Module):
    def __init__(self, wt: torch.Tensor, gamma: torch.Tensor,
                 b: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("wt", wt)
        self.register_buffer("gamma", gamma)
        self.register_buffer("b", b)


def init(generator: torch.Generator, n_in: int, n_out: int, *,
         bias: bool = False) -> Linear:
    """Master weights ~ N(0, 1/n_in), zero bias, drawn on the generator's
    device."""
    dev = generator.device
    w = torch.randn((n_in, n_out), generator=generator, device=dev,
                    dtype=torch.float32) / math.sqrt(n_in)
    b = torch.zeros((n_out,), device=dev) if bias else None
    return Linear(w, b)


def pack(p: Linear, g: int = ternary.DEFAULT_G,
         row_multiple: int = ROW_MULTIPLE) -> PackedLinear:
    """Offline preprocessing: absmean-ternarize, then base-3 pack with rows
    padded to ``row_multiple``."""
    wt, gamma = ternary.ternarize(p.w)
    return PackedLinear(ternary.pack_ternary(wt, g, row_multiple), gamma, p.b,
                        g=g)


def apply_packed(p: PackedLinear, x: torch.Tensor, *, matmul: str = "tlmm",
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (..., n_in) float -> (..., n_out) out_dtype.  Absmax int8 quant,
    packed ternary matmul (``matmul``: ``tlmm`` or ``tlmm_lut``, each the
    kernel for a CUDA tensor and its plain version for a CPU one; both give
    the same int32 sums), then acc * x_scale * gamma (+ b)."""
    n_in = x.shape[-1]
    lead = x.shape[:-1]
    x_q, x_scale = ternary.absmax_quant(x.reshape(-1, n_in))
    if matmul == "tlmm":
        acc = tlmm_ops.tlmm(x_q, p.codes, g=p.g, n=n_in)
    elif matmul == "tlmm_lut":
        acc = lut_ops.tlmm_lut(x_q, p.codes, g=p.g)
    else:
        raise ValueError(f"unknown matmul {matmul!r}, not one of {MATMULS}")
    y = acc.float() * x_scale * p.gamma
    if p.b is not None:
        y = y + p.b.float()
    return y.to(out_dtype).reshape(lead + (p.codes.shape[-1],))


# The pre-decoded GEMM stays exact while |acc| <= n * 127 < 2^24.
_EXACT_F32_ROWS = (1 << 24) // 127


def predecode(p: PackedLinear) -> PredecodedLinear:
    """Decode the codes into a dense ternary matrix (rows * g, n_out).

    Below 2^24 / 127 reduction rows the matrix is kept in f32: operands are
    integers and every partial sum an exactly representable f32 integer, so
    the f32 GEMM equals int32 accumulation in any summation order (TF32 is
    pinned off when the package is imported)."""
    wt = ternary.unpack_ternary(p.codes, p.g)
    if wt.shape[0] < _EXACT_F32_ROWS:
        wt = wt.float()
    return PredecodedLinear(wt, p.gamma, p.b)


def predecode_fused(parts: list) -> PredecodedLinear:
    """Fuse linears that share their input (QKV, gate|up) into one
    pre-decoded matrix with a per-column gamma — one activation quant and
    one GEMM instead of one per part, with identical per-column results."""
    dec = [predecode(q) for q in parts]
    wt = torch.cat([d.wt for d in dec], dim=1)
    gamma = torch.cat([d.gamma.expand(d.wt.shape[1]) for d in dec])
    b = None
    if any(d.b is not None for d in dec):
        b = torch.cat([d.b if d.b is not None else
                       torch.zeros(d.wt.shape[1], device=wt.device)
                       for d in dec])
    return PredecodedLinear(wt, gamma, b)


def apply_predecoded(p: PredecodedLinear, x: torch.Tensor, *,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Same result as :func:`apply_packed`: the same int8 quantization (kept
    in f32 on the exact-GEMM path), the same zero padding to rows * g, and
    the same epilogue."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    n_pad = p.wt.shape[0]
    if p.wt.dtype == torch.float32:
        x_q, x_scale = ternary.absmax_quant_values(xf)
        x_q = torch.nn.functional.pad(x_q, (0, n_pad - x_q.shape[-1]))
        acc = x_q @ p.wt
    else:
        x_q, x_scale = ternary.absmax_quant(xf)
        x_q = torch.nn.functional.pad(x_q, (0, n_pad - x_q.shape[-1]))
        acc = ternary.ternary_matmul_ref(x_q, p.wt).float()
    y = acc * x_scale * p.gamma
    if p.b is not None:
        y = y + p.b.float()
    return y.to(out_dtype).reshape(lead + (p.wt.shape[-1],))
