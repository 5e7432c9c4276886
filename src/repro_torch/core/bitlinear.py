"""BitLinear — the paper's ternary linear layer: QAT training and inference.

Three forms of one linear, each an ``nn.Module`` holding its tensors as
buffers (counterpart of the dict pytrees of ``repro/core/bitlinear.py``):

* :class:`Linear`           — float master weights ``w`` (n_in, n_out) and an
                              optional bias ``b``; also the dense (unquantized)
                              layers such as an untied LM head.
                              :func:`apply_qat` is its training forward:
                              fake-quant ternary W and int8 x with
                              straight-through estimators.
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
from repro_torch.runtime.sharding import Part

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


def apply_qat(p: Linear, x: torch.Tensor, *, int8_fwd: bool = False,
              parts=None) -> torch.Tensor:
    """Training forward: fake-quant W (absmean ternary) and x (absmax int8),
    each with a straight-through estimator, then a dense product.  With
    ``int8_fwd`` the forward contraction runs on integer values
    (:class:`Int8STEMatmul`) and the backward stays the float STE one.
    ``parts`` (``runtime.sharding.LinearParts``, on a training mesh): how
    ``p.w`` and ``x`` are this rank's blocks, so that gamma and each
    token's absmax are the whole tensors' (a row-parallel linear's output
    is then a partial sum, which the caller reduces)."""
    if int8_fwd:
        y = Int8STEMatmul.apply(x, p.w, parts)
    elif parts is None:
        w = ternary.ternarize_ste(p.w)
        x = ternary.absmax_quant_ste(x)
        y = x @ w.to(x.dtype)
    else:
        w = ternary.ternarize_ste(p.w, part=parts.w)
        x = ternary.absmax_quant_ste(x, part=parts.x)
        y = x @ w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


# An f32 product of integer values is exact while every partial sum stays
# below 2^24: int8 activations (|q| <= 127) times ternary weights.
_EXACT_F32_REDUCTION = (1 << 24) // 127


def int8_operands(x: torch.Tensor, w: torch.Tensor, parts=None) -> tuple:
    """The integer path's quantized operands as f32: (x's int8 values, its
    per-token scales, gamma).  ``parts`` as in :func:`apply_qat`."""
    xq, xs = ternary.absmax_quant_values(
        x, reciprocal=True, part=parts.x if parts is not None else None)
    gamma = ternary.ste_gamma(w, part=parts.w if parts is not None else None)
    return xq, xs, gamma


class Int8STEMatmul(torch.autograd.Function):
    """(..., n) x (n, k): the QAT forward on the integer path, STE backward.

    Forward: absmax int8 x, absmean ternary w, their exact integer product
    (integer-valued f32 operands, exact while n * 127 < 2^24, asserted),
    then ``acc * x_scale * gamma``.  Backward, straight through both
    quantizers as the reference's ``_int8_bwd``: dx = g (gamma W_t)^T,
    dW = x_hat^T g, with x_hat the dequantized int8 activations.  The
    reference computes both with ``jnp.dot`` outside any Pallas kernel.
    ``parts`` as in :func:`apply_qat`: gamma and each token's absmax are
    the whole tensors'.  The forward keeps the int8 values, their scales
    and gamma for the backward, which so issues no collective."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                parts=None) -> torch.Tensor:
        n = x.shape[-1]
        assert n < _EXACT_F32_REDUCTION, (
            f"reduction {n} too long for an exact f32 integer product")
        xq, xs, gamma = int8_operands(x, w, parts)
        wt = torch.clamp(torch.round(w.float() / gamma), -1.0, 1.0)
        acc = xq.reshape(-1, n) @ wt
        y = (acc * xs.reshape(-1, 1) * gamma).to(x.dtype)
        ctx.save_for_backward(xq.to(torch.int8), xs, w, gamma)
        ctx.x_dtype = x.dtype
        return y.reshape(x.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xq, xs, w, gamma = ctx.saved_tensors
        wt = torch.clamp(torch.round(w.float() / gamma), -1.0, 1.0)
        w_deq = (wt * gamma).to(ctx.x_dtype)
        x_deq = (xq.float() * xs).to(ctx.x_dtype)
        dx = g @ w_deq.t()
        dw = (x_deq.reshape(-1, xq.shape[-1]).t()
              @ g.reshape(-1, g.shape[-1])).to(w.dtype)
        return dx, dw, None


def apply_packed(p: PackedLinear, x: torch.Tensor, *, matmul: str = "tlmm",
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x: (..., n_in) float -> (..., n_out) out_dtype.  Absmax int8 quant,
    packed ternary matmul (``matmul``: ``tlmm`` or ``tlmm_lut``, each the
    kernel for a CUDA tensor and its plain version for a CPU one; both give
    the same int32 sums), then acc * x_scale * gamma (+ b)."""
    n_in = x.shape[-1]
    lead = x.shape[:-1]
    x_q, x_scale = ternary.absmax_quant(x.reshape(-1, n_in))
    return _epilogue(p, _packed_matmul(x_q, p, n_in, matmul), x_scale,
                     lead, out_dtype)


def _packed_matmul(x_q: torch.Tensor, p: PackedLinear, n: int,
                   matmul: str) -> torch.Tensor:
    # the kernels take rows of unit stride: codes gathered over a mesh
    # (``Constrain.whole``) or a block of a gathered input may be views
    x_q, codes = x_q.contiguous(), p.codes.contiguous()
    if matmul == "tlmm":
        return tlmm_ops.tlmm(x_q, codes, g=p.g, n=n)
    if matmul == "tlmm_lut":
        return lut_ops.tlmm_lut(x_q, codes, g=p.g)
    raise ValueError(f"unknown matmul {matmul!r}, not one of {MATMULS}")


def _epilogue(p: PackedLinear, acc: torch.Tensor, x_scale: torch.Tensor,
              lead: tuple, out_dtype: torch.dtype) -> torch.Tensor:
    y = acc.float() * x_scale * p.gamma
    if p.b is not None:
        y = y + p.b.float()
    return y.to(out_dtype).reshape(lead + (p.codes.shape[-1],))


def packed_rows_acc(p: PackedLinear, x: torch.Tensor, mesh, axis: str,
                    matmul: str = "tlmm") -> tuple:
    """The int32 sums of a row-parallel packed linear, summed over
    ``axis`` (see :func:`apply_packed_rows`): ((m, n_out) int32, equal to
    the single device's accumulator, the (m, 1) f32 scales, x's leading
    shape)."""
    lead = x.shape[:-1]
    x_q, x_scale = ternary.absmax_quant(x.reshape(-1, x.shape[-1]),
                                        part=Part(mesh, (None, axis)))
    x_q = mesh.all_gather(x_q, axis, 1)   # the whole int8 input
    width = p.codes.shape[0] * p.g
    lo = mesh.index(axis) * width
    mine = x_q[:, lo:lo + width]
    mine = torch.nn.functional.pad(mine, (0, width - mine.shape[1]))
    acc = mesh.all_reduce(_packed_matmul(mine, p, width, matmul), axis)
    return acc, x_scale, lead


def apply_packed_rows(p: PackedLinear, x: torch.Tensor, mesh, *,
                      axis: str = "model", matmul: str = "tlmm",
                      out_dtype: torch.dtype = torch.bfloat16,
                      seq_part: bool = False) -> torch.Tensor:
    """A row-parallel packed linear (``o``, ``down`` under JAX's
    ``param_spec``): ``p.codes`` is this rank's block of R packed rows of
    the whole (R * m, n_out), ``x`` (..., n_in / m) its block of the input
    features.  The rows are padded to ``ROW_MULTIPLE``, so this rank's rows
    cover the inputs [i R g, (i + 1) R g) of the whole, not its own feature
    block (a block may be all padding).  So each token's absmax is the
    MAX over ``axis`` of its blocks' (exact), each rank quantizes its block
    with it, the int8 blocks are gathered whole (the single device's
    operand, bit for bit), this rank takes the inputs its rows cover (zero
    past n_in), and the int32 partial sums are summed over ``axis``
    (exact) before the epilogue: the single device's output on every rank,
    or with ``seq_part`` (x (b, t, ...) under sequence parallelism) this
    rank's block of its sequence.  The codes are never repacked."""
    acc, x_scale, lead = packed_rows_acc(p, x, mesh, axis, matmul)
    if seq_part:   # the epilogue on this rank's part of the sequence
        n = acc.shape[-1]
        acc = mesh.local(acc.reshape(lead + (n,)), axis, 1)
        x_scale = mesh.local(x_scale.reshape(lead + (1,)), axis, 1)
        lead = acc.shape[:-1]
        acc, x_scale = acc.reshape(-1, n), x_scale.reshape(-1, 1)
    return _epilogue(p, acc, x_scale, lead, out_dtype)


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
