"""Ternary (1.58-bit) quantization and base-3 packing — the paper's W1.58A8.

Weights are in {-1, 0, +1} with one per-tensor f32 scale (BitNet b1.58
absmean recipe); activations are int8 with a per-token absmax scale.
Groups of ``g`` ternary values along the reduction axis are packed into one
base-3 code ``sum_i (w_i + 1) * 3^i``: g=5 fits a uint8 (1.6 bits/weight),
the paper's FPGA uses g=3.

Counterpart of ``repro/core/ternary.py``.  Every function computes the same
integers as the JAX one from the same inputs: ``torch.round`` rounds half to
even like ``jnp.round``, and IEEE division is correctly rounded in both.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed

DEFAULT_G = 5   # 3^5 = 243 codes fit a uint8 (the paper's FPGA uses 3)
PAPER_G = 3     # the paper's FPGA group: 27 codes, 5-bit indices

_POW3 = (1, 3, 9, 27, 81, 243, 729)
INV_127 = 1.0 / 127.0   # f32(1/127) in any f32 product


def num_codes(g: int) -> int:
    """Number of distinct base-3 codes of a group of g (the paper's N_TB)."""
    return 3 ** g


def index_bits(g: int) -> int:
    """Bit width of one group index (the paper's B_idx = ceil(log2 3^g))."""
    return (3 ** g - 1).bit_length()


def bits_per_weight(g: int, container_bits: int = 8) -> float:
    """Effective bits a weight when each group index lives in its own
    container: 1.6 at g = 5 in a byte; the paper packs 5-bit (g = 3)
    indices into 72-bit URAM words, 1.67 bits a weight."""
    return container_bits / g


# ---------------------------------------------------------------------------
# Ternary weight quantization (BitNet b1.58 absmean recipe)
# ---------------------------------------------------------------------------

def absmean_scale(w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-tensor absmean scale: gamma = max(mean(|W|), eps), f32 scalar."""
    return torch.clamp_min(w.float().abs().mean(), eps)


def ternarize(w: torch.Tensor, eps: float = 1e-5
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W_t = clip(round(W / gamma), -1, 1) -> (int8 ternary, f32 gamma)."""
    gamma = absmean_scale(w, eps)
    wt = torch.clamp(torch.round(w.float() / gamma), -1.0, 1.0)
    return wt.to(torch.int8), gamma


def ternarize_ste(w: torch.Tensor, eps: float = 1e-5,
                  dims: Tuple[int, ...] | None = None, *,
                  part=None) -> torch.Tensor:
    """Fake-quant ternarization with a straight-through estimator (the
    training path): forward ``w + (gamma * W_t - w)``, which in f32 is not
    always bit-equal to ``gamma * W_t``; backward the identity to ``w``.
    ``dims`` are the axes of one absmean gamma: all of them by default,
    ``(1, 2)`` for an (E, n_in, n_out) expert bank, a gamma an expert as
    JAX's ``jax.vmap(ternarize_ste)``.  Built in place on one temporary (a
    full-width expert bank is 3.2 GB).  ``part`` (a
    ``runtime.sharding.Part``): ``w`` is this rank's block of a split
    weight, whose gamma is the whole weight's mean: the block's sum of |w|,
    summed over the axes that split it, over the whole count."""
    return ternary_ste_at(w, ste_gamma(w, eps, dims, part=part))


def ste_gamma(w: torch.Tensor, eps: float = 1e-5,
              dims: Tuple[int, ...] | None = None, *,
              part=None) -> torch.Tensor:
    """``ternarize_ste``'s absmean gamma: a scalar, or one a slice of
    ``dims`` (kept as size-1 dims)."""
    with torch.no_grad():
        a = w.float().abs()
        if part is not None and part.splits(range(w.dim())):
            total = part.reduce(a.sum(), torch.distributed.ReduceOp.SUM,
                                range(w.dim()))
            return torch.clamp_min(total / part.numel(w.shape), eps)
        return torch.clamp_min(
            a.mean() if dims is None else a.mean(dim=dims, keepdim=True),
            eps)


def ternary_ste_at(w: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """``ternarize_ste``'s value at a given gamma, straight through: two
    weights that agree element for element, and their gammas, give the
    same values."""
    with torch.no_grad():
        d = w.float() / gamma
        d = d.round_().clamp_(-1.0, 1.0).mul_(gamma).to(w.dtype).sub_(w)
    return w + d


# ---------------------------------------------------------------------------
# INT8 activation quantization (per-token absmax)
# ---------------------------------------------------------------------------

def absmax_quant_values(x: torch.Tensor, dim: int = -1, eps: float = 1e-5,
                        *, reciprocal: bool = False, part=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """absmax_quant with the quantized values kept in f32 (already rounded
    and clipped) — the exact-GEMM operand of the pre-decoded path.

    The scale is ``amax / 127`` as the JAX function writes it.  Where it
    runs, that is a product by f32(1/127) in JAX under ``jit`` (XLA's
    rewrite of a division by a constant) and in PyTorch on the card
    (ATen's division by a Python scalar), a true quotient in eager JAX and
    in PyTorch on the CPU.  ``reciprocal`` takes the product everywhere:
    the arithmetic of the JAX kernels, which always run jitted.  ``part``
    (a ``runtime.sharding.Part``): ``x``'s ``dim`` is split over ranks, and
    its max is taken over all of them (exact)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    if part is not None:
        amax = part.reduce(amax, torch.distributed.ReduceOp.MAX, (dim,))
    amax = torch.clamp_min(amax, eps)
    scale = amax * INV_127 if reciprocal else amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q, scale


def absmax_quant(x: torch.Tensor, dim: int = -1, eps: float = 1e-5, *,
                 reciprocal: bool = False, part=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax int8 quantization: (int8 values, f32 scale with the
    quantized dim kept at size 1) such that x ~= values * scale; the scale
    and ``part`` as in :func:`absmax_quant_values`."""
    q, scale = absmax_quant_values(x, dim, eps, reciprocal=reciprocal,
                                   part=part)
    return q.to(torch.int8), scale


def absmax_quant_ste(x: torch.Tensor, dim: int = -1, eps: float = 1e-5, *,
                     part=None) -> torch.Tensor:
    """Fake-quant absmax int8 with a straight-through estimator (the
    training path): forward ``x + (q * scale - x)``, backward the identity.
    The scale is ``amax * f32(1/127)``: the reference's training step runs
    jitted, where XLA turns its ``/ 127.0`` into that product, and so does
    ATen's division on the card.  ``part`` as in
    :func:`absmax_quant_values`."""
    q, scale = absmax_quant(x, dim, eps, reciprocal=True, part=part)
    xq = (q.float() * scale).to(x.dtype)
    return x + (xq - x).detach()


# ---------------------------------------------------------------------------
# Base-3 group packing (the TLMM weight-index encoding)
# ---------------------------------------------------------------------------

def pad_to_group(n: int, g: int) -> int:
    return ((n + g - 1) // g) * g


def pack_ternary(wt: torch.Tensor, g: int = DEFAULT_G,
                 row_multiple: int = 1) -> torch.Tensor:
    """int8 {-1,0,1} (n, ...) -> uint8 codes (rows, ...), rows = ceil(n/g)
    rounded up to ``row_multiple``.  Padding rows hold weight 0 (digit 1),
    the paper's WBMU buffer padding."""
    if g > 5:
        raise ValueError("g > 5 does not fit a uint8 container")
    n = wt.shape[0]
    n_pad = pad_to_group(n, g * row_multiple)
    digits = wt.to(torch.int32) + 1                       # {0, 1, 2}
    if n_pad != n:
        pad = torch.ones((n_pad - n,) + tuple(wt.shape[1:]),
                         dtype=torch.int32, device=wt.device)
        digits = torch.cat([digits, pad], dim=0)
    grouped = digits.reshape((n_pad // g, g) + tuple(wt.shape[1:]))
    pow3 = torch.tensor(_POW3[:g], dtype=torch.int32, device=wt.device)
    pow3 = pow3.reshape((1, g) + (1,) * (wt.dim() - 1))
    return (grouped * pow3).sum(dim=1).to(torch.uint8)


def unpack_ternary(codes: torch.Tensor, g: int = DEFAULT_G,
                   n: int | None = None) -> torch.Tensor:
    """Inverse of pack_ternary: uint8 codes -> int8 {-1,0,1} along dim 0,
    cut to the first ``n`` rows when given."""
    c = codes.to(torch.int32)
    digs = []
    for _ in range(g):
        digs.append(c % 3 - 1)
        c = c // 3
    w = torch.stack(digs, dim=1)                           # (groups, g, ...)
    w = w.reshape((codes.shape[0] * g,) + tuple(codes.shape[1:]))
    if n is not None:
        w = w[:n]
    return w.to(torch.int8)


# ---------------------------------------------------------------------------
# Plain ternary matmul
# ---------------------------------------------------------------------------

def ternary_matmul_ref(a_q: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """int8 activations (m, n) x ternary int8 (n, k) -> int32 (m, k).

    Computed as a float64 product, which is exact for every integer sum
    below 2^53 whatever the summation order, and runs on the CPU and on the
    card alike (the card has no int32 matmul in PyTorch)."""
    return (a_q.double() @ wt.double()).to(torch.int32)


def enumeration_matrix(g: int, dtype: torch.dtype = torch.int8,
                       device=None) -> torch.Tensor:
    """C in {-1,0,1}^{g x 3^g}: column c holds the digits of code c, so
    ``a_grouped @ C`` is every table of the paper's precompute unit."""
    codes = torch.arange(3 ** g, device=device)
    rows = []
    for _ in range(g):
        rows.append(codes % 3 - 1)
        codes = codes // 3
    return torch.stack(rows).to(dtype)


# Elements of one (m, groups, k) lookup block of ternary_matmul_lut_ref:
# bounds its memory whatever the shape.
_LUT_BLOCK_ELEMS = 1 << 25


def ternary_matmul_lut_ref(a_q: torch.Tensor, codes: torch.Tensor, g: int
                           ) -> torch.Tensor:
    """Table-lookup matmul (the paper's Method 3, full table): int8 (m, n)
    x base-3 codes (groups, k), n <= groups * g -> int32 (m, k).

    Stage 1 (precompute): tables[m, group, c] = sum over the group of
    a[m, group * g + i] * digit_i(c) = a_grouped @ C.  Stage 2 (lookup):
    out[m, k] = sum over groups of tables[m, group, codes[group, k]].
    Groups are taken in blocks so that no (m, groups, k) lookup exceeds
    ``_LUT_BLOCK_ELEMS`` elements; int32 sums are exact in any order."""
    m, n = a_q.shape
    n_groups, k = codes.shape
    a = torch.nn.functional.pad(a_q.to(torch.int32), (0, n_groups * g - n))
    a_grouped = a.reshape(m, n_groups, g)
    c_mat = enumeration_matrix(g, torch.int32, a_q.device)       # (g, 3^g)
    out = torch.zeros((m, k), dtype=torch.int32, device=a_q.device)
    step = max(1, _LUT_BLOCK_ELEMS // max(1, m * k, m * g * 3 ** g))
    for lo in range(0, n_groups, step):
        blk = a_grouped[:, lo:lo + step]
        # integer "matmul" as a broadcast product: the card has no int32 GEMM
        tables = (blk[..., None] * c_mat).sum(dim=2, dtype=torch.int32)
        idx = codes[lo:lo + step].long()[None].expand(m, -1, -1)
        out += torch.gather(tables, 2, idx).sum(dim=1, dtype=torch.int32)
    return out
