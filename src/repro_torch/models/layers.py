"""Shared model layers: execution context, linear dispatch, RMSNorm, RoPE
(paper eq. 4/5), SwiGLU MLP, the top-k MoE with ternary expert banks and
the token embedding.

Counterpart of ``repro/models/layers.py`` for attention-block decoders.
Parameters are ``nn.Module``s holding buffers; the functions are plain
functions on tensors, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from repro_torch.core import bitlinear, ternary
from repro_torch.core.bitlinear import Linear, PackedLinear, PredecodedLinear
from repro_torch.kernels.tlmm import ops as tlmm_ops
from repro_torch.runtime.sharding import Part, Rows

# whole-prompt attention of Ctx.attn: the kernel and the two Fig. 6b baselines
ATTNS = ("kernel", "skip", "naive")
# what a master (float) linear computes: fake-quant training, or unquantized
MODES = ("qat", "packed", "dense")
REMAT_POLICIES = ("nothing", "dots")


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

    ``moe_token_chunk`` = C > 0 dispatches an MoE layer's tokens C at a
    time when there are more than C of them and C divides their count, as
    JAX's scan over token chunks does: capacity then counts a chunk.

    ``mode`` says what a master (float) ``Linear`` computes, as in JAX:
    ``"qat"`` (the default) fake-quantizes its weights and activations
    (``bitlinear.apply_qat``; with ``qat_int8_fwd`` the forward product runs
    on integer values), ``"packed"`` and ``"dense"`` apply it unquantized.
    A linear the model marks dense (``ternary_w=False``: the untied LM head
    unless ``cfg.ternary_head``, the MoE router) is dense in every mode;
    packed and pre-decoded linears ignore ``mode``.  ``remat_policy`` is
    what a training forward keeps of each block for the backward:
    ``"nothing"`` (every block recomputed) or ``"dots"`` (its linear
    products kept, the rest recomputed).  ``constrain`` is a training
    mesh's hook (``runtime.sharding.make_constrain``: its groups, how the
    batch and each weight are split); the model calls ``c(x, kind)`` where
    JAX calls ``ctx.c`` and at the edges of each tensor-parallel region,
    and the linears, the embedding and the loss consult it.  Training runs
    attention on
    ``attn="skip"`` (JAX's default ``attn_impl="xla"``), whose backward is
    the flash recomputation; the attention kernel has no backward.
    """
    act_dtype: torch.dtype = torch.float32
    matmul: str = "tlmm"
    attn: str = "kernel"
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 512
    kv_splits: int = 0
    kv_group: object = None
    kv_group_size: int = 1
    moe_token_chunk: int = 0
    mode: str = "qat"
    qat_int8_fwd: bool = False
    remat_policy: str = "nothing"
    constrain: object = None

    def c(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """``constrain(x, kind)``, or x without a training mesh."""
        return self.constrain(x, kind) if self.constrain is not None else x

    def __post_init__(self):
        if self.matmul not in bitlinear.MATMULS:
            raise ValueError(f"Ctx.matmul {self.matmul!r} not one of "
                             f"{bitlinear.MATMULS}")
        if self.attn not in ATTNS:
            raise ValueError(f"Ctx.attn {self.attn!r} not one of {ATTNS}")
        if self.mode not in MODES:
            raise ValueError(f"Ctx.mode {self.mode!r} not one of {MODES}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"Ctx.remat_policy {self.remat_policy!r} not "
                             f"one of {REMAT_POLICIES}")


class Params(nn.Module):
    """Named linears (submodules) and dense tensors (buffers) of one
    sub-layer, read as ``p[name]`` like the JAX package's dict."""

    def __init__(self, **items):
        super().__init__()
        for name, v in items.items():
            if isinstance(v, nn.Module):
                self.add_module(name, v)
            else:
                self.register_buffer(name, v)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._modules or name in self._buffers

    def items(self):
        return list(self._modules.items()) + list(self._buffers.items())


# ---------------------------------------------------------------------------
# Linear dispatch
# ---------------------------------------------------------------------------

def linear_init(generator: torch.Generator, n_in: int, n_out: int, *,
                bias: bool = False, pack_g: int | None = None) -> nn.Module:
    """A master linear (``bitlinear.init``), or with ``pack_g`` that linear
    packed as soon as it is drawn."""
    m = bitlinear.init(generator, n_in, n_out, bias=bias)
    return m if pack_g is None else bitlinear.pack(m, pack_g)


def predecode_all(p: Params) -> Params:
    """Every packed linear of a sub-layer decoded on its own
    (``bitlinear.predecode``); its other linears and dense tensors pass
    through (JAX's ``predecode_packed`` walk)."""
    return Params(**{n: bitlinear.predecode(v) if isinstance(v, PackedLinear)
                     else v for n, v in p.items()})


def linear_apply(p: nn.Module, x: torch.Tensor, ctx: Ctx, *,
                 ternary_w: bool = True) -> torch.Tensor:
    if isinstance(p, PredecodedLinear):   # serving engine's hot path
        return bitlinear.apply_predecoded(p, x, out_dtype=x.dtype)
    # on a mesh: how w and x are split (runtime/sharding.py)
    parts = (ctx.constrain.linear_parts(p, x) if ctx.constrain is not None
             and isinstance(p, (Linear, PackedLinear)) else None)
    if isinstance(p, PackedLinear):       # packed inference params
        if parts is not None and parts.row:   # int32 sums over "model"
            return bitlinear.apply_packed_rows(
                p, x, ctx.constrain.mesh, matmul=ctx.matmul,
                out_dtype=x.dtype, seq_part=ctx.constrain.sp_now)
        # whole, or this rank's columns (and the bias's slice)
        return bitlinear.apply_packed(p, x, matmul=ctx.matmul,
                                      out_dtype=x.dtype)
    if not isinstance(p, Linear):
        raise TypeError(f"not a linear: {type(p).__name__}")
    if ctx.mode == "qat" and ternary_w:
        y = bitlinear.apply_qat(p, x, int8_fwd=ctx.qat_int8_fwd, parts=parts)
    else:                                 # dense: unquantized master
        y = x @ p.w.to(x.dtype)
        y = y + p.b.to(y.dtype) if p.b is not None else y
    if parts is not None and parts.row:   # partial sums over "model"
        y = ctx.constrain.row_out(y)
    return y


def down_apply(p: nn.Module, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``linear_apply`` of a down projection (attention's ``o``, the SSM's
    ``out_proj``, xLSTM's ``out``, a split FFN's ``down``) whose input is,
    under tensor parallelism, this rank's block of its features: it runs
    row-parallel.  JAX splits a packed one's padded rows, which "model"
    may not divide at a small width (5 ranks and 64 rows; JAX then splits
    its output columns and XLA gathers the input), a layout not served."""
    c = ctx.constrain
    if c is not None and c.tp and not c.linear_parts(p, x).row:
        raise NotImplementedError(
            f"a down projection on this rank's features whose weight JAX "
            f"splits on its output ({p.specs}): its packed rows are not "
            f"divided by the {c.model_size} 'model' ranks")
    return linear_apply(p, x, ctx)


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


def rope_weight_permutation(hd: int) -> torch.Tensor:
    """The paper's eq. 6: the per-head index exchange that turns weights
    for interleaved RoPE into weights for consecutive RoPE losslessly.
    perm[2t] = t, perm[2t + 1] = hd/2 + t (int64): gathering a head's
    output columns of interleaved-RoPE weights by ``perm`` gives weights
    whose consecutive-RoPE output, reordered by the same ``perm``, equals
    the interleaved-RoPE output."""
    t = torch.arange(hd // 2)
    perm = torch.empty(hd, dtype=torch.int64)
    perm[0::2] = t
    perm[1::2] = hd // 2 + t
    return perm


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
    split = ctx.constrain is not None and ctx.constrain.ffn_split
    return (down_apply if split else linear_apply)(p["down"], h.to(x.dtype),
                                                   ctx)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, tok: torch.Tensor):
        super().__init__()
        self.register_buffer("tok", tok)


def embed_apply(p: Embedding, tokens: torch.Tensor,
                ctx: Ctx | None = None) -> torch.Tensor:
    """Token ids -> rows of the table (on a training mesh with the
    vocabulary split, each rank's rows summed over "model")."""
    if ctx is not None and ctx.constrain is not None:
        return ctx.constrain.embed(p, tokens)
    return p.tok[tokens]


# ---------------------------------------------------------------------------
# MoE (capacity + scatter dispatch; ternary expert banks)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """A dense f32 router and three expert banks: float masters
    ``{gate,up,down}_w`` (E, n_in, n_out), or, packed (``moe_pack``),
    base-3 ``{gate,up,down}_codes`` (E, rows, n_out) with one absmean
    ``{gate,up,down}_gamma`` an expert (E,) and the pack group ``g``."""

    BANKS = ("gate", "up", "down")

    def __init__(self, router: Linear, banks: dict, g: int | None = None):
        super().__init__()
        self.router = router
        self.g = g
        for name, t in banks.items():
            self.register_buffer(name, t)

    @property
    def packed(self) -> bool:
        return self.g is not None

    @property
    def n_experts(self) -> int:
        """E, from the dense router's (d_model, E) weight: a training
        mesh's rank may hold a block of the banks (``moe_apply`` routes
        with the router gathered whole)."""
        return self.router.w.shape[-1]


def moe_bank(generator: torch.Generator, n_experts: int, n_in: int,
             n_out: int, d_model: int) -> torch.Tensor:
    """One (E, n_in, n_out) f32 master bank ~ N(0, 1/d_model), as JAX
    scales every bank of a layer."""
    return torch.randn((n_experts, n_in, n_out), generator=generator,
                       device=generator.device) / math.sqrt(d_model)


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, *, pack_g: int | None = None) -> MoE:
    """Float masters: the router (d_model -> E, no bias), then the gate, up
    and down banks, drawn in that order.  With ``pack_g`` each bank is
    packed (``pack_bank``) before the next is drawn, which equals
    ``moe_pack`` of the masters without holding two float banks."""
    router = bitlinear.init(generator, d_model, n_experts)
    shapes = {"gate": (d_model, d_ff), "up": (d_model, d_ff),
              "down": (d_ff, d_model)}
    banks = {}
    for n in MoE.BANKS:
        w = moe_bank(generator, n_experts, *shapes[n], d_model)
        if pack_g is None:
            banks[f"{n}_w"] = w
        else:
            banks[f"{n}_codes"], banks[f"{n}_gamma"] = pack_bank(w, pack_g)
    return MoE(router, banks, g=pack_g)


def pack_bank(w: torch.Tensor, g: int) -> tuple:
    """(E, n_in, n_out) masters -> ((E, rows, n_out) uint8 codes, (E,) f32
    gammas): each expert ternarized with its own absmean scale and packed
    with rows padded to ``bitlinear.ROW_MULTIPLE``, as JAX's vmapped
    ``moe_pack``."""
    codes, gammas = [], []
    for e in range(w.shape[0]):
        wt, gamma = ternary.ternarize(w[e])
        codes.append(ternary.pack_ternary(wt, g, bitlinear.ROW_MULTIPLE))
        gammas.append(gamma)
    return torch.stack(codes), torch.stack(gammas)


def moe_pack(p: MoE, g: int) -> MoE:
    """Offline base-3 packing of the expert banks (the router stays
    dense)."""
    banks = {}
    for name in MoE.BANKS:
        banks[f"{name}_codes"], banks[f"{name}_gamma"] = pack_bank(
            getattr(p, f"{name}_w"), g)
    return MoE(p.router, banks, g=g)


def _expert_matmul(w: torch.Tensor, x: torch.Tensor, ctx: Ctx, *,
                   w_part=None, x_part=None) -> torch.Tensor:
    """Float master bank w (E, n_in, n_out), x (E, C, n_in) -> (E, C,
    n_out) in x's dtype.  Under ``ctx.mode == "qat"`` each expert is
    fake-quantized with its own gamma (``ternary.ternarize_ste`` over dims
    (1, 2)) and x a row at a time (``absmax_quant_ste``: an empty capacity
    slot is an all-zero row, scaled at the eps floor, and stays zero), then
    one batched product: JAX's ``_expert_matmul``.  On a training mesh the
    parts (``sharding.Rows``) say which rows of the whole bank and buffer
    these are, for a pinned replay."""
    if ctx.mode == "qat":
        w = ternary.ternarize_ste(w, dims=(1, 2), part=w_part)
        x = ternary.absmax_quant_ste(x, part=x_part)
    return torch.einsum("ecd,edf->ecf", x, w.to(x.dtype))


def _expert_matmul_packed(codes: torch.Tensor, gamma: torch.Tensor,
                          n_in: int, g: int, x: torch.Tensor,
                          x_part=None) -> torch.Tensor:
    """codes (E, rows, n_out), gamma (E,), x (E, C, n_in) float -> (E, C,
    n_out) f32: per-row int8 quant, then one packed ternary matmul an
    expert (``tlmm``: the kernel on the card, its plain version on the
    CPU; the bank is never unpacked), then acc * x_scale * gamma.  On a
    mesh ``x_part`` (``sharding.Rows``) says which rows of the whole
    buffer x holds, for a replay."""
    xq, xs = ternary.absmax_quant(x, part=x_part)
    # the kernel takes rows of unit stride: x may be a gathered view
    acc = torch.stack([tlmm_ops.tlmm(xq[e].contiguous(), codes[e], g=g,
                                     n=n_in)
                       for e in range(codes.shape[0])])
    return acc.float() * xs * gamma[:, None, None]


def moe_route(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, ctx: Ctx | None = None) -> dict:
    """Top-k routing of (n, d) tokens: the router's f32 logits (a dense
    product in every mode, JAX's ``ternary_w=False``; under training the
    gradient reaches it through the softmaxed top-k gates), the top
    ``top_k`` experts a token and the softmax of their logits, then each
    (token, slot) pair's position in its expert's buffer (an exclusive
    cumulative count in token-major order) and whether it fits the
    capacity ``max(int(n * top_k / E * capacity_factor), top_k)``.
    Returns {"logits"} (n, E), {"gates", "idx"} (n, k), {"pos", "keep",
    "flat_idx"} (n*k,), and "capacity".  ``ctx`` (its ``constrain``) is
    read only by a pinned replay; on a batch split over ranks
    ``moe_apply`` moves the positions to the global batch's."""
    n = x.shape[0]
    logits = linear_apply(p.router, x, Ctx(), ternary_w=False).float()
    gates, idx = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(gates, dim=-1)
    capacity = max(int(n * top_k / p.n_experts * capacity_factor), top_k)
    flat_idx = idx.reshape(-1)
    pos = route_positions(flat_idx, p.n_experts)
    return {"logits": logits, "gates": gates, "idx": idx,
            "flat_idx": flat_idx, "pos": pos, "keep": pos < capacity,
            "capacity": capacity}


def state_heads(ctx: Ctx, st: dict, dims: dict | None = None) -> dict:
    """A recurrent state held whole in its heads -> this rank's heads of
    it, where a "model" axis splits the heads (``Constrain.state_heads``:
    each plane cut on its head-major dimension, ``dims`` or 1), else as it
    is."""
    c = ctx.constrain
    return c.state_heads(st, dims) if c is not None else st


def whole_state(ctx: Ctx, st: dict, dims: dict | None = None) -> dict:
    """The rank's heads of a scan's new state -> the state whole in its
    heads (``Constrain.whole_state``), else as it is."""
    c = ctx.constrain
    return c.whole_state(st, dims) if c is not None else st


def route_positions(flat_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, slot) pair's position in its expert's buffer: the
    exclusive cumulative count of its expert in token-major order."""
    onehot = (flat_idx[:, None] == torch.arange(
        n_experts, device=flat_idx.device)).to(torch.int32)
    return ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)


def _moe_dispatch(p: MoE, x: torch.Tensor, r: dict, offset, cap: int, *,
                  top_k: int, ctx: Ctx) -> torch.Tensor:
    """One piece of tokens through its experts, routed (``r``): a pair is
    kept where its position in the global token order (its position among
    the piece's pairs, plus ``offset`` (E,): the pairs of its expert and
    chunk on the batch ranks before this one) is below ``cap``, and fills
    its expert's buffer at its row among the piece's pairs.  On a
    "model" axis only the rank's experts are computed and the output is
    the rank's partial sum; where the banks are split inside each expert
    (``Constrain.split_banks``), every expert on the rank's columns and
    the output is the rank's d_model columns: the gate and up banks give
    its f columns of ``h``, which is gathered whole over "model" before
    the down bank reads it (a packed bank quantizes it at the whole row's
    absmax, as one device does)."""
    n, d = x.shape
    c = ctx.constrain
    n_experts = r["logits"].shape[-1]
    flat_idx, row = r["flat_idx"], r["pos"]
    gpos = row if offset is None else row + offset[flat_idx]
    keep = gpos < cap
    split = c is not None and c.split_banks(p)
    lo, hi = c.experts(n_experts, split) if c is not None else (0, n_experts)
    mine = keep & (flat_idx >= lo) & (flat_idx < hi)
    e_loc = flat_idx - lo
    n_loc = hi - lo
    # dispatch without a scatter-add: every kept (expert, row) pair is
    # unique, so each buffer row names the one (token, slot) pair that
    # fills it (other pairs are sent to a dump row past the buffer);
    # empty rows read a zero row.  Its backward adds each buffer row's
    # gradient into its token's (an accumulating index put).
    nk = flat_idx.shape[0]
    dest = torch.where(mine, e_loc * cap + row, n_loc * cap)
    src = torch.full((n_loc * cap + 1,), nk, dtype=torch.int64,
                     device=x.device)
    src.scatter_(0, dest, torch.arange(nk, device=x.device))
    rows = torch.cat([x[:, None].expand(n, top_k, d).reshape(n * top_k, d),
                      x.new_zeros((1, d))])
    buf = rows[src[:-1]].reshape(n_loc, cap, d)
    x_part = None
    if c is not None:   # which rows of the whole buffers these are, for a
        # replay (a row's statistics stay its own)
        filled = (src[:-1] != nk).reshape(n_loc, cap)
        experts = torch.arange(lo, hi, device=x.device)
        grow = torch.arange(cap, device=x.device)[None] + (
            0 if offset is None else offset[lo:hi, None])
        x_part = Rows((experts[:, None].expand(n_loc, cap),
                       torch.where(filled, grow, 0)), filled)
    if p.packed:   # this rank's experts, or every expert on its columns
        bank = {}
        for name in MoE.BANKS:
            codes = getattr(p, f"{name}_codes")
            gamma = getattr(p, f"{name}_gamma")
            if c is not None and c.tp:
                codes = c.expert_bank(codes, p.specs[f"{name}_codes"], split)
                gamma = c.expert_bank(gamma, p.specs[f"{name}_gamma"], split)
            bank[name] = (codes, gamma)
        h_g = _expert_matmul_packed(*bank["gate"], d, p.g, buf, x_part)
        h_u = _expert_matmul_packed(*bank["up"], d, p.g, buf, x_part)
        h = (torch.nn.functional.silu(h_g) * h_u).to(x.dtype)
        if split:   # this rank's f columns; its down columns read them all
            h = c.mesh.gather(h, "model", 2, partial=True)
        out_buf = _expert_matmul_packed(*bank["down"], h.shape[-1], p.g,
                                        h, x_part).to(x.dtype)
    else:   # float masters: JAX's QAT (or unquantized) branch
        banks = {n: getattr(p, f"{n}_w") for n in MoE.BANKS}
        w_part = None
        if c is not None:   # the rank's part of the banks; which rows or
            # columns of the whole ones, for a replay and the gammas
            banks = {n: c.expert_bank(t, p.specs[f"{n}_w"])
                     for n, t in banks.items()}
            w_part = (Part(c.mesh, (None, None, "model")) if split
                      else Rows((slice(lo, hi),)))
        kw = dict(w_part=w_part, x_part=x_part)
        h_g = _expert_matmul(banks["gate"], buf, ctx, **kw).float()
        h_u = _expert_matmul(banks["up"], buf, ctx, **kw).float()
        h = (torch.nn.functional.silu(h_g) * h_u).to(x.dtype)
        if split:   # this rank's f columns; its down columns read them all
            h = c.mesh.gather(h, "model", 2, partial=True)
        out_buf = _expert_matmul(banks["down"], h, ctx, **kw)
    gathered = out_buf[torch.where(mine, e_loc, 0),
                       torch.where(mine, row, cap - 1)]
    gathered = torch.where(mine[:, None], gathered, 0)
    weighted = (gathered * r["gates"].reshape(-1)[:, None]
                .to(gathered.dtype)).reshape(n, top_k, -1)
    # JAX's scatter-add of a token's k slots, in slot order
    out = weighted[:, 0]
    for j in range(1, top_k):
        out = out + weighted[:, j]
    return out


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, ctx: Ctx) -> torch.Tensor:
    """Top-k MoE with capacity and dispatch, dropping on overflow, over
    packed banks or float masters (fake-quantized under ``ctx.mode ==
    "qat"``, the training path).  x: (n, d_model), the caller flattening
    (b, s).  With ``ctx.moe_token_chunk`` dividing the token count (and
    below it) the tokens go a chunk at a time, as JAX's scan over token
    chunks does: capacity then counts a chunk.

    On a training mesh (``ctx.constrain``) the step is JAX's jitted one
    over the global batch: where the batch is split over ranks, capacity
    counts the global tokens (of the chunk) and a pair's position is its
    exclusive count in the global token order, this rank's own count plus
    those of the batch ranks before it (one all-gather of (chunks, E)
    counts); dispatch stays local, since a token's expert output depends
    on its own row only.  On a "model" axis the router is gathered whole,
    each rank computes its experts (``Constrain.experts``) and returns its
    partial sum, or, where the banks are split inside each expert, every
    expert on its columns and returns its d_model columns; the caller puts
    either back together (``Constrain.moe_out``)."""
    n = x.shape[0]
    c = ctx.constrain
    start, total = c.token_span(n) if c is not None else (0, n)
    tc = ctx.moe_token_chunk
    span = tc if tc and total > tc and total % tc == 0 else total
    pieces, lo = [], 0   # (lo, hi, chunk): cut where a global chunk ends
    while lo < n:
        chunk = (start + lo) // span
        hi = min(n, (chunk + 1) * span - start)
        pieces.append((lo, hi, chunk))
        lo = hi
    route_p = p
    if c is not None and c.tp:   # top-k needs every logit
        route_p = copy.copy(p)
        route_p._modules = dict(p._modules,
                                router=c.whole(p.router, partial=True))
    kw = dict(top_k=top_k, capacity_factor=capacity_factor)
    routes = [moe_route(route_p, x[a:b], ctx=ctx, **kw)
              for a, b, _ in pieces]
    n_experts = route_p.n_experts
    offsets = None
    if c is not None and c.n_batch > 1:
        counts = torch.zeros((total // span, n_experts), dtype=torch.int64,
                             device=x.device)
        experts = torch.arange(n_experts, device=x.device)
        for (_, _, chunk), r in zip(pieces, routes):   # no data-sized op
            counts[chunk] += (r["flat_idx"][:, None] == experts).sum(0)
        offsets = c.route_offsets(counts)
    cap = max(int(span * top_k / n_experts * capacity_factor), top_k)
    outs = [_moe_dispatch(p, x[a:b], r,
                          None if offsets is None else offsets[chunk], cap,
                          top_k=top_k, ctx=ctx)
            for (a, b, chunk), r in zip(pieces, routes)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)
