"""Mamba2-style selective SSM block (chunked SSD scan) for hymba's SSM
heads.

Counterpart of ``repro/models/ssm.py``.  Prefill uses the chunkwise SSD
form: within a chunk of Q positions the recurrence is expanded into a
(Q x Q) masked matrix, and a (heads, state, head_dim) state is carried from
chunk to chunk by a Python loop.  ``chunk = min(chunk, s)``, and a sequence
that the chunk does not divide is one chunk, as in JAX, so both packages
sum in the same order.  Decode is the O(1) step on (conv ring, SSM state).

The ring after a prompt is the last ``cw - 1`` rows of the zero-padded
input the causal conv reads, so a prompt shorter than ``cw - 1`` leaves
leading zero rows.  (JAX slices ``xin[:, s - (cw - 1):]``, which for such a
prompt starts at a negative index: ROADMAP C.)

The in/out projections are BitLinear (packed or pre-decoded); ``A_log``,
``D``, ``dt_bias``, ``conv_w`` and ``conv_b`` stay dense.  Plain PyTorch:
JAX computes the scan and the ring in ``jnp``, no Pallas kernel.

On a training mesh's "model" axis (``runtime/sharding.py`` ``Constrain``)
the scan runs on the rank's heads.  The leaves go, with JAX's storage:
``in_proj`` (its split cuts [x | z]) and ``bc_proj`` ([B | C], shared by
every head) gathered whole and computed on every rank, x and z cut to the
rank's heads; ``dt_proj`` split on whole heads, column-parallel;
``out_proj`` split on its input (the rank's heads), row-parallel; the
conv weights, ``A_log``, ``D`` and ``dt_bias`` whole, cut to the rank's
heads.  The serving program keeps the state whole in its heads on every
"model" rank (JAX's cache plane, split on its batch only): a step reads
the rank's heads of it and the new state is gathered whole again
(``layers.state_heads``/``whole_state`` on ``STATE_DIMS``).
"""

from __future__ import annotations

import torch

from repro_torch.core import bitlinear
from repro_torch.models import layers
from repro_torch.models.layers import Ctx, Params

F = torch.nn.functional
LINEARS = ("in_proj", "bc_proj", "dt_proj", "out_proj")
DENSE = ("conv_w", "conv_b", "A_log", "D", "dt_bias")
# each state plane's head-major dimension: h (b, H, N, hd), the conv ring
# (b, cw - 1, H * hd) in head-major blocks of hd channels
STATE_DIMS = {"h": 1, "conv": 2}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_init(generator: torch.Generator, d_model: int, n_heads: int,
             head_dim: int, state: int, conv_w: int = 4, *,
             pack_g: int | None = None) -> Params:
    """Float masters (or, with ``pack_g``, each linear packed as soon as it
    is drawn): in_proj, bc_proj, dt_proj, out_proj, then the conv weights
    ~ N(0, 0.01); zero conv bias, A_log and dt_bias, unit D (JAX's
    scales)."""
    d_inner = n_heads * head_dim
    dev = generator.device

    def lin(n_in, n_out):
        return layers.linear_init(generator, n_in, n_out, pack_g=pack_g)

    return Params(
        in_proj=lin(d_model, 2 * d_inner),
        bc_proj=lin(d_model, 2 * state),
        dt_proj=lin(d_model, n_heads),
        out_proj=lin(d_inner, d_model),
        conv_w=torch.randn((conv_w, d_inner), generator=generator,
                           device=dev) * 0.1,
        conv_b=torch.zeros((d_inner,), device=dev),
        A_log=torch.zeros((n_heads,), device=dev),
        D=torch.ones((n_heads,), device=dev),
        dt_bias=torch.zeros((n_heads,), device=dev))


def ssm_pack(p: Params, g: int) -> Params:
    return Params(**{n: bitlinear.pack(p[n], g) for n in LINEARS},
                  **{n: p[n] for n in DENSE})


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> tuple:
    """Depthwise causal conv over zero padding. x: (b, s, c); w: (cw, c).
    Returns the (b, s, c) output, its taps summed in JAX's order (a Python
    ``sum`` from tap 0), and the padded input (b, cw - 1 + s, c)."""
    cw, s = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], cw - 1, x.shape[2])), x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * w[i]
    return out + b, xp


def _tp(ctx: Ctx):
    """A training mesh's hook when its "model" axis splits the heads."""
    c = ctx.constrain
    return c if c is not None and c.tp else None


def _dense(p, ctx: Ctx) -> dict:
    """The dense leaves, on a "model" axis cut to the rank's heads (whole
    on every rank, their gradients summed: ``Constrain.shared``)."""
    c = _tp(ctx)
    dims = {"conv_w": 1, "conv_b": 0, "A_log": 0, "D": 0, "dt_bias": 0}
    return {n: c.shared(p[n], d) if c else p[n] for n, d in dims.items()}


def _gates(p, x, ctx: Ctx, n_heads):
    """The common projections. x: (b, s, d_model).  On a "model" axis
    (``Constrain``): ``in_proj`` and ``bc_proj`` computed whole, since
    JAX's split of their columns cuts [x | z] and [B | C] (B and C serve
    every head), and x and z cut to the rank's heads; ``dt_proj`` split on
    whole heads, column-parallel."""
    c = _tp(ctx)
    in_proj, bc_proj = p["in_proj"], p["bc_proj"]
    if c:
        in_proj, bc_proj = c.whole(in_proj, True), c.whole(bc_proj, True)
    xin, z = layers.linear_apply(in_proj, x, ctx).chunk(2, dim=-1)
    if c:
        xin, z = c.heads(xin), c.heads(z)
    bc = layers.linear_apply(bc_proj, x, ctx).float()
    B, C = bc.chunk(2, dim=-1)                            # (b, s, N)
    dense = _dense(p, ctx)
    dt = layers.linear_apply(p["dt_proj"], x, ctx).float()
    dt = softplus(dt + dense["dt_bias"])                  # (b, s, H) >= 0
    A = -torch.exp(dense["A_log"])                        # (H,) < 0
    return xin, z, B, C, dt, dt * A                       # log_a <= 0


def ssm_forward(p: Params, x: torch.Tensor, ctx: Ctx, *, n_heads: int,
                head_dim: int, state: int, chunk: int = 128,
                return_state: bool = False):
    """Full-sequence chunked SSD. x: (b, s, d_model) -> (b, s, d_model).
    With ``return_state`` also {"h": (b, H, N, hd) f32, "conv": (b, cw-1,
    d_inner) in x's dtype}, the state after the sequence."""
    b, s, _ = x.shape
    if _tp(ctx):   # the rank's heads; out_proj sums over "model"
        n_heads //= ctx.constrain.model_size
    d_inner = n_heads * head_dim
    chunk = min(chunk, s)
    if s % chunk:     # odd sizes: a single chunk
        chunk = s
    xin, z, B, C, dt, log_a = _gates(p, x, ctx, n_heads)
    dense = _dense(p, ctx)
    xc, xp = _causal_conv(xin, dense["conv_w"], dense["conv_b"])
    xc = F.silu(xc.float())
    # weight the input by dt (x_bar = dt * x)
    xh = xc.reshape(b, s, n_heads, head_dim) * dt[..., None]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    h = x.new_zeros((b, n_heads, state, head_dim), dtype=torch.float32)
    ys = []
    for lo in range(0, s, chunk):
        span = slice(lo, lo + chunk)
        xq, Bq, Cq = xh[:, span], B[:, span], C[:, span]
        cum = torch.cumsum(log_a[:, span], dim=1)             # (b, Q, H)
        # intra-chunk: scores[i, j] = (C_i . B_j) exp(cum_i - cum_j), j <= i
        dmat = cum[:, :, None, :] - cum[:, None, :, :]       # (b, Q, Q, H)
        dmat = torch.where(tri[None, :, :, None], dmat, -torch.inf)
        cb = torch.einsum("bin,bjn->bij", Cq, Bq)
        scores = cb[..., None] * torch.exp(dmat)
        y_intra = torch.einsum("bijh,bjhd->bihd", scores, xq)
        # inter-chunk: y_i += C_i . h * exp(cum_i)
        y_inter = torch.einsum("bin,bhnd,bih->bihd", Cq, h, torch.exp(cum))
        # h = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) B_j x_j
        tail = cum[:, -1:, :]
        w = torch.exp(tail - cum)
        h = (h * torch.exp(tail[:, 0, :])[:, :, None, None]
             + torch.einsum("bjn,bjhd,bjh->bhnd", Bq, xq, w))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)                                 # (b, s, H, hd)
    y = y + dense["D"][None, None, :, None] * xc.reshape(b, s, n_heads,
                                                         head_dim)
    y = y.reshape(b, s, d_inner) * F.silu(z.float())
    out = layers.down_apply(p["out_proj"], y.to(x.dtype), ctx)
    if return_state:
        # the last cw - 1 rows of the zero-padded conv input
        return out, layers.whole_state(ctx, {"h": h, "conv": xp[:, s:]},
                                       STATE_DIMS)
    return out


def ssm_init_state(b: int, n_heads: int, head_dim: int, state: int,
                   conv_w: int, d_inner: int, dtype=torch.float32,
                   device="cuda") -> dict:
    return {"h": torch.zeros((b, n_heads, state, head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((b, conv_w - 1, d_inner), dtype=dtype,
                                device=device)}


def ssm_step(p: Params, x: torch.Tensor, st: dict, ctx: Ctx, *,
             n_heads: int, head_dim: int, state: int):
    """One decode step. x: (b, 1, d_model) -> ((b, 1, d_model), new state).
    The ring (in its own dtype) and the input are joined in their promoted
    type, and the new ring is cast back, as in JAX.  On a "model" axis the
    step runs on the rank's heads, as ``ssm_forward``: it reads their part
    of ``st`` (whole in its heads) and returns the new state whole."""
    b = x.shape[0]
    if _tp(ctx):
        n_heads //= ctx.constrain.model_size
    d_inner = n_heads * head_dim
    xin, z, B, C, dt, log_a = _gates(p, x, ctx, n_heads)
    dense = _dense(p, ctx)
    st = layers.state_heads(ctx, st, STATE_DIMS)
    ring = st["conv"]
    dt_cat = torch.promote_types(ring.dtype, xin.dtype)
    xcat = torch.cat([ring.to(dt_cat), xin.to(dt_cat)], dim=1)  # (b, cw, di)
    xc = ((xcat * dense["conv_w"][None]).sum(dim=1, keepdim=True)
          + dense["conv_b"])
    xc = F.silu(xc.float())                                     # (b, 1, di)
    xh = xc.reshape(b, n_heads, head_dim) * dt[:, 0, :, None]
    a = torch.exp(log_a[:, 0, :])                               # (b, H)
    h_new = (st["h"] * a[:, :, None, None]
             + torch.einsum("bn,bhd->bhnd", B[:, 0], xh))
    y = torch.einsum("bn,bhnd->bhd", C[:, 0], h_new)
    y = y + dense["D"][None, :, None] * xc.reshape(b, n_heads, head_dim)
    y = y.reshape(b, 1, d_inner) * F.silu(z.float())
    out = layers.down_apply(p["out_proj"], y.to(x.dtype), ctx)
    return out, layers.whole_state(
        ctx, {"h": h_new, "conv": xcat[:, 1:].to(ring.dtype)}, STATE_DIMS)
