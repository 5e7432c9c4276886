"""xLSTM blocks: chunkwise-parallel mLSTM (matrix memory) and sequential
sLSTM.

Counterpart of ``repro/models/xlstm.py``.  mLSTM is linear-attention-like:
C_t = f_t C_{t-1} + i_t v_t k_t^T, n_t = f_t n_{t-1} + i_t k_t,
h_t = (C_t q_t) / max(|n_t^T q_t|, exp(-m_t)), with a sigmoid forget gate,
an exponential input gate and the log-space stabiliser m.  Prefill runs the
chunkwise form, the carried (C, n, m) passed from chunk to chunk by a
Python loop; ``chunk = min(chunk, s)`` and a sequence the chunk does not
divide is one chunk, as in JAX.  sLSTM has per-head recurrent weights
``r`` (kept dense) and is sequential: a Python loop over positions.

All projections are BitLinear (packed or pre-decoded).  Plain PyTorch: JAX
computes both scans in ``jnp``, no Pallas kernel.

On a training mesh's "model" axis (``runtime/sharding.py`` ``Constrain``)
both scans run on the rank's heads.  The leaves go, with JAX's storage:
mLSTM's ``qkv`` and ``gates`` (JAX's split of their columns cuts [q | k |
v] and [i | f]) gathered whole and computed on every rank, each part cut
to the rank's heads; ``ogate`` split on whole heads, column-parallel;
``out`` split on its input (the rank's heads), row-parallel.  sLSTM's
``wx`` ([z | i | f | o]) gathered whole, each gate cut to the rank's
heads; ``r`` whole, cut to the rank's heads; ``out`` row-parallel.  The
serving program keeps each state whole in its heads on every "model" rank
(JAX's cache planes, split on their batch only): a step reads the rank's
heads of it and the new state is gathered whole again
(``layers.state_heads``/``whole_state``; every plane is head-major on
dim 1).
"""

from __future__ import annotations

import torch

from repro_torch.core import bitlinear
from repro_torch.models import layers
from repro_torch.models.layers import Ctx, Params

F = torch.nn.functional
MLSTM_LINEARS = ("qkv", "gates", "ogate", "out")
SLSTM_LINEARS = ("wx", "out")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(generator: torch.Generator, d_model: int, n_heads: int,
               head_dim: int, *, pack_g: int | None = None) -> Params:
    """qkv, gates (input and forget, one a head), ogate, out, in that
    order; with ``pack_g`` each packed as soon as it is drawn."""
    d_inner = n_heads * head_dim
    lin = layers.linear_init
    return Params(qkv=lin(generator, d_model, 3 * d_inner, pack_g=pack_g),
                  gates=lin(generator, d_model, 2 * n_heads, pack_g=pack_g),
                  ogate=lin(generator, d_model, d_inner, pack_g=pack_g),
                  out=lin(generator, d_inner, d_model, pack_g=pack_g))


def mlstm_pack(p: Params, g: int) -> Params:
    return Params(**{n: bitlinear.pack(p[n], g) for n in MLSTM_LINEARS})


def _tp(ctx: Ctx):
    """A training mesh's hook when its "model" axis splits the heads."""
    c = ctx.constrain
    return c if c is not None and c.tp else None


def _local_heads(ctx: Ctx, n_heads: int) -> int:
    c = _tp(ctx)
    return n_heads // c.model_size if c else n_heads


def _mlstm_proj(p, x, ctx, n_heads, head_dim):
    b, s, _ = x.shape
    c = _tp(ctx)
    qkv, gates = p["qkv"], p["gates"]
    if c:   # computed whole, each part cut to the rank's heads
        qkv, gates = c.whole(qkv, True), c.whole(gates, True)
    q, k, v = layers.linear_apply(qkv, x, ctx).chunk(3, dim=-1)
    shape = (b, s, n_heads, head_dim)
    ig, fg = layers.linear_apply(gates, x, ctx).float().chunk(2, dim=-1)
    if c:
        q, k, v, ig, fg = (c.heads(t) for t in (q, k, v, ig, fg))
    log_f = F.logsigmoid(fg)                          # (b, s, H) <= 0
    o = torch.sigmoid(layers.linear_apply(p["ogate"], x, ctx).float())
    scale = 1.0 / float(head_dim) ** 0.5
    return (q.reshape(shape).float() * scale, k.reshape(shape).float(),
            v.reshape(shape).float(), ig, log_f, o)


def mlstm_forward(p: Params, x: torch.Tensor, ctx: Ctx, *, n_heads: int,
                  head_dim: int, chunk: int = 128,
                  return_state: bool = False):
    """Chunkwise-parallel mLSTM. x: (b, s, d) -> (b, s, d); with
    ``return_state`` also {"C", "n", "m"} after the sequence (f32)."""
    b, s, _ = x.shape
    n_heads = _local_heads(ctx, n_heads)
    d_inner = n_heads * head_dim
    chunk = min(chunk, s)
    if s % chunk:     # odd sizes: a single chunk
        chunk = s
    q, k, v, ig, log_f, o = _mlstm_proj(p, x, ctx, n_heads, head_dim)
    st = mlstm_init_state(b, n_heads, head_dim, device=x.device)
    C, n, m = st["C"], st["n"], st["m"]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    hs = []
    for lo in range(0, s, chunk):
        span = slice(lo, lo + chunk)
        qq, kk, vv, ii = q[:, span], k[:, span], v[:, span], ig[:, span]
        cum = torch.cumsum(log_f[:, span], dim=1)        # (b, Q, H) <= 0
        # log weight of source j seen from target i: ii_j + cum_i - cum_j
        dmat = cum[:, :, None, :] - cum[:, None, :, :] + ii[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, -torch.inf)
        # candidates from the carried state: m + cum_i
        inter_log = m[:, None, :] + cum                  # (b, Q, H)
        # maximum and amax split a tie's gradient equally, as JAX's max
        # and reduce_max do (clamp_min would give it all to m_row)
        m_row = torch.maximum(dmat.amax(dim=2), inter_log)
        m_row = torch.maximum(m_row, torch.full_like(m_row, -1e30))
        w_intra = torch.exp(dmat - m_row[:, :, None, :])
        w_inter = torch.exp(inter_log - m_row)
        qk = torch.einsum("bihd,bjhd->bijh", qq, kk)     # (b, Q, Q, H)
        num = torch.einsum("bijh,bijh,bjhd->bihd", qk, w_intra, vv)
        den = torch.einsum("bijh,bijh->bih", qk, w_intra)
        num = num + torch.einsum("bihd,bhde,bih->bihe", qq, C, w_inter)
        den = den + torch.einsum("bihd,bhd,bih->bih", qq, n, w_inter)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_row))[..., None])
        # carry update, stabilised at the chunk's final max
        tail = cum[:, -1:, :]
        m_new = torch.maximum(m + tail[:, 0],
                              (ii + tail - cum).amax(dim=1))
        w_c = torch.exp(ii + tail - cum - m_new[:, None, :])   # (b, Q, H)
        decay = torch.exp(m + tail[:, 0] - m_new)              # (b, H)
        C = (C * decay[..., None, None]
             + torch.einsum("bjhd,bjhe,bjh->bhde", kk, vv, w_c))
        n = n * decay[..., None] + torch.einsum("bjhd,bjh->bhd", kk, w_c)
        m = m_new
    h = torch.cat(hs, dim=1).reshape(b, s, d_inner) * o
    out = layers.down_apply(p["out"], h.to(x.dtype), ctx)
    if return_state:
        return out, layers.whole_state(ctx, {"C": C, "n": n, "m": m})
    return out


def mlstm_init_state(b: int, n_heads: int, head_dim: int,
                     device="cuda") -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((b, n_heads, head_dim, head_dim), **f32),
            "n": torch.zeros((b, n_heads, head_dim), **f32),
            "m": torch.full((b, n_heads), -1e30, **f32)}


def mlstm_step(p: Params, x: torch.Tensor, st: dict, ctx: Ctx, *,
               n_heads: int, head_dim: int):
    """One decode step. x: (b, 1, d) -> ((b, 1, d), new state).  On a
    "model" axis the step runs on the rank's heads, as ``mlstm_forward``:
    it reads their part of ``st`` (whole in its heads) and returns the new
    state whole."""
    b = x.shape[0]
    n_heads = _local_heads(ctx, n_heads)
    d_inner = n_heads * head_dim
    st = layers.state_heads(ctx, st)
    q, k, v, ig, log_f, o = _mlstm_proj(p, x, ctx, n_heads, head_dim)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                  # (b, H, hd)
    ii, lf = ig[:, 0], log_f[:, 0]                       # (b, H)
    m_new = torch.maximum(st["m"] + lf, ii)
    f_w = torch.exp(st["m"] + lf - m_new)
    i_w = torch.exp(ii - m_new)
    C_new = (st["C"] * f_w[..., None, None]
             + torch.einsum("bhd,bhe,bh->bhde", k, v, i_w))
    n_new = st["n"] * f_w[..., None] + k * i_w[..., None]
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = h.reshape(b, 1, d_inner) * o
    out = layers.down_apply(p["out"], h.to(x.dtype), ctx)
    return out, layers.whole_state(ctx, {"C": C_new, "n": n_new,
                                         "m": m_new})


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(generator: torch.Generator, d_model: int, n_heads: int,
               head_dim: int, *, pack_g: int | None = None) -> Params:
    """wx (the z, i, f, o inputs), the dense recurrent ``r`` (4, H, hd, hd)
    ~ N(0, 0.0025), then out."""
    d_inner = n_heads * head_dim
    wx = layers.linear_init(generator, d_model, 4 * d_inner, pack_g=pack_g)
    r = torch.randn((4, n_heads, head_dim, head_dim), generator=generator,
                    device=generator.device) * 0.05
    return Params(wx=wx, r=r, out=layers.linear_init(
        generator, d_inner, d_model, pack_g=pack_g))


def slstm_pack(p: Params, g: int) -> Params:
    return Params(wx=bitlinear.pack(p["wx"], g), r=p["r"],
                  out=bitlinear.pack(p["out"], g))


def slstm_init_state(b: int, n_heads: int, head_dim: int,
                     device="cuda") -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    st = {n: torch.zeros((b, n_heads, head_dim), **f32)
          for n in ("c", "n", "h")}
    st["m"] = torch.full((b, n_heads, head_dim), -1e30, **f32)
    return st


def _slstm_cell(p, wx_t: torch.Tensor, st: dict) -> dict:
    """wx_t: (b, 4 * d_inner) pre-projected input; st: the state."""
    b = wx_t.shape[0]
    H, hd = st["h"].shape[1], st["h"].shape[2]
    rz = torch.einsum("bhd,ghde->gbhe", st["h"], p["r"].float())
    # the four gates' inputs plus their recurrent terms in one add (the
    # same sums JAX takes gate by gate)
    z_in, i_in, f_in, o_in = (wx_t.float().reshape(b, 4, H, hd)
                              + rz.transpose(0, 1)).unbind(1)
    z = torch.tanh(z_in)
    log_f = F.logsigmoid(f_in)
    decayed = log_f + st["m"]
    m_new = torch.maximum(decayed, i_in)
    i_w = torch.exp(i_in - m_new)
    f_w = torch.exp(decayed - m_new)
    c_new = f_w * st["c"] + i_w * z
    n_new = torch.maximum(f_w * st["n"] + i_w, torch.exp(-m_new))
    h_new = torch.sigmoid(o_in) * c_new / n_new
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_forward(p: Params, x: torch.Tensor, ctx: Ctx, *, n_heads: int,
                  head_dim: int, return_state: bool = False):
    """Sequential sLSTM. x: (b, s, d) -> (b, s, d); with ``return_state``
    also {"c", "n", "h", "m"} after the sequence (f32)."""
    b, s, _ = x.shape
    n_heads = _local_heads(ctx, n_heads)
    d_inner = n_heads * head_dim
    wx, cell_p = _slstm_wx(p, x, ctx)                    # (b, s, 4*d_inner)
    st = slstm_init_state(b, n_heads, head_dim, device=x.device)
    hs = []
    for t in range(s):
        st = _slstm_cell(cell_p, wx[:, t], st)
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).reshape(b, s, d_inner)
    out = layers.down_apply(p["out"], h.to(x.dtype), ctx)
    if return_state:
        return out, layers.whole_state(ctx, st)
    return out


def _slstm_wx(p: Params, x: torch.Tensor, ctx: Ctx) -> tuple:
    """(the four gates' inputs (b, s, 4 * d_inner) of the rank's heads,
    the cell's parameters): on a "model" axis ``wx`` computed whole and
    each gate cut to the rank's heads, ``r`` cut to them."""
    c = _tp(ctx)
    if not c:
        return layers.linear_apply(p["wx"], x, ctx), p
    b, s, _ = x.shape
    wx = layers.linear_apply(c.whole(p["wx"], True), x, ctx)
    return (c.heads(wx.reshape(b, s, 4, -1)).reshape(b, s, -1),
            Params(r=c.shared(p["r"], 1)))


def slstm_step(p: Params, x: torch.Tensor, st: dict, ctx: Ctx, *,
               n_heads: int, head_dim: int):
    """One decode step. x: (b, 1, d) -> ((b, 1, d), new state).  On a
    "model" axis the step runs on the rank's heads, as ``slstm_forward``:
    it reads their part of ``st`` (whole in its heads) and returns the new
    state whole."""
    b = x.shape[0]
    d_inner = _local_heads(ctx, n_heads) * head_dim
    wx, cell_p = _slstm_wx(p, x, ctx)
    st_new = _slstm_cell(cell_p, wx[:, 0], layers.state_heads(ctx, st))
    out = layers.down_apply(
        p["out"], st_new["h"].reshape(b, 1, d_inner).to(x.dtype), ctx)
    return out, layers.whole_state(ctx, st_new)
