"""``repro_torch.testing``: the pins that hold a QAT step on the card to the
same step on the CPU, checked here on the CPU alone (record, then replay).
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import ternary
from repro_torch.core.bitlinear import Linear
from repro_torch.models import layers, xlstm
from repro_torch.models.layers import Ctx, MoE, Params
from repro_torch.testing import (leaf_grad_errors, pinned_quantizers,
                                 pinned_routing, slstm_first_position_kinks,
                                 slstm_kinks_excluded, slstm_kinks_pinned)

QAT = Ctx(mode="qat")


def _randn(*shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_pinned_quantizers_replay_the_recorded_values():
    """A replay gives back the recorded fake-quantized values, straight
    through: a linear fed another input forwards the recorded product and
    passes its gradient to that input through the recorded weights; a
    replay that runs short or leaves values over fails."""
    p = layers.linear_init(torch.Generator().manual_seed(0), 16, 8)
    x_a, x_b = _randn(4, 16, seed=1), _randn(4, 16, seed=2)
    tape = []
    with pinned_quantizers(tape, replay=False):
        y_a = layers.linear_apply(p, x_a, QAT)
    assert [t.shape for t in tape] == [(16, 8), (4, 16)]
    x = x_b.clone().requires_grad_(True)
    with pinned_quantizers(tape, replay=True):
        y_b = layers.linear_apply(p, x, QAT)
    torch.testing.assert_close(y_b, y_a, atol=1e-6, rtol=1e-6)
    g = _randn(4, 8, seed=3)
    (gx,) = torch.autograd.grad(y_b, x, g)
    torch.testing.assert_close(gx, g @ tape[0].T, atol=1e-6, rtol=1e-6)
    with pytest.raises(AssertionError, match="ran out"):
        with pinned_quantizers(tape[:1], replay=True):
            layers.linear_apply(p, x_b, QAT)
    with pytest.raises(AssertionError, match="unused"):
        with pinned_quantizers(tape + tape, replay=True):
            layers.linear_apply(p, x_b, QAT)


def _moe(n_experts=4, d=16, f=24, seed=0):
    return MoE(Linear(_randn(d, n_experts, seed=seed)),
               {"gate_w": _randn(n_experts, d, f, seed=seed + 1),
                "up_w": _randn(n_experts, d, f, seed=seed + 2),
                "down_w": _randn(n_experts, f, d, seed=seed + 3)})


def test_pinned_routing_replays_the_recorded_experts():
    """A replayed route takes the recorded experts, the positions and keep
    mask ``moe_route`` takes from them, and this run's router logits at
    those experts for the gates; ``moe_apply`` runs on it and its router
    gets a gradient."""
    moe = _moe()
    x_a = _randn(12, 16, seed=5)
    x_b = -x_a   # routes elsewhere
    kw = dict(top_k=2, capacity_factor=1.0)
    tape = []
    with pinned_routing(tape, replay=False):
        r_a = layers.moe_route(moe, x_a, **kw)
    own_b = layers.moe_route(moe, x_b, **kw)
    assert not torch.equal(own_b["idx"], r_a["idx"])
    with pinned_routing(tape, replay=True):
        r_b = layers.moe_route(moe, x_b, **kw)
    for k in ("idx", "flat_idx", "pos", "keep"):
        assert torch.equal(r_b[k], r_a[k]), k
    assert not r_a["keep"].all(), "the case was meant to drop tokens"
    torch.testing.assert_close(
        r_b["gates"],
        torch.softmax(own_b["logits"].gather(-1, r_a["idx"]), -1))
    router = moe.router.w.clone().requires_grad_(True)
    moe_g = MoE(Linear(router), {k: getattr(moe, k) for k in
                                 ("gate_w", "up_w", "down_w")})
    with pinned_routing(tape, replay=True):
        out = layers.moe_apply(moe_g, x_b, ctx=QAT, **kw)
    (g,) = torch.autograd.grad(out.square().sum(), router)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_slstm_kinks_are_found_and_cut_from_the_backward():
    """The sLSTM's first-position input-gate pre-activations whose integer
    sum is exactly 0 are found from the quantized operands alone (every one
    of them, checked against ``ternary``'s own codes); cut from the
    backward, they leave the forward bit for bit and change the gradient of
    ``wx`` only in their columns; a replay of the masks gives the recorded
    run's gradients."""
    d, heads, hd, b, s = 8, 2, 4, 3, 5
    d_inner = heads * hd
    p = xlstm.slstm_init(torch.Generator().manual_seed(0), d, heads, hd)
    w_int = torch.from_numpy(np.random.default_rng(1).integers(
        -1, 2, (d, 4 * d_inner)).astype(np.float32))
    w_int[:, d_inner] = torch.tensor([1., -1., 0, 0, 0, 0, 0, 0])
    p["wx"].w = w_int * 0.5
    x = _randn(b, s, d, seed=2)
    x[:, 0, 1] = x[:, 0, 0]   # the first input-gate column sums to 0
    kw = dict(n_heads=heads, head_dim=hd)

    def run(tape, masks, record, exclude, found=None):
        w = p["wx"].w.clone().requires_grad_(True)
        q = Params(wx=Linear(w), r=p["r"], out=p["out"])
        xx = x.clone().requires_grad_(True)
        with pinned_quantizers(tape, replay=not record), (
                slstm_kinks_excluded(tape, masks, record, found) if exclude
                else contextlib.nullcontext()):
            out = xlstm.slstm_forward(q, xx, QAT, **kw)
        gw, gx = torch.autograd.grad(out.square().sum(), (w, xx))
        return out.detach(), gw, gx

    tape, masks, found = [], [], []
    out_x, gw_x, gx_x = run(tape, masks, True, True, found)
    out_f, gw_f, gx_f = run([], [], True, False)
    q_x = ternary.absmax_quant(x[:, 0], reciprocal=True)[0].double()
    want = (q_x @ w_int[:, d_inner:2 * d_inner].double()) == 0
    assert want[:, 0].all()
    assert len(masks) == 1
    assert torch.equal(masks[0][:, d_inner:2 * d_inner], want)
    assert not masks[0][:, :d_inner].any() and not masks[0][
        :, 2 * d_inner:].any()
    assert torch.equal(slstm_first_position_kinks(tape[0], tape[1]),
                       masks[0])
    assert found[0].abs().max() <= 1e-6
    assert torch.equal(out_x, out_f)
    cols = (gw_x != gw_f).any(0)
    assert cols.any() and not (cols & ~masks[0].any(0)).any()
    assert torch.equal(gx_x[:, 1:], gx_f[:, 1:])
    _, gw_r, gx_r = run(tape, masks, False, True)
    assert torch.equal(gw_r, gw_x) and torch.equal(gx_r, gx_x)
    assert leaf_grad_errors({"w": gw_r}, {"w": gw_x}) == {"w": 0.0}


def test_slstm_kinks_pinned_give_the_recorded_pre_activations():
    """With the kinks pinned, the recording run is the plain run bit for
    bit (forward and backward); a replay takes the recorded values at the
    mask, nothing cut from the backward: a replay of the recorded values
    equals the recorded run, and values 1e-6 either side of the jump move
    the gradient of ``wx`` in the mask's columns by far more than
    elsewhere."""
    d, heads, hd, b, s = 8, 2, 4, 3, 5
    d_inner = heads * hd
    p = xlstm.slstm_init(torch.Generator().manual_seed(0), d, heads, hd)
    w_int = torch.from_numpy(np.random.default_rng(1).integers(
        -1, 2, (d, 4 * d_inner)).astype(np.float32))
    w_int[:, d_inner] = torch.tensor([1., -1., 0, 0, 0, 0, 0, 0])
    p["wx"].w = w_int * 0.5
    x = _randn(b, s, d, seed=2)
    x[:, 0, 1] = x[:, 0, 0]   # the first input-gate column sums to 0
    kw = dict(n_heads=heads, head_dim=hd)

    def run(tape, pin, record):
        w = p["wx"].w.clone().requires_grad_(True)
        q = Params(wx=Linear(w), r=p["r"], out=p["out"])
        xx = x.clone().requires_grad_(True)
        with pinned_quantizers(tape, replay=not record), (
                slstm_kinks_pinned(tape, *pin, record) if pin is not None
                else contextlib.nullcontext()):
            out = xlstm.slstm_forward(q, xx, QAT, **kw)
        gw, gx = torch.autograd.grad(out.square().sum(), (w, xx))
        return out.detach(), gw, gx

    tape, masks, values = [], [], []
    out_r, gw_r, gx_r = run(tape, (masks, values), True)
    out_f, gw_f, gx_f = run([], None, True)
    assert torch.equal(out_r, out_f) and torch.equal(gw_r, gw_f)
    assert torch.equal(gx_r, gx_f)
    assert len(masks) == 1 and masks[0][:, d_inner].all()
    assert values[0].shape == (int(masks[0].sum()),)
    out_p, gw_p, gx_p = run(tape, (masks, values), False)
    assert torch.equal(out_p, out_r) and torch.equal(gw_p, gw_r)
    assert torch.equal(gx_p, gx_r)
    sides = [run(tape, (masks, [torch.full_like(values[0], v)]), False)[1]
             for v in (-1e-6, 1e-6)]
    col = masks[0].any(0)
    jump = (sides[0] - sides[1])[:, col].abs().max()
    assert jump > 100 * (sides[0] - sides[1])[:, ~col].abs().max()
    with pytest.raises(AssertionError, match="left recorded values unused"):
        run(tape, (masks + masks, values + values), False)
