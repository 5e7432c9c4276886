"""What to pin so that a QAT step on the card and the same step on the CPU
differ only in the order of their sums.

A QAT step quantizes its activations to int8 and its weights to ternary
codes.  A sum taken in another order moves a value by a few ULPs, which now
and then moves a code by one, and a moved code moves the next linear's output
by a whole quantization step; an MoE router near a tie picks another expert.
``pinned_quantizers`` and ``pinned_routing`` record one device's quantized
values and experts in call order and replay them on the other.  Under
remat a block's forward runs twice, and both devices record or replay the
same calls in the same order.  ``slstm_kinks_pinned`` gives the few sLSTM
pre-activations that sit on a jump of the cell's gradient (found from the
recorded quantized values alone) the recording device's values, so both
devices take the same side; ``slstm_kinks_excluded`` takes them out of the
backward instead.
``leaf_grad_errors`` is the measure the gates read.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import ternary
from repro_torch.models import layers, xlstm


def _replayed(tape: list):
    played = iter(list(tape))

    def take():
        v = next(played, None)
        if v is None:
            raise AssertionError("pinned replay ran out of values")
        return v

    def check_used():
        if next(played, None) is not None:
            raise AssertionError("pinned replay left recorded values unused")
    return take, check_used


@contextlib.contextmanager
def pinned_quantizers(tape: list, replay: bool, *, gammas: bool = False):
    """Record each QAT quantizer's forward value (``absmax_quant_ste``,
    ``ternarize_ste``), in call order, into ``tape`` on the CPU; with
    ``replay``, give the recorded values back in that order instead,
    straight through.  Two devices that replay one tape run the same int8
    and ternary codes.  A rank of a training mesh replaying a tape recorded
    on one device takes its block of each value (the quantizer's
    ``part``).  With ``gammas`` a weight's entry is its gamma alone: the
    replay takes the weight's ternary value at the recorded gamma
    (``ternary.ternary_ste_at``), the same bits for the same master
    weights, and the tape stays the size of the activations (a full-width
    expert bank's values are 3.2 GB)."""
    saved = (ternary.absmax_quant_ste, ternary.ternarize_ste)
    take, check_used = _replayed(tape)

    def pin(fn):
        def pinned(x, *args, **kw):
            if replay:
                v = take()
                if kw.get("part") is not None:   # a rank's block of it
                    v = kw["part"].local(v)
                return x + (v.to(x.device, x.dtype) - x).detach()
            out = fn(x, *args, **kw)
            tape.append(out.detach().cpu())
            return out
        return pinned

    def pin_gamma(w, *args, **kw):
        part = kw.pop("part", None)
        if replay:
            g = take()
            if part is not None and g.dim():   # a gamma a rank's expert
                g = part.local(g)
        else:
            g = ternary.ste_gamma(w, *args, part=part, **kw)
            tape.append(g.detach().cpu())
        return ternary.ternary_ste_at(w, g.to(w.device))

    ternary.absmax_quant_ste = pin(saved[0])
    ternary.ternarize_ste = pin_gamma if gammas else pin(saved[1])
    try:
        yield tape
    finally:
        ternary.absmax_quant_ste, ternary.ternarize_ste = saved
    if replay:
        check_used()


@contextlib.contextmanager
def pinned_routing(tape: list, replay: bool):
    """Record each MoE layer's top-k experts (``layers.moe_route``'s
    ``idx``) into ``tape`` in call order; with ``replay``, route by the
    recorded experts instead of this run's top-k.  The gates stay the
    softmax of this run's router logits at those experts (the router's
    gradient), and the positions and keep mask follow from the experts by
    ``layers.route_positions``, as ``moe_route`` takes them.  A rank of a
    training mesh replaying a tape recorded on one device takes its
    tokens' rows of each routing (``Constrain.token_rows``)."""
    orig = layers.moe_route
    take, check_used = _replayed(tape)

    def route(p, x, *, top_k, capacity_factor, ctx=None):
        r = orig(p, x, top_k=top_k, capacity_factor=capacity_factor)
        if not replay:
            tape.append(r["idx"].cpu())
            return r
        idx = take()
        if ctx is not None and ctx.constrain is not None:
            idx = ctx.constrain.token_rows(idx, x.shape[0])
        idx = idx.to(x.device)
        flat = idx.reshape(-1)
        pos = layers.route_positions(flat, p.n_experts)
        return dict(r, gates=torch.softmax(r["logits"].gather(-1, idx), -1),
                    idx=idx, flat_idx=flat, pos=pos,
                    keep=pos < r["capacity"])

    layers.moe_route = route
    try:
        yield tape
    finally:
        layers.moe_route = orig
    if replay:
        check_used()


def slstm_first_position_kinks(w_q: torch.Tensor, x_q: torch.Tensor
                               ) -> torch.Tensor:
    """The sLSTM input-gate pre-activations of the first position that sit
    on the cell's kink, as a (b, 4 * d_inner) mask over ``wx``'s columns.

    At the first position the state is (c, n, h) = 0 and m = -1e30, so
    m' = i, the input weight exp(i - m') is 1 and the normalizer is
    ``max(1, exp(-i))``, whose gradient in i jumps from -1 to 0 at i = 0.
    A QAT linear's integer sum is exactly 0 now and then; its f32 value is
    then a rounding residue whose sign depends on the order of the sum,
    which picks the side of the jump.  Found from the quantized operands
    alone (``w_q`` the fake-quantized (d, 4 * d_inner) weight, ``x_q`` the
    fake-quantized (b, s, d) input, as ``pinned_quantizers`` records them;
    the sLSTM's ``wx`` has no bias): the exact integer sums x_int . W_t
    that are 0."""
    d_inner = w_q.shape[1] // 4
    x0 = x_q[:, 0].double()
    step = x0.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 127.0
    x_int = torch.round(x0 / step)
    if (x_int * step - x0).abs().max() > 1e-5 * x0.abs().max():
        raise AssertionError("not an absmax-int8 fake-quantized input")
    i_int = x_int @ torch.sign(w_q[:, d_inner:2 * d_inner].double())
    mask = torch.zeros((x_q.shape[0], 4 * d_inner), dtype=torch.bool)
    mask[:, d_inner:2 * d_inner] = i_int == 0
    return mask


def _kinks_of_tape(tape: list, wx_t: torch.Tensor) -> torch.Tensor:
    """The first-position kink mask of the sLSTM whose input projection
    ``wx_t`` is: from its quantized operands, the last two values that the
    pin recorded into ``tape``."""
    w_q, x_q = tape[-2], tape[-1]
    if (w_q.dim(), x_q.dim()) != (2, 3) or w_q.shape[1] != wx_t.shape[-1]:
        raise AssertionError(
            "the pin's last values are not wx's quantized operands: "
            f"{tuple(w_q.shape)}, {tuple(x_q.shape)}")
    return slstm_first_position_kinks(w_q, x_q)


@contextlib.contextmanager
def slstm_kinks_pinned(tape: list, masks: list, values: list,
                       record: bool):
    """Give every sLSTM's first-position kinks
    (``slstm_first_position_kinks``) the recording device's f32
    pre-activation values: nothing is cut from the backward, and both
    devices take the same side of each jump.  Enter it inside
    ``pinned_quantizers``.  With ``record`` each sLSTM's mask is worked out
    from the input projection's quantized values (the pin's last two in
    ``tape``) and appended to ``masks``, and this device's pre-activations
    there to ``values``; the forward is unchanged.  Otherwise the masks and
    values are replayed in call order: at the mask the pre-activation takes
    the recorded value, straight through (its gradient is the identity, as
    everywhere else)."""
    cell = xlstm._slstm_cell
    take_mask, masks_used = _replayed(masks)
    take_value, values_used = _replayed(values)

    def pinned(p, wx_t, st):
        if not bool(st["n"].any()):    # the first position: n = 0
            if record:
                mask = _kinks_of_tape(tape, wx_t)
                masks.append(mask)
                values.append(wx_t.detach()[mask.to(wx_t.device)].cpu())
            else:
                mask = take_mask().to(wx_t.device)
                at = wx_t.detach().clone()
                at[mask] = take_value().to(at.device, at.dtype)
                wx_t = wx_t + (at - wx_t).detach()
        return cell(p, wx_t, st)

    xlstm._slstm_cell = pinned
    try:
        yield masks
    finally:
        xlstm._slstm_cell = cell
    if not record:
        masks_used()
        values_used()


@contextlib.contextmanager
def slstm_kinks_excluded(tape: list, masks: list, record: bool,
                         found: list | None = None):
    """Take the first-position kinks of every sLSTM
    (``slstm_first_position_kinks``) out of the backward: there the
    gradient to ``wx`` is cut; the forward is unchanged.  Enter it inside
    ``pinned_quantizers``.  With ``record`` each sLSTM's mask is worked out
    from the input projection's quantized values, the last two that the pin
    recorded into ``tape``, and appended to ``masks``; otherwise the masks
    are replayed from ``masks`` in call order.  ``found`` gets the
    pre-activations at each mask, on the CPU."""
    cell = xlstm._slstm_cell
    take, check_used = _replayed(masks)

    def excluded(p, wx_t, st):
        if not bool(st["n"].any()):    # the first position: n = 0
            if record:
                mask = _kinks_of_tape(tape, wx_t)
                masks.append(mask)
            else:
                mask = take()
            mask = mask.to(wx_t.device)
            if found is not None:
                found.append(wx_t.detach()[mask].cpu())
            wx_t = torch.where(mask, wx_t.detach(), wx_t)
        return cell(p, wx_t, st)

    xlstm._slstm_cell = excluded
    try:
        yield masks
    finally:
        xlstm._slstm_cell = cell
    if not record:
        check_used()


def leaf_grad_errors(got: dict, ref: dict) -> dict:
    """{leaf: max |got - ref| / max |ref|} over the gradient leaves."""
    return {n: ((got[n] - g).abs().max() / g.abs().max()).item()
            for n, g in ref.items()}
