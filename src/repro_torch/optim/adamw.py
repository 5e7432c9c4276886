"""AdamW from scratch, the port's copy of ``repro/optim/adamw.py``.

Parameters, gradients and both moments are dicts {name: tensor} keyed by
the port's buffer names (``trainable``).  The update follows the JAX one
operation for operation: the count is incremented first, the warmup
multiplies by ``(step + 1) / warmup_steps`` with that incremented count,
global-norm clipping runs over every leaf, and weight decay goes to every
leaf of rank >= 2 *as JAX holds it*: the port keeps one tensor a layer
where JAX stacks the layers on a leading axis, so a per-layer norm
(``layers.3.ln1.w``, rank 1 here, rank 2 there) and a QKV bias are
decayed while ``final_norm.w`` is not (``jax_rank``).

``update`` works in place: it scales the caller's gradients by the clip
factor, updates the state's ``m`` and ``v`` tensors (the returned state
holds the same tensors) and builds each leaf's update from one temporary,
so a step holds the masters, the gradients, ``m``, ``v`` and one set of
updates.  ``m.mul_(b1).add_((1 - b1) * g)`` rounds the same two products
and sums them once, as ``b1 * m + (1 - b1) * g`` does.  A caller that needs
its gradients or the previous state after a step copies them first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar: updates taken
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def trainable(params) -> dict:
    """{buffer name: tensor} of a parameter ``ModuleDict`` (every float
    buffer), or a dict of tensors as it is."""
    if isinstance(params, nn.Module):
        return {n: t for n, t in params.named_buffers()
                if t.is_floating_point()}
    return dict(params)


def jax_rank(name: str, t: torch.Tensor) -> int:
    """The rank of the JAX leaf a port tensor belongs to: one more inside
    ``layers``, whose leaves JAX stacks over the layer axis."""
    return t.dim() + (1 if name.startswith("layers.") else 0)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, in place where it can be: the
    card's ``sqrtf`` and JAX's are; ATen's vectorised CPU ``sqrt`` is off by
    an ULP in some 0.6 % of elements, so on the CPU the root goes through
    f64, whose rounding to f32 is the correctly rounded f32 root."""
    if x.device.type == "cpu":
        return x.double().sqrt_().float()
    return x.sqrt_()


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float | None = 1.0,
          warmup_steps: int = 0) -> Optimizer:
    def schedule(step):
        if warmup_steps:
            return lr * torch.clamp_max((step + 1).float() / warmup_steps,
                                        1.0)
        return torch.tensor(lr, dtype=torch.float32, device=step.device)

    def init(params) -> AdamWState:
        p = trainable(params)
        dev = next(iter(p.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for n, t in p.items()},
            v={n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for n, t in p.items()})

    @torch.no_grad()
    def update(grads: dict, state: AdamWState, params):
        params = trainable(params)
        step = state.step + 1
        grads = {n: g if g.dtype == torch.float32 else g.float()
                 for n, g in grads.items()}
        if grad_clip is not None:
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-9),
                                    1.0)
            for g in grads.values():
                g.mul_(scale)
        for n, g in grads.items():
            state.m[n].mul_(b1).add_((1 - b1) * g)
            state.v[n].mul_(b2).add_((1 - b2) * g * g)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        neg_lr = -schedule(step)
        updates = {}
        for n, p in params.items():
            u = (state.m[n] / bc1).div_(_sqrt_(state.v[n] / bc2).add_(eps))
            if weight_decay and jax_rank(n, p) >= 2:  # matrices, not norms
                u.add_(weight_decay * p.float())
            updates[n] = u.mul_(neg_lr).to(p.dtype)
        return updates, AdamWState(step=step, m=state.m, v=state.v)

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params, updates: dict):
    """p + u for every leaf, in place for a parameter ``ModuleDict`` (its
    buffers), a new dict for a dict of tensors."""
    if isinstance(params, nn.Module):
        for n, t in trainable(params).items():
            t.add_(updates[n])
        return params
    return {n: p + updates[n] for n, p in params.items()}
