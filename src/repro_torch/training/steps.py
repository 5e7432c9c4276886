"""The QAT training step (forward, backward, AdamW), single-device and
data-parallel: the training half of ``repro/training/steps.py``.

A step takes the parameter ``ModuleDict`` (float masters), an
``AdamWState`` and a batch {"inputs", "labels"}, updates the parameters in
place and returns (params, opt_state, {"loss"}), the JAX step's shape.
Gradients are taken with ``torch.autograd.grad`` over every float buffer
(``optim.adamw.trainable``), which needs gradients only for the step's
duration.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.optim import compression
from repro_torch.optim.adamw import Optimizer, apply_updates, trainable


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over every position."""
    lf = logits.float()
    return (torch.logsumexp(lf, dim=-1)
            - transformer.gold_logits(lf, labels)).mean()


def _loss(cfg, ctx, params, batch, loss_chunk):
    if loss_chunk:
        x = transformer.forward_features(cfg, params, batch["inputs"], ctx)
        return transformer.lm_head_loss_chunked(cfg, params, x,
                                                batch["labels"], ctx,
                                                chunk=loss_chunk)
    logits = transformer.forward(cfg, params, batch["inputs"], ctx)
    return softmax_xent(logits, batch["labels"])


def loss_and_grads(cfg: ModelConfig, ctx: Ctx, params, batch: dict,
                   loss_chunk: int = 512):
    """(loss, {name: gradient}) of one batch: ``loss_chunk`` > 0 fuses the
    unembedding and cross-entropy a sequence chunk at a time
    (``transformer.lm_head_loss_chunked``), 0 takes the full logits."""
    leaves = trainable(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss = _loss(cfg, ctx, params, batch, loss_chunk)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(cfg: ModelConfig, ctx: Ctx, optimizer: Optimizer,
                    microbatches: int = 1, loss_chunk: int = 512):
    """One optimizer step.  With ``microbatches`` > 1 the batch's rows
    split into that many contiguous microbatches whose losses and
    gradients are summed in order, then divided by their count (JAX's scan
    accumulation)."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(cfg, ctx, params, batch, loss_chunk)
        else:
            rows = batch["inputs"].shape[0] // microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
            grads = None
            for i in range(microbatches):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                loss_i, g_i = loss_and_grads(cfg, ctx, params, mb, loss_chunk)
                loss = loss + loss_i
                grads = ({n: g.float() for n, g in g_i.items()}
                         if grads is None else
                         {n: grads[n] + g for n, g in g_i.items()})
            loss = loss / microbatches
            grads = {n: g / microbatches for n, g in grads.items()}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss}

    return train_step


def make_train_step_ddp(cfg: ModelConfig, ctx: Ctx, optimizer: Optimizer,
                        group=None, *, compress: bool = True,
                        loss_chunk: int = 512, return_grads: bool = False):
    """Pure data-parallel step on a ``torch.distributed`` group: every rank
    holds the same parameters and optimizer state, takes its rank's
    contiguous slice of the global batch (JAX's ``P(axes)`` split), and the
    gradients are all-reduced, int8 error-feedback compressed
    (``compression.compressed_psum``; the error state is an explicit
    argument and result) or as the f32 mean.  The loss is the mean over
    ranks.  ``train_step(params, opt_state, err, batch) -> (params,
    opt_state, err, {"loss"[, "grads"]})``; with ``return_grads`` the
    metrics carry a copy of the reduced gradients the update used, taken
    before AdamW clips them in place."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def train_step(params, opt_state, err, batch):
        rows = batch["inputs"].shape[0] // world
        local = {k: v[rank * rows:(rank + 1) * rows]
                 for k, v in batch.items()}
        loss, grads = loss_and_grads(cfg, ctx, params, local, loss_chunk)
        if compress:
            grads, err = compression.compressed_psum(grads, err, group)
        else:
            names = list(grads)
            flat = torch.cat([grads[n].float().reshape(-1) for n in names])
            dist.all_reduce(flat, group=group)
            out, lo = {}, 0
            for n in names:
                g = grads[n]
                out[n] = flat[lo:lo + g.numel()].reshape(g.shape) / world
                lo += g.numel()
            grads = out
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        metrics = {"loss": loss / world}
        if return_grads:
            metrics["grads"] = {n: g.clone() for n, g in grads.items()}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, err, metrics

    return train_step
