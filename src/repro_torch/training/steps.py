"""The QAT training step (forward, backward, AdamW), single-device,
data-parallel and on a ("data", "model") training mesh: the training half
of ``repro/training/steps.py``.

``make_prefill_fn`` and ``make_decode_fn`` close over the serving entry
points as the JAX ones do (the dry run's serving cells).

A step takes the parameter ``ModuleDict`` (float masters), an
``AdamWState`` and a batch {"inputs", "labels"}, updates the parameters in
place and returns (params, opt_state, {"loss"}), the JAX step's shape.
Gradients are taken with ``torch.autograd.grad`` over every float buffer
(``optim.adamw.trainable``), which needs gradients only for the step's
duration.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.optim import compression
from repro_torch.optim.adamw import Optimizer, apply_updates, trainable
from repro_torch.runtime import collectives, sharding


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
    if ctx.constrain is not None:   # logits split on the vocabulary
        labels = batch["labels"]
        return transformer.xent_sum(logits, labels, ctx) / labels.numel()
    return softmax_xent(logits, labels=batch["labels"])


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


def _microbatches(batch: dict, microbatches: int) -> list:
    """The batch's rows split into ``microbatches`` contiguous blocks
    (JAX's reshape to (microbatches, rows, ...))."""
    rows = batch["inputs"].shape[0] // microbatches
    return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            for i in range(microbatches)]


def _accumulated(cfg, ctx, params, mbs: list, loss_chunk):
    """(loss, gradients) of a batch given as its microbatches: their losses
    and gradients summed in order, then divided by their count (JAX's scan
    accumulation)."""
    if len(mbs) == 1:
        return loss_and_grads(cfg, ctx, params, mbs[0], loss_chunk)
    loss = torch.zeros((), dtype=torch.float32,
                       device=mbs[0]["labels"].device)
    grads = None
    for mb in mbs:
        loss_i, g_i = loss_and_grads(cfg, ctx, params, mb, loss_chunk)
        loss = loss + loss_i
        grads = ({n: g.float() for n, g in g_i.items()} if grads is None
                 else {n: grads[n] + g for n, g in g_i.items()})
    return loss / len(mbs), {n: g / len(mbs) for n, g in grads.items()}


def make_train_step(cfg: ModelConfig, ctx: Ctx, optimizer: Optimizer,
                    microbatches: int = 1, loss_chunk: int = 512):
    """One optimizer step.  With ``microbatches`` > 1 the batch's rows
    split into that many microbatches (``_accumulated``)."""

    def train_step(params, opt_state, batch):
        loss, grads = _accumulated(cfg, ctx, params,
                                   _microbatches(batch, microbatches),
                                   loss_chunk)
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
    before AdamW clips them in place.  ``group`` may also be a training
    mesh, all of whose ranks split the batch
    (``collectives.group_collectives``)."""
    world, rank, all_reduce = collectives.group_collectives(group)

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
            all_reduce(flat)
            out, lo = {}, 0
            for n in names:
                g = grads[n]
                out[n] = flat[lo:lo + g.numel()].reshape(g.shape) / world
                lo += g.numel()
            grads = out
        loss = all_reduce(loss.clone())
        metrics = {"loss": loss / world}
        if return_grads:
            metrics["grads"] = {n: g.clone() for n, g in grads.items()}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, err, metrics

    return train_step


def _flat_all_reduce(mesh, tensors: list, axes) -> list:
    """``tensors`` summed over ``axes`` in one all-reduce of their
    concatenation (as they are on an axis of one rank)."""
    if not tensors or mesh.axis_size(axes) == 1:
        return tensors
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    mesh.all_reduce(flat, axes)
    return [c.reshape(t.shape) for c, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step_sharded(cfg: ModelConfig, ctx: Ctx,
                            optimizer: Optimizer, mesh, *, global_batch: int,
                            layout: str = "2d", zero1=None,
                            microbatches: int = 1, loss_chunk: int = 512,
                            return_grads: bool = False):
    """One optimizer step on a training mesh (``collectives.TrainMesh``),
    the JAX step jitted over sharded parameters:
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"[, "grads"]})``, ``params`` this rank's part of the tree
    (``sharding.shard_params``; its specs say the layout) and ``batch`` the
    global batch of ``global_batch`` rows.

    * ``layout="2d"``: tensor parallelism on "model"
      (``sharding.make_constrain``), FSDP on "data" where the parameters'
      specs split a dimension over it (``shard_params(fsdp=True)``);
      ``"dpzero1"``: the parameters whole on every rank
      (``shard_params(layout="dp")``), the batch split over the whole
      mesh, the AdamW moments split ZeRO-1: ``zero1`` is
      ``sharding.Zero1(mesh, params)`` and ``opt_state`` comes from
      ``optimizer.init(params, zero1=zero1)``.
    * Each rank takes its block of the batch (``batch_spec``'s split),
      of each microbatch with ``microbatches`` > 1: JAX's microbatch j is
      the global rows [j * b / M, (j + 1) * b / M), and MoE counts
      capacity over a microbatch's tokens, so the rows counted together
      are those of JAX's microbatch.
      FSDP leaves are gathered over "data" a block at a time, inside the
      block's checkpoint region (``Constrain.fsdp``; the LM head once for
      the loss), and their gradients come back summed over "data" and cut
      to the rank's block, microbatch by microbatch: a rank holds its
      blocks of the tree and one block gathered.  Each gradient is
      averaged over the batch's axes (an FSDP leaf's summed over those
      other than "data"), and under sequence parallelism the gradients of
      a block's leaves that are whole over "model" (its norms: each rank
      saw part of the sequence) are summed over "model".
    * AdamW runs on the local blocks a leaf at a time (each gradient
      freed once applied), its clip norm over every distinct element
      once; under ZeRO-1 on the moments' blocks, each update
      all-gathered.
    * Microbatches are summed as in ``make_train_step``.
    ``return_grads`` copies the reduced gradients (this rank's blocks)
    into the metrics before AdamW clips them in place."""
    if layout not in ("2d", "dpzero1"):
        raise ValueError(f"layout {layout!r}: '2d' or 'dpzero1' (the "
                         "compressed 'dp' step is make_train_step_ddp)")
    if (layout == "dpzero1") != (zero1 is not None):
        raise ValueError("ZeRO-1 moments (zero1=) go with layout 'dpzero1'")
    hooks = sharding.make_constrain(mesh, cfg, global_batch, layout)
    sctx = dataclasses.replace(ctx, constrain=hooks)
    names = tuple(mesh.mesh_dim_names)
    batch_axes = hooks.batch
    n_batch = sharding.axis_size(mesh, batch_axes)
    # the batch axes an FSDP leaf's gradient is still to be summed over
    fsdp_rest = tuple(a for a in collectives.as_axes(batch_axes)
                      if a != "data")

    def split_axes(spec):
        axes = {a for s in spec for a in ((s,) if isinstance(s, str)
                                          else (s or ()))}
        return tuple(a for a in names if a in axes)

    def sq_sum(grads):
        """Sum of squares over every distinct element: each leaf's local
        sum, summed over the axes that split it (one all-reduce a set of
        axes), then the leaves' sums added in leaf order, as AdamW adds
        them on one device."""
        sums = {n: g.square().sum() for n, g in grads.items()}
        by_axes = {}
        for n in grads:
            axes = tuple(a for a in split_axes(specs[n])
                         if sharding.axis_size(mesh, a) > 1)
            if axes:
                by_axes.setdefault(axes, []).append(n)
        for axes, leaves in by_axes.items():
            vec = mesh.all_reduce(torch.stack([sums[n] for n in leaves]),
                                  axes)
            sums.update(zip(leaves, vec.unbind()))
        return sum(sums[n] for n in grads)

    specs = {}

    def train_step(params, opt_state, batch):
        specs.update(sharding.tree_specs(params))
        if batch["inputs"].shape[0] % (microbatches * n_batch):
            raise ValueError(f"{microbatches} microbatches of a batch of "
                             f"{batch['inputs'].shape[0]} rows do not split "
                             f"over {n_batch} batch ranks")
        mbs = [{k: mesh.local_part(v, (batch_axes,) + (None,) * (
            v.dim() - 1)) for k, v in mb.items()}
            for mb in _microbatches(batch, microbatches)]
        loss, grads = _accumulated(cfg, sctx, params, mbs, loss_chunk)
        for n in list(grads):   # one leaf at a time: no two copies of all
            grads[n] = grads[n].float()
        if hooks.sp:   # norms under sequence parallelism: partial sums
            part = [n for n in grads if n.startswith("layers.")
                    and "model" not in split_axes(specs[n])
                    and hooks.sp_partial(n)]
            for n, g in zip(part, _flat_all_reduce(
                    mesh, [grads[n] for n in part], "model")):
                grads[n] = g
        if n_batch > 1:   # an FSDP leaf's came back summed over "data"
            by_axes = {}
            for n in grads:
                by_axes.setdefault(fsdp_rest if "data" in specs[n]
                                   else batch_axes, []).append(n)
            for axes, order in by_axes.items():
                for n, g in zip(order, _flat_all_reduce(
                        mesh, [grads[n] for n in order], axes)):
                    grads[n] = g / n_batch
        loss = loss.clone()
        mesh.all_reduce(loss, batch_axes)
        metrics = {"loss": loss / n_batch}
        if return_grads:
            metrics["grads"] = {n: g.clone() for n, g in grads.items()}
        # AdamW a leaf at a time, each gradient freed once applied, at the
        # clip scale of every leaf (summed once): the values of one call
        leaves = trainable(params)
        total = []

        def clip_sq(_):
            if not total:
                total.append(sq_sum(grads))
            return total[0]

        state = opt_state
        for n in list(grads):
            upd, state = optimizer.update({n: grads[n]}, opt_state,
                                          {n: leaves[n]}, sq_sum=clip_sq,
                                          zero1=zero1)
            with torch.no_grad():
                leaves[n].add_(upd[n])
            del grads[n], upd
        return params, state, metrics

    return train_step



def make_prefill_fn(cfg: ModelConfig, ctx: Ctx):
    """``prefill_fn(params, inputs, cache) -> (logits, cache)``:
    ``transformer.prefill_step``."""
    def prefill_fn(params, inputs, cache):
        return transformer.prefill_step(cfg, params, inputs, ctx, cache)
    return prefill_fn


def make_decode_fn(cfg: ModelConfig, ctx: Ctx):
    """``decode_fn(params, inputs, cache, cache_len) -> (logits, cache)``:
    ``transformer.decode_step``."""
    def decode_fn(params, inputs, cache, cache_len):
        return transformer.decode_step(cfg, params, inputs, ctx, cache,
                                       cache_len)
    return decode_fn
