"""GPipe pipeline parallelism over a process group: the port's copy of
``repro/runtime/pipeline.py``.

Layers are split into S stages, one a rank of the group (the group's rank
order is the stage order); microbatches stream through in GPipe's
fill-drain schedule: T = n_micro + S - 1 ticks, stage s works on
microbatch t - s at tick t (bubble (S - 1) / T).  Between ticks each stage
sends its output to the next (JAX's ``ppermute`` ring, whose wrap-around
edge stage 0 never reads, so the port leaves it out) with point to point
sends; at the end the last stage's outputs are broadcast to every stage.
A stage whose microbatch index is out of range idles in its tick, where
JAX's SPMD stage computes on a placeholder it then throws away.  Forward
only, as in JAX.  On gloo, CUDA activations are staged through host
memory, as ``runtime/collectives.py`` does.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _host(t: torch.Tensor, group) -> torch.Tensor:
    staged = dist.get_backend(group) == "gloo" and t.is_cuda
    return t.cpu() if staged else t


def pipeline_forward(stage_fn: Callable, group, stage_params,
                     x_micro: torch.Tensor) -> torch.Tensor:
    """Run microbatches through a pipeline over ``group`` (None: the
    default group).

    stage_fn(params_of_this_stage, x) -> y, of x's shape
    stage_params: this rank's stage's parameters
    x_micro: (n_micro, mb, ...) the microbatches (every rank holds them;
    only stage 0 reads them)
    Returns the (n_micro, mb, ...) outputs of the last stage, on every
    rank."""
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    outputs = torch.zeros_like(x_micro)
    inflight = torch.zeros_like(x_micro[0])
    nxt = (dist.get_global_rank(group, stage + 1)
           if group is not None and stage + 1 < n_stages else stage + 1)
    prv = (dist.get_global_rank(group, stage - 1)
           if group is not None and stage > 0 else stage - 1)
    for t in range(ticks):
        mine = t - stage
        y = None
        if 0 <= mine < n_micro:
            y = stage_fn(stage_params, x_micro[mine] if stage == 0
                         else inflight)
            if stage == n_stages - 1:
                outputs[mine] = y
        ops, recv = [], None
        if stage + 1 < n_stages and y is not None:
            ops.append(dist.P2POp(dist.isend, _host(y.contiguous(), group),
                                  nxt, group))
        if stage > 0 and 0 <= t - (stage - 1) < n_micro:
            recv = _host(inflight, group)
            ops.append(dist.P2POp(dist.irecv, recv, prv, group))
        for work in (dist.batch_isend_irecv(ops) if ops else []):
            work.wait()
        if recv is not None and recv is not inflight:
            inflight.copy_(recv)
    if n_stages > 1:
        host = _host(outputs, group)
        dist.broadcast(host, src=dist.get_global_rank(group, n_stages - 1)
                       if group is not None else n_stages - 1, group=group)
        if host is not outputs:
            outputs.copy_(host)
    return outputs


def split_layers_into_stages(layers, n_stages: int):
    """Stacked (L, ...) layer tensors -> (S, L/S, ...) stage-major, as
    JAX's; a sequence of per-layer parameters (the port's
    ``params["layers"]``) -> S lists of L/S consecutive layers."""
    if isinstance(layers, torch.Tensor):
        n = layers.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return layers.reshape((n_stages, n // n_stages)
                              + tuple(layers.shape[1:]))
    layers = list(layers)
    n = len(layers)
    assert n % n_stages == 0, (n, n_stages)
    per = n // n_stages
    return [layers[i * per:(i + 1) * per] for i in range(n_stages)]
