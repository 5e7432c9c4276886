"""Which tensor dimension each axis of a serving mesh splits (the serving
half of ``repro/runtime/sharding.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("data", "model")``.  A spec is a tuple with one entry
per tensor dimension: the name of the mesh axis that splits it, or None
for a dimension every rank holds whole (the JAX package's
``PartitionSpec``).  The serving engine holds, on each rank:

* the scheduler state (slots,), the block table (slots, pages_per_slot)
  and the decode block's outputs (slots, block) split over ``data`` on
  their slot axis;
* a contiguous cache (L, slots, S, kv_h, hd) split likewise on its slot
  row axis;
* a paged pool (L, pages, page_size, kv_h, hd) whole on every rank, but
  written only for the rank's own slots: replicated in layout, divergent
  in value, so no rank may read another shard's pages (the engine's prefix
  sharing keeps one namespace a shard).

The training half (parameter specs, ZeRO-1, activation constraints) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def axis_size(mesh, name: str) -> int:
    return mesh.size(tuple(mesh.mesh_dim_names).index(name))


def serving_slot_axis(mesh, slots: int, *,
                      shard_slots: bool = True) -> Optional[str]:
    """The mesh axis carrying the decode slot batch: ``"data"`` when slot
    sharding is asked for and the axis divides the slot count, else None
    (every rank computes every slot)."""
    if not shard_slots or "data" not in tuple(mesh.mesh_dim_names or ()):
        return None
    return "data" if slots % axis_size(mesh, "data") == 0 else None


def serving_specs(mesh, *, slots: int, paged: bool, kv_quant: bool,
                  shard_slots: bool = True) -> dict:
    """Specs of every device structure the serving engine keeps from block
    to block (see the module docstring): ``state``, ``bt``, ``cache`` (a
    dict by plane), ``tokens`` and ``blk``, and ``slot_ax``."""
    sa = serving_slot_axis(mesh, slots, shard_slots=shard_slots)
    planes = ("k", "v") + (("k_scale", "v_scale") if kv_quant else ())
    if paged:
        cache = {n: (None,) * (5 if n in ("k", "v") else 4) for n in planes}
        bt = (sa, None)
    else:
        cache = {n: (None, sa, None, None, None) if n in ("k", "v")
                 else (None, sa, None, None) for n in planes}
        bt = (None, None)   # a contiguous engine has no block table
    return dict(slot_ax=sa, state=(sa,), bt=bt, cache=cache,
                tokens=(sa, None), blk=(sa, None))


def local_shape(mesh, spec: tuple, shape: tuple) -> tuple:
    """The shape of one rank's part of a tensor of ``shape`` under
    ``spec``: each split dimension divided by its axis's size."""
    return tuple(n if ax is None else n // axis_size(mesh, ax)
                 for ax, n in zip(spec, shape))


def all_gather_rows(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` (size * n, ...) <- every rank's ``x`` (n, ...) of ``group``
    concatenated in the group's rank order (one collective; newer PyTorch
    names it ``all_gather_single``)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)
