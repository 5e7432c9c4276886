"""Meshes of the launchers (the port's ``repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no
process group.  A mesh is a ``runtime.collectives.TrainMesh`` over the
default process group, which both ``ServingEngine(mesh=)`` (through its
``get_group``/``get_local_rank``) and ``training.make_train_step_sharded``
take; where the world does not hold the production mesh's ranks, a
``collectives.DryMesh`` of its shape stands in (the dry run's one rank).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.runtime.collectives import DryMesh, TrainMesh


def make_production_mesh(*, multi_pod: bool = False):
    """One pod, 16 x 16 = 256 chips ("data", "model"), or two, 2 x 16 x 16
    = 512 ("pod", "data", "model"): a ``TrainMesh`` when the default
    process group has exactly its ranks, else a ``DryMesh`` (rank 0)."""
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                    else ((16, 16), ("data", "model")))
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return TrainMesh(shape, names)
    return DryMesh(shape, names)


def make_host_mesh(device: str | torch.device = "cuda") -> TrainMesh:
    """A (1, 1) ("data", "model") mesh of one rank.  Without a process
    group it first starts a world of one on an in-memory store (NCCL for
    a CUDA ``device``, gloo for the CPU)."""
    if not dist.is_initialized():
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return TrainMesh((1, 1))
