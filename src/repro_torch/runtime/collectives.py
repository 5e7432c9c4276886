"""How the ranks of a training mesh talk: manual collectives on process
groups, one group an axis.

The JAX package trains under ``jit`` with ``NamedSharding``s and lets
XLA's SPMD partitioner insert the collectives.  The port writes them by
hand instead of placing ``DTensor``s, for three reasons:

* the QAT quantizers take global statistics (a weight's absmean over all
  of it, a token's absmax over all its features) under ``no_grad``; with
  manual collectives each is one all-reduce of a scalar or of a (tokens,
  1) column, exact for a max;
* ``attention.FlashSkip`` and the STE quantizers are
  ``torch.autograd.Function``s built on tile loops and index puts, for
  which ``DTensor``'s sharding rules are not given;
* the serving mesh (``runtime/sharding.py``'s serving half) already runs
  manual collectives on gloo ranks, so one pattern serves both.

Only ``all_reduce`` and ``all_gather_into_tensor`` are used here (the
pipeline adds point to point sends and a ``broadcast``), so one code path
runs on gloo (CPU tests, two ranks on one card) and on NCCL.  The
primitive is chosen per backend when the mesh is built: on gloo a CUDA
tensor is staged through host memory around each collective; on NCCL the
collective runs on the tensor itself.

A :class:`TrainMesh` is a ("data", "model") grid over every rank of the
default group, rank ``i * model + j`` at coordinate ``(i, j)``; its groups
are made with ``dist.new_group`` by every rank in the same order, one a
line of each axis (a one-rank line too: the serving engine asks for the
group of each axis, ``get_group``).  Every mesh counts the bytes its
collectives give this rank (the result's bytes, JAX's per-device count
of a collective's HLO result) by JAX's kinds (``collective_bytes``).  A
:class:`DryMesh` has a mesh's shape and a rank's place on it, no process
groups: each collective returns a tensor of the right local shape and
only counts (the dry run's one rank of a production mesh, on ``meta``
tensors).  The
autograd functions at the bottom are Megatron's ``f`` (identity forward,
all-reduce backward) and ``g`` (the converse), and the sequence-parallel
pair: an all-gather whose backward reduce-scatters, and a reduce-scatter
(or plain split) whose backward all-gathers.  A reduce-scatter is an
all-reduce and a slice.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def as_axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


class MeshShape:
    """A mesh's axis names and sizes and one rank's coordinate on it, with
    no process groups: what the specs and a rank's slices need."""

    def __init__(self, shape: tuple, names: tuple = ("data", "model"),
                 rank: int = 0):
        if len(shape) != len(names):
            raise ValueError(f"mesh {shape} does not match axes {names}")
        self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.rank = rank
        self.grid = torch.arange(math.prod(shape)).reshape(shape)
        self.coord = dict(zip(names, (int(c) for c in torch.nonzero(
            self.grid == rank)[0])))
        self.collective_bytes = dict.fromkeys(KINDS, 0)

    def count(self, kind: str, t: torch.Tensor) -> None:
        """Add a collective's result ``t`` to this rank's bytes of
        ``kind``."""
        self.collective_bytes[kind] += t.numel() * t.element_size()

    def reset_collective_bytes(self) -> dict:
        """The counts so far, and every count back to 0."""
        out = dict(self.collective_bytes)
        self.collective_bytes = dict.fromkeys(KINDS, 0)
        return out

    # -- the mesh's shape ---------------------------------------------------

    def size(self, i: int) -> int:
        return self.shape[self.mesh_dim_names[i]]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in as_axes(axes))

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (a tuple counts as one axis,
        the first name major)."""
        i = 0
        for a in as_axes(axes):
            i = i * self.shape[a] + self.coord[a]
        return i

    def local(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` split evenly along ``dim`` over
        ``axes``."""
        n = self.axis_size(axes)
        if n == 1:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, self.index(axes) * size, size)

    def local_part(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` under ``spec`` (one
        axis, tuple of axes or None a dimension)."""
        for dim, axes in enumerate(spec):
            if axes is not None:
                t = self.local(t, axes, dim)
        return t


class TrainMesh(MeshShape):
    """This rank's place in a ("data", "model") training mesh of ``shape``
    over the default process group, with a group for each axis and one for
    the whole mesh (see the module docstring)."""

    def __init__(self, shape: tuple, names: tuple = ("data", "model")):
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {shape} does not cover the {world} "
                             "ranks")
        super().__init__(shape, names, dist.get_rank())
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo"
        self.groups = {}
        for i, name in enumerate(names):
            lines = self.grid.movedim(i, -1).reshape(-1, shape[i])
            for line in lines.tolist():   # every rank makes every group
                g = dist.new_group(line)
                if self.rank in line:
                    self.groups[(name,)] = g
        self.groups[tuple(names)] = None if world == 1 else dist.group.WORLD

    # -- the serving engine's DeviceMesh surface ----------------------------

    def get_group(self, axis: str):
        """The process group of one axis (the line through this rank)."""
        return self.groups[(axis,)]

    def get_local_rank(self, axis: str) -> int:
        return self.coord[axis]

    def _group(self, axes):
        axes = as_axes(axes)
        if axes == self.mesh_dim_names or len(axes) == 1:
            return self.groups[axes]
        if set(axes) == set(self.mesh_dim_names):
            raise ValueError(f"axes {axes} out of mesh order")
        raise ValueError(f"no group for axes {axes}")

    # -- collectives (in place or returning a new tensor) -------------------

    def _host(self, t):
        return t.cpu() if self.staged and t.is_cuda else t

    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM):
        """``t`` summed (or ``op``) over ``axes``, in place."""
        if self.axis_size(axes) == 1:
            return t
        self.count("all-reduce", t)
        h = self._host(t)
        dist.all_reduce(h, op=op, group=self._group(axes))
        if h is not t:
            t.copy_(h)
        return t

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``axes`` concatenated on ``dim`` in
        index order."""
        n = self.axis_size(axes)
        if n == 1:
            return t
        h = self._host(t.movedim(dim, 0).contiguous())
        out = torch.empty((n * h.shape[0],) + tuple(h.shape[1:]),
                          dtype=h.dtype, device=h.device)
        dist.all_gather_into_tensor(out, h, group=self._group(axes))
        self.count("all-gather", out)
        return out.to(t.device).movedim(0, dim)

    def full_part(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block under
        ``spec``: gathered over every axis that splits it."""
        for dim, axes in enumerate(spec):
            if axes is not None:
                t = self.all_gather(t, axes, dim)
        return t

    # -- autograd: the tensor-parallel region's boundaries ------------------

    def copy_to(self, x, axes):
        """Megatron's f: identity forward, all-reduce backward."""
        return x if self.axis_size(axes) == 1 else _CopyTo.apply(x, self,
                                                                 axes)

    def reduce_from(self, x, axes):
        """Megatron's g: all-reduce forward, identity backward."""
        return x if self.axis_size(axes) == 1 else _ReduceFrom.apply(
            x, self, axes)

    def gather(self, x, axes, dim: int, partial: bool):
        """All-gather on ``dim``; the backward takes this rank's block of
        the gradient, summed over ``axes`` first when ``partial`` (each
        rank used the whole for its own part of the work)."""
        return x if self.axis_size(axes) == 1 else _Gather.apply(
            x, self, axes, dim, partial)

    def scatter(self, x, axes, dim: int, reduce: bool):
        """This rank's block on ``dim``, of the sum over ``axes`` when
        ``reduce`` (a reduce-scatter of partial sums), else of ``x`` itself
        (whole and equal on every rank); the backward all-gathers."""
        return x if self.axis_size(axes) == 1 else _Scatter.apply(
            x, self, axes, dim, reduce)


class DryMesh(TrainMesh):
    """One rank (``rank``, 0 by default) of a mesh of ``shape`` with no
    process groups, and the collective surface of :class:`TrainMesh`: an
    all-reduce leaves its tensor as it is, an all-gather returns this
    rank's block repeated to the gathered shape, and each counts the bytes
    the real one would give this rank.  Autograd's functions run over it
    as over a real mesh.  The dry run's mesh when the world does not have
    the production mesh's ranks; its values mean nothing, its shapes and
    counts are the real ones."""

    def __init__(self, shape: tuple, names: tuple = ("data", "model"),
                 rank: int = 0):
        MeshShape.__init__(self, shape, names, rank)
        self.backend, self.staged, self.groups = None, False, {}

    def get_group(self, axis: str):
        raise ValueError("a DryMesh has no process groups")

    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM):
        if self.axis_size(axes) > 1:
            self.count("all-reduce", t)
        return t

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        n = self.axis_size(axes)
        if n == 1:
            return t
        out = torch.cat([t] * n, dim)
        self.count("all-gather", out)
        return out


def group_collectives(group):
    """(size, rank, all_reduce) of a process group (None: the default
    group) or of a whole training mesh (every axis of a
    :class:`TrainMesh`, counted, or of a :class:`DryMesh`, only counted):
    what a data-parallel step over ``group`` needs.  ``all_reduce(t)``
    sums in place and returns ``t``."""
    if isinstance(group, TrainMesh):
        axes = group.mesh_dim_names
        return (group.axis_size(axes), group.index(axes),
                lambda t: group.all_reduce(t, axes))

    def reduce(t):
        dist.all_reduce(t, group=group)
        return t

    return dist.get_world_size(group), dist.get_rank(group), reduce


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, partial):
        ctx.args = (mesh, axes, dim, partial)
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, partial = ctx.args
        if partial:
            g = mesh.all_reduce(g.clone(), axes)
        return mesh.local(g, axes, dim).contiguous(), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, reduce):
        ctx.args = (mesh, axes, dim)
        if reduce:
            x = mesh.all_reduce(x.clone(), axes)
        return mesh.local(x, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return (mesh.all_gather(g.contiguous(), axes, dim), None, None, None,
                None)
