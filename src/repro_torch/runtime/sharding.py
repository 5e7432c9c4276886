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

The training half follows: which dimension of each parameter, batch and
optimizer-state leaf a training mesh splits (``param_spec``,
``shard_params``, ``batch_spec``, ``shard_opt_state_zero1``), and the
``Ctx.constrain`` hook (``make_constrain``) that puts activations in
those layouts with manual collectives (``runtime/collectives.py``).  A
training mesh is a ``collectives.TrainMesh`` (or, for specs alone, a
``collectives.MeshShape``); any object with ``mesh_dim_names`` and
``size(i)`` serves the spec functions.  Rules, as the JAX package's (a
dimension goes to the first candidate axis that divides it, else it is
whole):
  * batch -> ("pod", "data");
  * a linear's output dimension (heads, d_ff, vocab) -> "model", a down
    projection's (``o``, ``down``, ``out_proj``, ``out``) input instead;
  * a linear's input dimension -> "data" under FSDP (``fsdp=``, the JAX
    launcher's choice for d_model >= FSDP_THRESHOLD);
  * the residual's sequence -> "model" for d_model >= SP_THRESHOLD.
The port keeps one tensor a layer where JAX stacks the layers on a leading
axis; ``jax_path`` maps a port buffer name to JAX's path, and
``leaf_spec`` drops the stacked axis from JAX's spec.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.runtime.collectives import as_axes

SP_THRESHOLD = 4096     # d_model at/above which the residual's sequence splits
FSDP_THRESHOLD = 4096   # d_model at/above which the launcher asks for FSDP


def axis_size(mesh, axes) -> int:
    """The number of ranks along ``axes``: one axis name, a tuple of them,
    or None (1)."""
    names = tuple(mesh.mesh_dim_names)
    return math.prod(mesh.size(names.index(a)) for a in as_axes(axes))


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


# ---------------------------------------------------------------------------
# The training half: parameter, batch and optimizer-state specs
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def all_axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _fit(mesh, dim: int, *candidates):
    """The first candidate axis (or tuple of axes) that divides ``dim``,
    else None."""
    for cand in candidates:
        if cand is None or cand == ():
            continue
        if dim % axis_size(mesh, cand) == 0:
            return cand
    return None


def jax_path(name: str) -> str:
    """The JAX tree path of a port buffer name: ``layers.3.attn.q.w`` ->
    ``layers/attn/q/w`` (a leaf JAX stacks over the layer axis)."""
    return re.sub(r"^layers\.\d+\.", "layers.", name).replace(".", "/")


def param_spec(mesh, path: str, shape, *, fsdp: bool) -> tuple:
    """The spec of one JAX parameter leaf, by its '/'-joined path and its
    JAX shape (a ``layers/`` leaf with the stacked L dimension first, never
    split): JAX's ``param_spec`` rule for rule."""
    stacked = path.startswith("layers/")
    lead = (None,) if stacked else ()
    dims = tuple(shape)[len(lead):]
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    def spec(*s):
        return lead + s

    if name == "tok":  # (vocab, d)
        return spec(_fit(mesh, dims[0], "model"), None)
    if re.match(r"(gate|up|down)_(w|codes)$", name):   # expert banks
        e_ax = _fit(mesh, dims[0], "model")
        in_ax = _fit(mesh, dims[1], "data") if fsdp else None
        if e_ax is not None:   # expert-parallel
            return spec(e_ax, in_ax, None)
        return spec(None, in_ax, _fit(mesh, dims[2], "model"))
    if name.endswith("_gamma"):
        return spec(_fit(mesh, dims[0], "model"))
    if name in ("w", "codes") and len(dims) == 2:
        out_ax = _fit(mesh, dims[1], "model")
        if out_ax is None or parent in ("down", "out_proj", "out", "o"):
            in_ax = _fit(mesh, dims[0], "model")
            fs = _fit(mesh, dims[1], "data") if fsdp else None
            return spec(in_ax, fs if in_ax is not None else out_ax)
        fs = _fit(mesh, dims[0], "data") if fsdp and name == "w" else None
        return spec(fs, out_ax)
    if name == "b":
        return spec(_fit(mesh, dims[0], "model"))
    if name == "gamma":
        return spec()
    return spec(*([None] * len(dims)))


def leaf_spec(mesh, name: str, shape, *, fsdp: bool,
              layout: str = "2d") -> tuple:
    """The spec of the port's buffer ``name`` of ``shape``: JAX's spec of
    the leaf it belongs to (``param_spec``), its stacked layer axis
    dropped.  ``layout="2d"``: tensor parallelism on "model" (and FSDP on
    "data" with ``fsdp``); ``"dp"``: every weight whole on every rank."""
    if layout not in ("2d", "dp"):
        raise ValueError(f"layout {layout!r} not one of ('2d', 'dp')")
    if layout == "dp":
        return (None,) * len(shape)
    path = jax_path(name)
    stacked = path.startswith("layers/")
    spec = param_spec(mesh, path, ((1,) if stacked else ()) + tuple(shape),
                      fsdp=fsdp)
    return spec[1:] if stacked else spec


def _model_only(spec: tuple) -> tuple:
    """``spec`` with every axis but "model" taken out."""
    return tuple(a if a == "model" else None for a in spec)


def map_buffers(module: nn.Module, fn, prefix: str = "") -> nn.Module:
    """A copy of a parameter tree of modules whose every buffer is
    ``fn(name, tensor)``; the modules are shallow copies, so their other
    attributes (a packed linear's ``g``, ``specs``) carry over."""
    out = copy.copy(module)
    out._buffers = {n: (None if t is None else fn(prefix + n, t))
                    for n, t in module._buffers.items()}
    out._modules = {n: map_buffers(m, fn, f"{prefix}{n}.")
                    for n, m in module._modules.items()}
    return out


def _set_specs(module: nn.Module, specs: dict, prefix: str = "") -> None:
    module.specs = {n: specs[prefix + n] for n, t in module._buffers.items()
                    if t is not None}
    for n, m in module._modules.items():
        _set_specs(m, specs, f"{prefix}{n}.")


def param_specs(mesh, params: nn.Module, *, fsdp: bool,
                layout: str = "2d") -> dict:
    """{buffer name: spec} of every buffer of a parameter tree."""
    return {n: leaf_spec(mesh, n, tuple(t.shape), fsdp=fsdp, layout=layout)
            for n, t in params.named_buffers()}


def shard_params(mesh, params: nn.Module, *, fsdp: bool,
                 layout: str = "2d") -> nn.Module:
    """This rank's part of the port's whole parameter tree: the same tree
    with every buffer cut to the rank's block under its spec (a copy that
    owns its memory: the step updates it in place), each module's
    ``specs`` ({buffer: whole spec}) set for the sharded step and the
    model.  This is how weights get onto a mesh: the whole tree (say
    ``convert.from_jax_params``), then ``shard_params``."""
    specs = param_specs(mesh, params, fsdp=fsdp, layout=layout)
    out = map_buffers(params,
                      lambda n, t: mesh.local_part(t, specs[n]).clone())
    _set_specs(out, specs)
    return out


def tree_specs(params: nn.Module) -> dict:
    """{buffer name: spec} that ``shard_params`` set on a tree's modules."""
    return {f"{prefix}{n}": s for prefix, m in
            ((p + "." if p else "", m) for p, m in params.named_modules())
            for n, s in getattr(m, "specs", {}).items()}


def tree_parts(mesh, specs: dict) -> dict:
    """{name: Part} of a {name: spec} dict, None for a whole leaf: the
    ``shardings=`` of a checkpoint."""
    return {n: Part(mesh, s) if any(a is not None for a in s) else None
            for n, s in specs.items()}


def batch_spec(mesh, global_batch: int, extra_dims: int) -> tuple:
    ba = _fit(mesh, global_batch, batch_axes(mesh), "data")
    return (ba,) + (None,) * extra_dims


def shard_opt_state_zero1(mesh, shapes: dict) -> dict:
    """ZeRO-1: {name: spec} splitting each optimizer-state leaf of
    ``shapes`` ({name: shape}) on its first dimension that the most of
    the mesh divides; a scalar stays whole."""
    def one(shape):
        if len(shape) == 0:
            return ()
        for axes in (all_axes(mesh), ("data", "model"), "data", "model"):
            for dim in range(len(shape)):
                if shape[dim] % axis_size(mesh, axes) == 0:
                    spec = [None] * len(shape)
                    spec[dim] = axes
                    return tuple(spec)
        return (None,) * len(shape)

    return {n: one(tuple(sh)) for n, sh in shapes.items()}


# ---------------------------------------------------------------------------
# The training half: Ctx.constrain
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Part:
    """A tensor that is this rank's block of a whole one under ``spec``:
    what a quantizer reduces over to take the whole tensor's statistic,
    and how a pinned replay cuts a recorded whole value to this rank's
    block."""
    mesh: object
    spec: tuple

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        return self.mesh.local_part(whole, self.spec)

    def splits(self, dims) -> tuple:
        """The mesh axes, in mesh order, that split any of ``dims``."""
        spec = self.spec
        axes = {a for d in dims for a in as_axes(spec[d % len(spec)])}
        return tuple(a for a in self.mesh.mesh_dim_names if a in axes)

    def reduce(self, t: torch.Tensor, op, dims) -> torch.Tensor:
        """``t`` reduced in place over the axes that split ``dims``."""
        axes = self.splits(dims)
        return self.mesh.all_reduce(t, axes, op) if axes else t

    def numel(self, local_shape) -> int:
        """Elements of the whole tensor."""
        return math.prod(local_shape) * axis_size(
            self.mesh, self.splits(range(len(self.spec))))


@dataclasses.dataclass(frozen=True)
class LinearParts:
    w: Part
    x: Part
    row: bool   # input features split on "model": partial sums out


class Constrain:
    """``Ctx.constrain`` on a training mesh, the port's ``make_constrain``.

    Under ``layout="2d"`` with a "model" axis of more than one rank the
    model runs tensor-parallel: heads, ``d_ff`` and (where "model" divides
    it) the vocabulary are split; the model calls the hook at JAX's four
    points and at the edges of each tensor-parallel region:

    * ``"embed"``: the start of a forward (records the sequence length);
    * ``"residual"``: before each block; with sequence parallelism
      (d_model >= SP_THRESHOLD and "model" dividing the sequence) the
      whole residual is split on its sequence, as JAX's constraint;
    * ``"tp_in"``: a block's normed input entering its linears: Megatron's
      f (identity forward, all-reduce backward), or under sequence
      parallelism an all-gather of the sequence (reduce-scatter
      backward); a row-parallel linear's partial sums leave by an
      all-reduce, or a reduce-scatter of the sequence (``row_out``);
    * ``"features"``: the backbone's output before the head (JAX's
      residual constraint before the chunked loss): the sequence gathered;
    * ``"head_in"``: the normed features entering a vocabulary-split
      head: f;
    * ``"logits"`` and ``"expert_buf"``: the logits stay split on the
      vocabulary; MoE is refused on such a mesh (A1b), so the buffer
      passes.

    Under ``"2d"`` on a "model" axis of one rank, and under ``"dp"`` and
    ``"dpzero1"`` (weights whole on every rank), every hook is the
    identity; the hook still says how the batch is split (``batch``),
    which a pinned replay reads.
    """

    def __init__(self, mesh, cfg, global_batch: int, layout: str = "2d"):
        if layout not in ("2d", "dp", "dpzero1"):
            raise ValueError(f"layout {layout!r}")
        self.mesh, self.cfg, self.layout = mesh, cfg, layout
        names = tuple(mesh.mesh_dim_names)
        if layout == "2d":
            self.batch = _fit(mesh, global_batch, batch_axes(mesh), "data")
        else:
            self.batch = _fit(mesh, global_batch, all_axes(mesh),
                              batch_axes(mesh), "data")
        m = axis_size(mesh, "model") if "model" in names else 1
        self.model_size = m
        self.tp = layout == "2d" and m > 1
        self.sp = self.tp and cfg.d_model >= SP_THRESHOLD
        self.vocab_split = self.tp and cfg.vocab_size % m == 0
        self._sp_now, self._seq = False, None
        if self.tp:
            if cfg.block_kind != "attn" or cfg.n_experts:
                raise NotImplementedError(
                    f"{cfg.name}: {cfg.block_kind!r} blocks"
                    + (" with experts" if cfg.n_experts else "")
                    + " on a 'model' axis of more than one rank need "
                    "expert-parallel dispatch or split recurrent scans "
                    "(ROADMAP A1b); train them under layout 'dp' or "
                    "'dpzero1', or on a 'model' axis of 1")
            if cfg.n_heads % m or (cfg.d_ff and cfg.d_ff % m):
                raise NotImplementedError(
                    f"{cfg.name}: {m} model ranks must divide n_heads "
                    f"{cfg.n_heads} and d_ff {cfg.d_ff}")

    @property
    def model_rank(self) -> int:
        return self.mesh.index("model") if self.tp else 0

    def __call__(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        if not self.tp:
            return x
        mesh = self.mesh
        if kind == "embed":
            self._sp_now = self.sp and x.shape[1] % self.model_size == 0
            self._seq = x.shape[1]
            return x
        if kind == "residual":
            if self._sp_now and x.shape[1] == self._seq:
                return mesh.scatter(x, "model", 1, reduce=False)
            return x
        if kind == "tp_in":
            return (mesh.gather(x, "model", 1, partial=True) if self._sp_now
                    else mesh.copy_to(x, "model"))
        if kind == "features":
            return (mesh.gather(x, "model", 1, partial=False)
                    if self._sp_now else x)
        if kind == "head_in":
            return mesh.copy_to(x, "model") if self.vocab_split else x
        if kind in ("logits", "expert_buf"):
            return x
        raise ValueError(f"unknown constrain kind {kind!r}")

    def row_out(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel linear's partial sums, summed over "model": the
        whole output (all-reduce) or, under sequence parallelism, this
        rank's part of the sequence (reduce-scatter)."""
        if self._sp_now:
            return self.mesh.scatter(y, "model", 1, reduce=True)
        return self.mesh.reduce_from(y, "model")

    def activation_part(self, x: torch.Tensor, row: bool = False) -> Part:
        """How a batch-major activation is split: the batch over
        ``batch``, the features over "model" for a row-parallel input."""
        spec = (self.batch,) + (None,) * (x.dim() - 1)
        if row:
            spec = spec[:-1] + ("model",)
        return Part(self.mesh, spec)

    def linear_parts(self, p, x: torch.Tensor) -> LinearParts:
        spec = _model_only(p.specs["w"]) if self.tp else (None, None)
        row = spec[0] == "model"
        if row and spec[1] is not None:
            raise NotImplementedError(f"a weight split on both dims {spec}")
        if row and p.b is not None:
            raise NotImplementedError("a row-parallel linear with a bias")
        return LinearParts(Part(self.mesh, spec),
                           self.activation_part(x, row), row)

    def whole(self, p, partial: bool):
        """A linear whose weight (and bias) are gathered whole over "model"
        for a rank that needs all of its outputs: with ``partial`` the rank
        uses them for its own part of the work (its gradient is summed over
        "model" and cut back to the rank's block), else every rank
        computes the same thing with them (its gradient is cut back)."""
        out = copy.copy(p)
        out._buffers = dict(p._buffers)
        specs = {}
        for n, t in p._buffers.items():
            if t is None:
                continue
            spec = _model_only(p.specs[n]) if self.tp else (None,) * t.dim()
            for dim, ax in enumerate(spec):
                if ax is not None:
                    t = self.mesh.gather(t, ax, dim, partial)
            out._buffers[n] = t
            specs[n] = (None,) * t.dim()
        out.specs = specs
        return out

    def embed(self, p, tokens: torch.Tensor) -> torch.Tensor:
        """The token lookup on a vocabulary-split table: each rank looks up
        the ids in its rows (zero elsewhere) and the partial rows are
        summed over "model" (Megatron's g)."""
        if not self.vocab_split:
            return p.tok[tokens]
        n = p.tok.shape[0]
        local = tokens - self.model_rank * n
        inside = (local >= 0) & (local < n)
        x = p.tok[local.clamp(0, n - 1)] * inside[..., None].to(p.tok.dtype)
        return self.mesh.reduce_from(x, "model")

    def xent_sum(self, logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
        """Sum over positions of logsumexp - gold logit, the logits split
        on the vocabulary: the max and the sum of exponentials reduced over
        "model", the gold logit from the rank that holds the label."""
        lf = logits.float()
        n = lf.shape[-1]
        with torch.no_grad():
            top = self.mesh.all_reduce(lf.amax(-1, keepdim=True), "model",
                                       dist.ReduceOp.MAX)
        total = self.mesh.reduce_from((lf - top).exp().sum(-1), "model")
        lse = top[..., 0] + total.log()
        local = labels.long() - self.model_rank * n
        inside = (local >= 0) & (local < n)
        flat = lf.reshape(-1, n)
        rows = torch.arange(flat.shape[0], device=lf.device)
        gold = flat[rows, local.clamp(0, n - 1).reshape(-1)].reshape(
            labels.shape)
        gold = self.mesh.reduce_from(torch.where(inside, gold, 0.0), "model")
        return (lse - gold).sum()


def make_constrain(mesh, cfg, global_batch: int,
                   layout: str = "2d") -> Constrain:
    """The ``Ctx.constrain`` hook of a training mesh (``Constrain``)."""
    return Constrain(mesh, cfg, global_batch, layout)


class Zero1:
    """ZeRO-1 of the AdamW moments of a whole parameter tree
    (``shard_opt_state_zero1`` of its trainable leaves): each rank
    keeps its block of ``m`` and ``v``; ``local`` cuts a whole leaf to the
    rank's block, ``gather`` puts a leaf's blocks back together."""

    def __init__(self, mesh, params):
        self.mesh = mesh
        self.specs = shard_opt_state_zero1(mesh, {
            n: tuple(t.shape) for n, t in params.named_buffers()
            if t.is_floating_point()})

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.local_part(t, self.specs[name])

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.full_part(t, self.specs[name])
