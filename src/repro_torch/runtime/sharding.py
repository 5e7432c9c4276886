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
those layouts with manual collectives (``runtime/collectives.py``); and
JAX's cache specs (``cache_sharding``).  A
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


def cache_sharding(mesh, cache: dict, global_batch: int) -> dict:
    """Specs of a cache's planes (a dict nested as the cache, of tensors
    or of anything with a ``shape``), JAX's rules: K/V (L, b, S, kv_h, hd)
    and their scales (L, b, S, kv_h) split the batch over ("pod", "data")
    and the sequence over "model"; a batch no batch axis divides (a
    long-context batch of one) leaves the batch whole and splits the
    sequence over ("data", "model"), "model" or "data"; a recurrent state
    (L, b, ...) splits its batch where it can."""
    ba = _fit(mesh, global_batch, batch_axes(mesh), "data")

    def one(name, shape):
        shape = tuple(shape)
        if (name in ("k", "v") and len(shape) == 5) or (
                name in ("k_scale", "v_scale") and len(shape) == 4):
            if ba is not None:
                seq = _fit(mesh, shape[2], "model")
                return (None, ba, seq) + (None,) * (len(shape) - 3)
            seq = _fit(mesh, shape[2], ("data", "model"), "model", "data")
            return (None, None, seq) + (None,) * (len(shape) - 3)
        if len(shape) >= 2:
            ba2 = _fit(mesh, shape[1], batch_axes(mesh), "data")
            return (None, ba2) + (None,) * (len(shape) - 2)
        return (None,) * len(shape)

    return {n: (cache_sharding(mesh, v, global_batch) if isinstance(v, dict)
                else one(n, v.shape)) for n, v in cache.items()}


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


class Rows:
    """A tensor whose leading dimensions are rows of a whole one, taken by
    index: a rank's experts of an expert bank, the rows of its expert
    buffer.  A quantizer's statistics stay its own (every row is whole in
    its features), and a pinned replay takes the same rows of a recorded
    whole value, zero where ``mask`` is false (a buffer row no token of
    this rank fills)."""

    def __init__(self, index: tuple, mask: Optional[torch.Tensor] = None):
        self.index, self.mask = index, mask

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        v = whole[tuple(i.to(whole.device) if torch.is_tensor(i) else i
                        for i in self.index)]
        if self.mask is not None:
            m = self.mask.to(v.device)
            v = v * m.reshape(m.shape + (1,) * (v.dim() - m.dim()))
        return v

    def splits(self, dims) -> tuple:
        return ()

    def reduce(self, t: torch.Tensor, op, dims) -> torch.Tensor:
        return t


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
    * ``"logits"``: the logits stay split on the vocabulary.

    What runs split on "model" and what runs whole, by kind (the storage
    is always JAX's spec, ``param_spec``):

    * attention: the rank's query heads (K and V gathered whole when
      "model" does not divide the KV heads), ``o`` row-parallel;
    * a dense FFN: ``d_ff`` split where "model" divides it; otherwise
      (``ffn_split`` false) the FFN is outside the tensor-parallel region:
      its weights gathered whole (``whole``), every rank computes it on its
      own residual (under sequence parallelism its part of the sequence);
    * MoE: each rank computes the experts ``experts(E)`` gives it, its
      share of the banks (split on E where "model" divides it, else
      gathered whole and cut); the router is gathered whole (top-k needs
      every logit); the partial outputs are summed over "model"
      (``row_out``);
    * hymba's SSM and xLSTM's mLSTM and sLSTM: the scans run on the rank's
      heads (``heads``).  A linear whose JAX split cuts concatenated
      columns (hymba's ``in_proj`` [x | z] and ``bc_proj`` [B | C], xLSTM's
      ``qkv``, ``gates`` and sLSTM's four-gate ``wx``) is gathered whole
      and its output cut to the rank's heads; a linear split on whole
      heads (hymba's ``dt_proj``, xLSTM's ``ogate``) runs column-parallel;
      ``out_proj`` and ``out`` run row-parallel; the dense leaves (conv
      weights, ``A_log``, ``D``, ``dt_bias``, sLSTM's ``r``) are whole and
      cut to the rank's heads (``shared``).

    Where "model" does not divide ``n_heads`` (``whole_mixer``), JAX's
    spec cuts columns inside a head.  The port then runs the block's mixer
    (the attention, with hymba's SSM beside it, or an xLSTM pair's mLSTM
    and sLSTM) whole on every "model" rank: its weights, stored in JAX's
    column parts all the same, are gathered whole (``whole(partial=
    False)``: each rank keeps only its block of their gradient, not summed,
    since every rank computes the same mixer on the same batch rows), its
    input is the whole residual (``mixer_in``: under sequence parallelism
    the sequence gathered) and its output is cut back (``mixer_out``);
    inside, ``mixer_ctx`` turns every hook off.  The FFN after it stays
    tensor-parallel.

    A leaf every rank holds whole but uses only its part of (``shared``,
    ``whole(partial=True)``) has its gradient summed over "model".

    Under ``"2d"`` on a "model" axis of one rank, and under ``"dp"`` and
    ``"dpzero1"`` (weights whole on every rank), every hook is the
    identity.  On any layout the hook says how the batch is split
    (``batch``): a pinned replay reads it, and MoE routing counts capacity
    and positions over the global batch (``token_span``,
    ``route_offsets``), as JAX's jitted step over a sharded batch does.
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
        self.ffn_split = self.tp and bool(cfg.d_ff) and cfg.d_ff % m == 0
        self.n_batch = axis_size(mesh, self.batch)
        self._sp_now, self._seq = False, None
        # "model" does not divide the heads: the mixer runs whole
        self.whole_mixer = self.tp and cfg.n_heads % m != 0

    @property
    def sp_now(self) -> bool:
        """The residual of this forward is split on its sequence."""
        return self._sp_now

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
        if kind == "logits":
            return x
        raise ValueError(f"unknown constrain kind {kind!r}")

    # -- a mixer run whole on every "model" rank (``whole_mixer``) ----------

    def mixer_in(self, h: torch.Tensor) -> torch.Tensor:
        """A block's normed input entering its mixer: ``tp_in`` when the
        mixer is split on heads; for a whole mixer the whole residual (no
        f: the gradient every rank takes back is the same whole one), under
        sequence parallelism the sequence gathered (each rank keeps its
        part of the gradient)."""
        if not self.whole_mixer:
            return self(h, "tp_in")
        return (self.mesh.gather(h, "model", 1, partial=False)
                if self._sp_now else h)

    def mixer_out(self, y: torch.Tensor) -> torch.Tensor:
        """A whole mixer's output back to the residual's layout: under
        sequence parallelism this rank's part of the sequence."""
        if self.whole_mixer and self._sp_now:
            return self.mesh.scatter(y, "model", 1, reduce=False)
        return y

    def mixer_ctx(self, ctx):
        """The context a whole mixer runs under: every hook an identity
        (the batch split stays, for the quantizers' parts)."""
        if not self.whole_mixer:
            return ctx
        off = copy.copy(self)
        off.tp = off.sp = off.vocab_split = off.ffn_split = False
        off.whole_mixer = off._sp_now = False
        return dataclasses.replace(ctx, constrain=off)

    def mixer_params(self, p):
        """A mixer's weights as it runs them: gathered whole for a whole
        mixer (each rank's gradient cut back to its block, not summed)."""
        return self.whole(p, partial=False) if self.whole_mixer else p

    def sp_partial(self, name: str) -> bool:
        """Under sequence parallelism, whether the gradient of the block
        leaf ``name`` that "model" does not split is a partial sum over
        "model" (each rank saw its part of the sequence): all but a whole
        mixer's, whose every rank saw the whole sequence."""
        return not (self.whole_mixer and re.match(
            r"layers\.\d+\.(attn|ssm|mlstm|slstm)\.", name))

    def row_out(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel linear's partial sums, summed over "model": the
        whole output (all-reduce) or, under sequence parallelism, this
        rank's part of the sequence (reduce-scatter)."""
        if self._sp_now:
            return self.mesh.scatter(y, "model", 1, reduce=True)
        return self.mesh.reduce_from(y, "model")

    def activation_part(self, x: torch.Tensor, row: bool = False) -> Part:
        """How a batch-major activation is split: the batch over
        ``batch``, the sequence over "model" for a part of the residual
        under sequence parallelism (a whole FFN's input), the features over
        "model" for a row-parallel input."""
        spec = (self.batch,) + (None,) * (x.dim() - 1)
        if (self._sp_now and x.dim() == 3
                and x.shape[1] * self.model_size == self._seq):
            spec = (self.batch, "model", None)
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

    def whole_tensor(self, t: torch.Tensor, spec: tuple, partial: bool
                     ) -> torch.Tensor:
        """A leaf of ``spec`` gathered whole over "model" (see ``whole``);
        a leaf already whole there, with ``partial``, passes Megatron's f
        so that its gradient is summed over "model" all the same (under
        sequence parallelism the step sums every block leaf whole over
        "model", each rank having seen part of the sequence: no f)."""
        if not self.tp:
            return t
        spec = _model_only(spec)
        if all(a is None for a in spec):
            return (self.mesh.copy_to(t, "model")
                    if partial and not self._sp_now else t)
        for dim, ax in enumerate(spec):
            if ax is not None:
                t = self.mesh.gather(t, ax, dim, partial)
        return t

    def whole(self, p, partial: bool):
        """A linear (or a sub-layer of them) whose weights (and biases) are
        gathered whole over "model" for a rank that needs all of their
        outputs: with ``partial`` the rank uses them for its own part of
        the work (their gradient is summed over "model" and cut back to the
        rank's block), else every rank computes the same thing with them
        (their gradient is cut back)."""
        if not self.tp:
            return p
        out = copy.copy(p)
        out._buffers = dict(p._buffers)
        out._modules = {n: self.whole(m, partial)
                        for n, m in p._modules.items()}
        specs = {}
        for n, t in p._buffers.items():
            if t is None:
                continue
            out._buffers[n] = self.whole_tensor(t, p.specs[n], partial)
            specs[n] = (None,) * t.dim()
        out.specs = specs
        return out

    def shared(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's heads' block of ``dim`` of a leaf every rank holds
        whole (conv weights, ``A_log``, sLSTM's ``r``): its gradient is
        summed over "model" (each rank's is nonzero on its block only; by
        the step under sequence parallelism, see ``whole_tensor``)."""
        if not self.tp:
            return t
        return self.mesh.local(self.whole_tensor(t, (None,) * t.dim(), True),
                               "model", dim)

    def heads(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of an activation's head-major ``dim`` (the
        output of a linear computed whole on every rank)."""
        return self.mesh.local(x, "model", dim % x.dim()) if self.tp else x

    def experts(self, n_experts: int) -> tuple:
        """[lo, hi): the experts whose tokens this rank computes, a
        contiguous block a "model" rank (JAX's expert-parallel block where
        "model" divides E)."""
        if not self.tp:
            return 0, n_experts
        r, m = self.model_rank, self.model_size
        return r * n_experts // m, (r + 1) * n_experts // m

    def expert_bank(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's experts (``experts``) of an (E, n_in, n_out) bank
        of ``spec``: its block where the bank is split on E over "model"
        (JAX's expert-parallel spec), else the bank gathered whole and cut
        (the spec splits each expert's n_out)."""
        if not self.tp or _model_only(spec)[0] == "model":
            return t
        lo, hi = self.experts(t.shape[0])
        return self.whole_tensor(t, spec, partial=True)[lo:hi]

    # -- MoE routing over the global batch (JAX's one program) --------------

    def token_span(self, n: int) -> tuple:
        """(start, total) of this rank's ``n`` tokens (its batch rows,
        flattened row-major) in the token order of the global batch: the
        batch ranks hold consecutive blocks of rows (``batch_spec``)."""
        if self.n_batch == 1:
            return 0, n
        return self.mesh.index(self.batch) * n, n * self.n_batch

    def route_offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """``counts`` (chunks, E), this rank's (token, slot) pairs of each
        global token chunk and expert -> the pairs of the same chunk and
        expert on the batch ranks before this one (one all-gather)."""
        if self.n_batch == 1:
            return torch.zeros_like(counts)
        every = self.mesh.all_gather(counts[None], self.batch, 0)
        return every[:self.mesh.index(self.batch)].sum(0)

    def token_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's ``n`` rows of a tensor over a whole pass's tokens
        (a routing recorded on one device), as ``token_span`` places
        them."""
        start, total = self.token_span(n)
        if t.shape[0] != total:
            raise ValueError(f"{t.shape[0]} recorded token rows, this pass "
                             f"has {total}")
        return t[start:start + n]

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
