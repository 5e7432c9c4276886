"""Dry run: build every (arch x shape x mesh) cell of the production mesh
and estimate one rank's step, with no card and no cluster (the port's
``repro/launch/dryrun.py``, with its CLI, cells and outputs).

JAX lowers and compiles each cell for 512 placeholder devices and reads
XLA's memory and cost analyses.  PyTorch has no compile-only analysis, so
the port runs one rank's step on ``meta`` tensors (shapes and dtypes, no
storage, no arithmetic):

* the mesh is the production shape with no process groups
  (``collectives.DryMesh``, rank 0): each collective returns a tensor of
  the right local shape and adds the bytes of its result to a count by
  JAX's kinds (the port issues all-reduces and all-gathers);
* ``argument_bytes``: the exact local bytes of the parameters, optimizer
  state (and compressed DP's error state), batch and cache under the
  port's specs, parameters in bf16 as JAX's ``eval_shape`` there;
* ``peak_bytes_est``: ``argument_bytes`` plus the most bytes live at once
  of the storages the step makes (a dispatch mode, ``Census``, follows
  each new storage from the op that makes it to its release);
  ``output_bytes`` are the step's results, ``alias_bytes`` those that are
  arguments updated in place, ``temp_bytes`` the rest of that peak, so
  that argument + output + temp - alias is the peak, JAX's formula;
* ``cost.flops``: the formulas of ``torch.utils.flop_counter``'s
  ``FlopCounterMode`` applied op by op (matrix products and attention
  kernels; elementwise work counts 0, as in its tables);
  ``cost.bytes_accessed``: the bytes of every op's tensor inputs and
  outputs (a view moves none);
* ``trace_s`` stands where JAX has ``lower_s``/``compile_s``.

Limits: no allocator rounding, fragmentation, cached blocks or library
workspaces (cuBLAS, NCCL), and no fusion: every op's output is a storage
of its own and its bytes are read and written once.  ``chip_smoke.py``
phase 15 (b) holds one cell's estimate to the card's allocator.

Serving cells run the packed model as ``ServingEngine`` serves a mesh
(its ``mesh=``): the packed weights whole on every rank, a rank's share of
the batch rows (the slots, padded to a multiple of the batch ranks; the
pod axis of 2 x 16 x 16 counts as more "data" ranks, though the engine
takes a ("data", "model") mesh alone) and of a cache whole in its
sequence, and no collective in the model.  JAX's partitioned program
splits the weights and the cache's sequence over "model" instead
(``sharding.cache_sharding``), which the port's engine does not, so a
serving cell's bytes are the port's, not JAX's.  The kernels' plain
versions take the meta tensors, so a cell counts their work (the prompt
attention's plain version scores every key tile of every query row, where
the kernel skips the dead ones).  A cell that
meets an op with no meta rule fails loudly (``error`` and the traceback
in its JSON).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k [--multi-pod | --both-meshes] [--opt kv8,dp]
Outputs JSON a cell under ``--out`` (default experiments/dryrun_torch).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.optim.adamw import adamw, trainable
from repro_torch.optim.compression import init_error_state
from repro_torch.runtime import sharding as shd
from repro_torch.training import steps

_FACTORIES = (torch.randn, torch.rand, torch.randint, torch.zeros,
              torch.ones, torch.full, torch.empty, torch.arange,
              torch.tensor, torch.normal, torch.randperm, torch.zeros_like,
              torch.ones_like, torch.empty_like, torch.full_like)


class MetaInit(TorchFunctionMode):
    """Every tensor factory makes a ``meta`` tensor and draws nothing (its
    ``generator`` dropped): a parameter tree of the right shapes and dtypes
    from the model's own init code."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs.pop("generator", None)
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _flat(tree) -> list:
    """The tensors of a tree of tensors, lists, tuples, dicts and module
    trees (their buffers): an op's arguments or results, a step's."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.buffers())
    return []


_SCALARS = (bool, int, float, torch.dtype, type(None))


class _NoSig(Exception):
    pass


def _sig(a):
    """A hashable signature of an op's argument: a tensor by its meta
    shape, strides and dtype; scalars, dtypes and the like by value."""
    if isinstance(a, torch.Tensor):
        if not a.is_meta:
            raise _NoSig
        return (a.dtype, tuple(a.shape), a.stride())
    if isinstance(a, (tuple, list)):
        return tuple(_sig(v) for v in a)
    if isinstance(a, _SCALARS) or isinstance(a, (str, torch.device,
                                                 torch.layout,
                                                 torch.memory_format)):
        return (type(a), a)
    raise _NoSig


class Census(TorchDispatchMode):
    """Follows one step's ops (see the module docstring): ``flops`` by
    ``FlopCounterMode``'s formulas (its ``flop_registry``, an op it has no
    formula for decomposed first where it can be, as that mode does),
    ``peak`` (bytes live at once of the storages made inside the mode) and
    ``accessed`` (each op's tensor inputs and outputs; a view moves
    nothing).
    Storages alive before it starts (``known``: the arguments) are never
    counted as made.  On ``meta`` tensors a functional op's result is
    remembered by its arguments' signature (``_fast``): many of PyTorch's
    meta functions are Python (0.1-3 ms an op), and a sequential scan
    repeats the same few ops on the same shapes millions of times."""

    def __init__(self, known=()):
        super().__init__()
        self.known = {_storage(t)._cdata for t in known}
        self.live, self.now, self.peak = {}, 0, 0
        self.accessed, self.flops = 0, 0
        self._memo, self._kinds = {}, {}

    def _made(self, out):
        for t in out:
            st = _storage(t)
            key = st._cdata
            if key in self.live or key in self.known:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.now += n
            weakref.finalize(st, self._freed, key)
        self.peak = max(self.peak, self.now)

    def _freed(self, key):
        self.now -= self.live.pop(key, 0)

    def _kind(self, func):
        """(kind, FLOP formula) of an op: "view" (its result aliases an
        input and moves nothing; ``_unsafe_view`` too), "decompose" (no
        formula, and a composite kernel to decompose it by, as
        ``FlopCounterMode`` does), "inplace" or "functional"."""
        formula = flop_registry.get(func._overloadpacket)
        sch = func._schema
        if formula is None and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            kind = "decompose"
        elif sch.is_mutable:
            kind = "inplace"
        elif func is torch.ops.aten._unsafe_view.default or any(
                r.alias_info is not None for r in sch.returns):
            kind = "view"
        else:
            kind = "functional"
        self._kinds[func] = kind, formula
        return kind, formula

    def _fast(self, func, args, kwargs):
        """A functional op's result on meta tensors from the results it
        gave before for arguments of the same shapes, strides, dtypes and
        values, or None (run the op's own meta function, and remember).
        A meta function is a pure function of those, so this is exact."""
        try:
            key = (func, _sig(args), _sig(tuple(kwargs.items())))
        except _NoSig:
            return None
        got = self._memo.get(key)
        if got is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(isinstance(t, torch.Tensor) and t.is_meta for t in outs):
                self._memo[key] = (isinstance(out, (tuple, list)), [
                    (t.shape, t.stride(), t.dtype) for t in outs])
            return out
        many, metas = got
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                for sh, st, dt in metas]
        return tuple(outs) if many else outs[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, formula = self._kinds.get(func) or self._kind(func)
        if kind == "view":
            return func(*args, **kwargs)
        if kind == "decompose":
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = None
        if kind == "functional":
            out = self._fast(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins = _flat(args) + _flat(kwargs) if kwargs else _flat(args)
        outs = _flat(out)
        self.accessed += sum(_nbytes(a) for a in ins) + sum(
            _nbytes(t) for t in outs)
        if kind != "inplace":
            self._made(outs)
        return out


def _distinct_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = _storage(t)
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


@dataclasses.dataclass
class Cell:
    """One cell: ``fn(*args)`` is one rank's step; ``local_bytes`` the
    exact bytes of its arguments on the rank (the batch's block where the
    step is given the global batch and cuts it itself)."""
    fn: object
    args: tuple
    mesh: object
    local_bytes: int
    microbatches: int = 1


def bf16_params(cfg, device="meta", seed: int = 0):
    """The model's float masters in bf16 (JAX's ``init_params(dtype=
    bfloat16)``): drawn on a real ``device`` from ``seed``, or, on
    ``meta``, shapes only (``MetaInit``)."""
    if torch.device(device).type == "meta":
        with MetaInit():
            params = transformer.init_params(cfg, torch.Generator())
    else:
        params = transformer.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed))
    for m in params.modules():
        for n, t in m._buffers.items():
            if t is not None and t.is_floating_point():
                m._buffers[n] = t.to(torch.bfloat16)
    return params


def make_ctx(cfg, mesh, global_batch, *, mode, opt=()):
    """JAX's ``make_ctx``: bf16 activations, MoE token chunks of 32768,
    ``kv8``/``int8fwd``/``rematdots`` from ``opt``, and the training
    hook of the layout (``dp`` for ``dp``/``dpzero1``, else ``2d``).
    Training attention is the plain flash recomputation (JAX's XLA
    attention); the serving cells take the attention kernels' wrappers."""
    train = mode == "qat"
    layout = ("dpzero1" if "dpzero1" in opt else
              "dp" if "dp" in opt else "2d")
    return Ctx(mode=mode, attn="skip" if train else "kernel",
               act_dtype=torch.bfloat16,
               moe_token_chunk=32768 if cfg.n_experts else 0,
               qat_int8_fwd="int8fwd" in opt,
               remat_policy="dots" if "rematdots" in opt else "nothing",
               constrain=(shd.make_constrain(mesh, cfg, global_batch, layout)
                          if train else None))


def microbatches_of(cfg, global_batch: int, n_batch: int) -> int:
    """JAX's rule (big archs trade steps for activation memory), halved
    until a microbatch's rows split over the ``n_batch`` batch ranks: 16
    microbatches of a 256-row batch do not split over 2 x 16 x 16's 32
    (XLA reshards them; the port's ranks each take a block of every
    microbatch)."""
    if cfg.d_model >= 8192:
        mb = 16
    elif cfg.n_experts:
        mb = 8
    elif cfg.d_model >= shd.FSDP_THRESHOLD or cfg.n_layers >= 32 \
            or cfg.block_kind == "hymba":
        mb = 4
    else:
        mb = 1
    while mb > 1 and global_batch % (mb * n_batch):
        mb //= 2
    return mb


def build_cell(arch: str, shape, mesh, opt=(), *, device="meta", cfg=None,
               seed: int = 0) -> Cell:
    """One rank's step of a cell.  ``shape`` is a ``SHAPES`` name or a
    ``ShapeConfig``; ``cfg`` overrides the arch's config (a reduced one);
    on a real ``device`` the parameters are drawn from ``seed``, the batch
    is zeros and the cache as ``init_cache`` makes it (their values do not
    change the work, bar MoE routing).  ``opt``: a subset of {"kv8", "dp",
    "dpzero1", "compress", "rematdots", "int8fwd"}; empty is the paper's
    layout."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    gb, seq = shape.global_batch, shape.seq_len
    fsdp = cfg.d_model >= shd.FSDP_THRESHOLD
    params = bf16_params(cfg, device, seed)

    if shape.kind == "train":
        ctx = make_ctx(cfg, mesh, gb, mode="qat", opt=opt)
        optimizer = adamw()
        batch = {k: torch.zeros_like(v, device=device) for k, v in
                 make_batch_specs(cfg, gb, seq, device="meta").items()}
        if "dpzero1" in opt:
            p = shd.shard_params(mesh, params, fsdp=False, layout="dp")
            z = shd.Zero1(mesh, p)
            state = optimizer.init(p, zero1=z)
            fn = steps.make_train_step_sharded(
                cfg, ctx, optimizer, mesh, global_batch=gb,
                layout="dpzero1", zero1=z)
            hook = ctx.constrain
            args, mb = (p, state, batch), 1
        elif "dp" in opt:
            p = shd.shard_params(mesh, params, fsdp=False, layout="dp")
            state = optimizer.init(p)
            err = init_error_state(trainable(p))
            fn = steps.make_train_step_ddp(cfg, ctx, optimizer, mesh,
                                           compress="compress" in opt)
            hook = shd.make_constrain(mesh, cfg, gb, "dpzero1")
            args, mb = (p, state, err, batch), 1
        else:
            p = shd.shard_params(mesh, params, fsdp=fsdp)
            state = optimizer.init(p)
            mb = microbatches_of(cfg, gb, ctx.constrain.n_batch)
            fn = steps.make_train_step_sharded(
                cfg, ctx, optimizer, mesh, global_batch=gb, microbatches=mb)
            hook = ctx.constrain
            args = (p, state, batch)
        b_bytes = sum(_nbytes(mesh.local_part(v, (hook.batch,) + (None,) * (
            v.dim() - 1))) for v in batch.values())
        local = _distinct_bytes(_flat(args[:-1])) + b_bytes
        return Cell(fn, args, mesh, local, mb)

    # serving cells, as the engine serves a mesh: packed parameters whole
    # on every rank, the rank's rows of the batch and of a cache whole in
    # its sequence, no collective
    packed = transformer.pack_params(cfg, params)
    rows = -(-gb // shd.axis_size(mesh, shd.batch_axes(mesh)))
    cache = transformer.init_cache(cfg, rows, seq, torch.bfloat16,
                                   device=device, kv_quant="kv8" in opt)
    ctx = make_ctx(cfg, mesh, gb, mode="packed", opt=opt)
    t = seq if shape.kind == "prefill" else 1
    if cfg.frontend == "token":
        inp = torch.zeros((rows, t), dtype=torch.int32, device=device)
    else:
        inp = torch.zeros((rows, t, cfg.d_model), dtype=torch.bfloat16,
                          device=device)
    if shape.kind == "prefill":
        fn = steps.make_prefill_fn(cfg, ctx)
        args = (packed, inp, cache)
    else:
        fn = steps.make_decode_fn(cfg, ctx)
        clen = torch.full((), seq - 1, dtype=torch.int32, device=device)
        args = (packed, inp, cache, clen)
    return Cell(fn, args, mesh, _distinct_bytes(_flat(args)))


def estimate(cell: Cell) -> dict:
    """Run ``cell``'s step once under ``Census``:
    {"trace_s", "memory", "cost", "collectives"} (the module docstring
    says how each is made)."""
    arg_tensors = _flat(cell.args)
    cell.mesh.reset_collective_bytes()
    t0 = time.time()
    with Census(known=arg_tensors) as census:
        out = cell.fn(*cell.args)
    trace_s = time.time() - t0
    coll = {k: v for k, v in cell.mesh.reset_collective_bytes().items()
            if v}
    coll["total"] = sum(coll.values())
    arg_keys = {_storage(t)._cdata for t in arg_tensors}
    outs = _flat(out)
    out_bytes = _distinct_bytes(outs)
    alias = _distinct_bytes([t for t in outs
                             if _storage(t)._cdata in arg_keys])
    fresh = out_bytes - alias
    args = cell.local_bytes
    return {
        "trace_s": round(trace_s, 2),
        "microbatches": cell.microbatches,
        "memory": {
            "argument_bytes": args,
            "output_bytes": out_bytes,
            "temp_bytes": census.peak - fresh,
            "alias_bytes": alias,
            "peak_bytes_est": args + census.peak,
        },
        "cost": {"flops": float(census.flops),
                 "bytes_accessed": float(census.accessed)},
        "collectives": coll,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = "experiments/dryrun_torch", opt=()) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}_{shape_name}_{mesh_name}"
    if opt:
        cell_id += "_opt-" + "-".join(sorted(opt))
    os.makedirs(out_dir, exist_ok=True)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind, "opt": sorted(opt)}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        result["skipped"] = reason
        _save(out_dir, cell_id, result)
        return result
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        result.update(ok=True, **estimate(build_cell(arch, shape_name, mesh,
                                                     opt=opt)))
    except Exception as e:  # a failing cell is a bug; record it loudly
        result.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
    _save(out_dir, cell_id, result)
    return result


def _save(out_dir, cell_id, result):
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(result, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="one arch id (default: all, incl. the paper's)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--opt", default="",
                    help="comma list: kv8,dp,dpzero1,compress,rematdots,"
                         "int8fwd")
    args = ap.parse_args(argv)
    opt = tuple(o for o in args.opt.split(",") if o)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(arch, shape, mp, args.out, opt=opt)
                tag = ("SKIP" if "skipped" in r
                       else "OK" if r.get("ok") else "FAIL")
                n_ok += tag == "OK"
                n_skip += tag == "SKIP"
                n_fail += tag == "FAIL"
                extra = ""
                if tag == "OK":
                    gb = r["memory"]["peak_bytes_est"] / 2**30
                    extra = (f" mem/dev={gb:.2f}GiB "
                             f"gflops={r['cost']['flops'] / 1e9:.1f} "
                             f"coll={r['collectives']['total'] / 2**20:.0f}"
                             "MiB "
                             f"trace={r['trace_s']:.0f}s")
                elif tag == "FAIL":
                    extra = " " + r["error"][:160]
                print(f"[{tag}] {arch} {shape} "
                      f"{'2x16x16' if mp else '16x16'}{extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
