"""The dry run (``repro_torch.launch.dryrun``) and what only it calls,
against the JAX package on the CPU.

* ``sharding.cache_sharding`` and ``data.pipeline.make_batch_specs``
  equal JAX's specs and shapes (JAX's through an ``AbstractMesh`` of the
  production shapes, nothing compiled);
* a reduced cell's estimated FLOPs (its step on ``meta`` tensors) equal
  ``FlopCounterMode`` on the same step run on the CPU, for every cell
  kind and layout;
* ``DryMesh``'s bytes by collective kind equal what a real ``TrainMesh``
  of two gloo ranks counts on rank 0 for the same reduced training cells;
* ``argument_bytes`` of bitnet-0.73b ``train_4k`` and xlstm-350m
  ``decode_32k`` on 16 x 16 equal the sum of JAX's
  ``NamedSharding.shard_shape`` bytes over the same arguments (the
  serving cell's packed weights replicated: the engine's layout);
* those two cells and mixtral-8x22b ``prefill_32k`` on 2 x 16 x 16 come
  back ``ok`` with JAX's keys, at full width, depth cut to 2 layers (the
  full-depth cells are the sweep's, ``PERF.md``), and a 500k decode of a
  full-attention arch is skipped with JAX's reason.
"""

import dataclasses
import json
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.data.pipeline import make_batch_specs as j_make_batch_specs
from repro.models import transformer as j_transformer
from repro.optim.adamw import adamw as j_adamw
from repro.runtime import sharding as j_shd

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import dryrun
from repro_torch.models import transformer
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import DryMesh, MeshShape

from torch_mesh_helpers import launch

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DT = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16):
      torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
      jnp.dtype(jnp.uint8): torch.uint8, jnp.dtype(jnp.int8): torch.int8}


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries, one-axis tuples as the name."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,kvq", [("bitnet-0.73b", False),
                                      ("bitnet-0.73b", True),
                                      ("hymba-1.5b", False),
                                      ("xlstm-350m", False)])
@pytest.mark.parametrize("gb,seq", [(128, 32768), (1, 524288)])
def test_cache_sharding_equals_jax(mesh_name, arch, kvq, gb, seq):
    shape, names = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    jcfg = j_get_config(arch)
    jcache = jax.eval_shape(lambda: j_transformer.init_cache(
        jcfg, gb, seq, jnp.bfloat16, kv_quant=kvq))
    jsh = j_shd.cache_sharding(jmesh, jcache, gb)
    cache = transformer.init_cache(get_config(arch), gb, seq, torch.bfloat16,
                                   device="meta", kv_quant=kvq)
    specs = sharding.cache_sharding(MeshShape(shape, names), cache, gb)
    want, got, gspec = _leaves(jcache), _leaves(cache), _leaves(specs)
    jspec = _leaves(jsh)
    assert sorted(want) == sorted(got)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert got[path].dtype == DT[jnp.dtype(leaf.dtype)], path
        assert _norm(gspec[path], leaf.ndim) == _norm(
            jspec[path].spec, leaf.ndim), path


@pytest.mark.parametrize("arch", ["bitnet-0.73b", "musicgen-medium"])
def test_make_batch_specs_equals_jax(arch):
    want = j_make_batch_specs(j_get_config(arch), 256, 4096)
    got = make_batch_specs(get_config(arch), 256, 4096)
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        assert got[k].is_meta and tuple(got[k].shape) == v.shape
        assert got[k].dtype == DT[jnp.dtype(v.dtype)]


REDUCED = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=128)
# (name, arch, kind, mesh, opt): reduced cells, batch 8 x 32
CELLS = [
    ("bitnet train 2d", "bitnet-0.73b", "train", (2, 2), ()),
    ("bitnet train dpzero1", "bitnet-0.73b", "train", (2, 2), ("dpzero1",)),
    ("bitnet train dp compress", "bitnet-0.73b", "train", (2, 2),
     ("dp", "compress")),
    ("bitnet train rematdots int8fwd", "bitnet-0.73b", "train", (1, 2),
     ("rematdots", "int8fwd")),
    ("bitnet prefill", "bitnet-0.73b", "prefill", (2, 2), ()),
    ("bitnet decode kv8", "bitnet-0.73b", "decode", (2, 2), ("kv8",)),
    ("hymba train 2d 3 heads", "hymba-1.5b", "train", (1, 2), ()),
    ("xlstm long_decode", "xlstm-350m", "long_decode", (2, 2), ()),
    ("mixtral prefill", "mixtral-8x22b", "prefill", (1, 2), ()),
    ("musicgen prefill", "musicgen-medium", "prefill", (2, 2), ()),
]


def _cfg(arch, name):
    kw = dict(REDUCED, **(dict(n_heads=3, d_model=96) if "3 heads" in name
                         else {}))
    return get_config(arch).reduced(**kw)


@pytest.mark.parametrize("name,arch,kind,mesh,opt", CELLS,
                         ids=[c[0] for c in CELLS])
def test_meta_flops_equal_flop_counter_on_the_cpu(name, arch, kind, mesh,
                                                  opt):
    cfg = _cfg(arch, name)
    shape = ShapeConfig("t", 32, 8, kind)
    est = dryrun.estimate(dryrun.build_cell(arch, shape, DryMesh(mesh), opt,
                                            cfg=cfg))
    cell = dryrun.build_cell(arch, shape, DryMesh(mesh), opt, cfg=cfg,
                             device="cpu")
    with FlopCounterMode(display=False) as fc:
        cell.fn(*cell.args)
    assert est["cost"]["flops"] == fc.get_total_flops() > 0
    mem = est["memory"]
    assert mem["argument_bytes"] == cell.local_bytes > 0
    assert mem["peak_bytes_est"] == (mem["argument_bytes"]
                                     + mem["output_bytes"]
                                     + mem["temp_bytes"]
                                     - mem["alias_bytes"])
    assert est["cost"]["bytes_accessed"] > 0


# the 2-rank training cells (a serving cell moves nothing: the engine's
# layout) and the batch-split layouts on (2, 1)
COUNT_CELLS = [c for c in CELLS
               if math.prod(c[3]) == 2 and c[2] == "train"] + [
    ("bitnet train dpzero1 (2, 1)", "bitnet-0.73b", "train", (2, 1),
     ("dpzero1",)),
    ("bitnet train dp compress (2, 1)", "bitnet-0.73b", "train", (2, 1),
     ("dp", "compress")),
]

COUNT_BODY = '''
import json
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.runtime.collectives import TrainMesh

out = {}
for name, arch, kind, mesh, opt in json.loads(%(cells)r):
    kw = dict(%(reduced)r)
    if "3 heads" in name:
        kw.update(n_heads=3, d_model=96)
    cfg = get_config(arch).reduced(**kw)
    m = TrainMesh(tuple(mesh))
    cell = dryrun.build_cell(arch, ShapeConfig("t", 32, 8, kind), m,
                             tuple(opt), cfg=cfg, device="cpu")
    m.reset_collective_bytes()
    cell.fn(*cell.args)
    out[name] = m.reset_collective_bytes()
if RANK == 0:
    print("COUNTS " + json.dumps(out), flush=True)
finish("COUNT_OK")
'''


@pytest.fixture(scope="module", autouse=True)
def counted(tmp_path_factory):
    """The two gloo ranks of COUNT_BODY, started with the module's first
    test: they run beside the tests before the one that reads them."""
    body = COUNT_BODY % dict(cells=json.dumps(COUNT_CELLS), reduced=REDUCED)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch, tmp_path_factory.mktemp("counts"), body, 2,
                          "COUNT_OK", 240)


def test_dry_mesh_counts_what_two_gloo_ranks_move(counted):
    out = counted.result()
    real = json.loads(next(x for x in out.splitlines()
                           if x.startswith("COUNTS "))[len("COUNTS "):])
    for name, arch, kind, mesh, opt in COUNT_CELLS:
        est = dryrun.estimate(dryrun.build_cell(
            arch, ShapeConfig("t", 32, 8, kind), DryMesh(mesh), opt,
            cfg=_cfg(arch, name)))
        want = {k: v for k, v in real[name].items() if v}
        got = {k: v for k, v in est["collectives"].items() if k != "total"}
        assert got == want and sum(want.values()) > 0, (name, got, want)
        assert est["collectives"]["total"] == sum(want.values())


def _shard_bytes(tree, shardings) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x, sh in zip(leaves, shs))


def test_argument_bytes_equal_jax_shard_shapes():
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    # bitnet-0.73b train_4k, "2d": parameters, AdamW state, batch
    cfg = j_get_config("bitnet-0.73b")
    shape = J_SHAPES["train_4k"]
    params = jax.eval_shape(lambda: j_transformer.init_params(
        cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    opt = jax.eval_shape(j_adamw().init, params)
    batch = j_make_batch_specs(cfg, shape.global_batch, shape.seq_len)
    p_sh = j_shd.shard_params(jmesh, params, fsdp=False)
    b_sh = jax.tree_util.tree_map(
        lambda s: j_shd.ns(jmesh, *j_shd.batch_spec(
            jmesh, shape.global_batch, s.ndim - 1)), batch)
    want = (_shard_bytes(params, p_sh) + _shard_bytes(opt.m, p_sh)
            + _shard_bytes(opt.v, p_sh) + 4 + _shard_bytes(batch, b_sh))
    got = dryrun.build_cell("bitnet-0.73b", "train_4k", DryMesh((16, 16)))
    assert got.local_bytes == want
    # xlstm-350m decode_32k: packed parameters, one token, cache, length
    cfg = j_get_config("xlstm-350m")
    shape = J_SHAPES["decode_32k"]
    gb = shape.global_batch
    params = jax.eval_shape(lambda: j_transformer.init_params(
        cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    packed = jax.eval_shape(lambda p: j_transformer.pack_params(cfg, p),
                            params)
    cache = jax.eval_shape(lambda: j_transformer.init_cache(
        cfg, gb, shape.seq_len, jnp.bfloat16))
    inp = jax.ShapeDtypeStruct((gb, 1), jnp.int32)
    # the engine's layout: packed weights whole on every rank; xLSTM's
    # states split on the batch alone, as JAX's cache spec splits them
    want = (_shard_bytes(packed, jax.tree_util.tree_map(
        lambda _: j_shd.ns(jmesh), packed))
            + _shard_bytes(cache, j_shd.cache_sharding(jmesh, cache, gb))
            + _shard_bytes(inp, j_shd.ns(jmesh, *j_shd.batch_spec(
                jmesh, gb, 1))) + 4)
    got = dryrun.build_cell("xlstm-350m", "decode_32k", DryMesh((16, 16)))
    assert got.local_bytes == want


def test_production_cells_come_back_ok(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), n_layers=2))
    keys = {"memory": {"argument_bytes", "output_bytes", "temp_bytes",
                       "alias_bytes", "peak_bytes_est"},
            "cost": {"flops", "bytes_accessed"}}
    for arch, shape, multi_pod in (("bitnet-0.73b", "train_4k", False),
                                   ("xlstm-350m", "decode_32k", False),
                                   ("mixtral-8x22b", "prefill_32k", True)):
        r = dryrun.run_cell(arch, shape, multi_pod, str(tmp_path))
        assert r.get("ok"), r.get("traceback", r)
        for k, want in keys.items():
            assert set(r[k]) == want and all(
                np.isfinite(v) and v >= 0 for v in r[k].values()), (k, r)
        assert r["cost"]["flops"] > 0
        # a training cell communicates; a serving cell, as the engine
        # serves a mesh, does not
        assert (r["collectives"]["total"] > 0) == (shape == "train_4k"), r
        mesh = "2x16x16" if multi_pod else "16x16"
        saved = json.load(open(tmp_path / f"{arch}_{shape}_{mesh}.json"))
        assert saved["ok"] and saved["memory"] == r["memory"]
    r = dryrun.run_cell("bitnet-0.73b", "long_500k", False, str(tmp_path))
    from repro.configs import shape_applicable as j_applicable
    assert r["skipped"] == j_applicable(j_get_config("bitnet-0.73b"),
                                        J_SHAPES["long_500k"])[1]
