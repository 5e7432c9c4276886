"""The training half of ``repro_torch.runtime.sharding`` against the JAX
package's ``repro.runtime.sharding``, pure Python: for every trainable leaf
of all 11 configs at full width (JAX's shapes from ``jax.eval_shape`` of
its ``init_params``, JAX's specs on a ``jax.sharding.AbstractMesh``), the
port's ``leaf_spec`` and the blocks ``shard_params`` cuts (on meta
tensors, every rank of the mesh); ``batch_spec`` and
``shard_opt_state_zero1`` on the same shapes.  Meshes (data, model):
(1, 2), (2, 1), (2, 2), (2, 4), (1, 16), (16, 16); FSDP on and off;
layouts ``2d`` and ``dp``.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import transformer as j_transformer
from repro.runtime import sharding as j_sharding

from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import MeshShape

# the JAX package's ARCHS and the paper's model
ALL_ARCHS = sorted(set(J_ARCHS) | {"bitnet-0.73b"})
MESHES = [(1, 2), (2, 1), (2, 2), (2, 4), (1, 16), (16, 16)]
NAMES = ("data", "model")


def _spec(p) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its axis (jax 0.9's
    ``PartitionSpec`` writes ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in p)


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch: str) -> dict:
    """{JAX '/'-path: JAX shape} of the arch's float master leaves."""
    cfg = j_get_config(arch)
    tree = jax.eval_shape(lambda k: j_transformer.init_params(cfg, k),
                          jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(leaf.shape)
    return out


class _Shape:
    """A stand-in leaf: its shape, and ``[i]`` dropping the first axis."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __getitem__(self, i):
        return _Shape(self.shape[1:])


def _nest(flat: dict) -> dict:
    tree = {}
    for path, shape in flat.items():
        d = tree
        *parents, leaf = path.split("/")
        for k in parents:
            d = d.setdefault(k, {})
        d[leaf] = _Shape(shape)
    return tree


@functools.lru_cache(maxsize=None)
def _meta_params(arch: str):
    """The port's whole parameter tree at full width on the meta device,
    built by ``convert.from_jax_params`` from JAX's shapes."""
    cfg = get_config(arch)
    orig = convert._tensor
    convert._tensor = lambda a, device: torch.empty(a.shape, device="meta")
    try:
        return convert.from_jax_params(cfg, _nest(_jax_shapes(arch)),
                                       device="meta")
    finally:
        convert._tensor = orig


def test_every_arch_is_covered():
    assert sorted(ARCHS) == ALL_ARCHS and len(ALL_ARCHS) == 11
    for arch in ALL_ARCHS:
        assert get_config(arch).name == j_get_config(arch).name == arch


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_and_shards_match_jax(arch, mesh_shape, fsdp):
    j_mesh = AbstractMesh(mesh_shape, NAMES)
    mesh0 = MeshShape(mesh_shape, NAMES)
    shapes = _jax_shapes(arch)
    params = _meta_params(arch)
    port = dict(params.named_buffers())
    # the port's names are JAX's paths, the layers unstacked
    assert {sharding.jax_path(n) for n in port} == set(shapes)
    for layout in ("2d", "dp"):
        want_all = {}
        for name, t in port.items():
            path = sharding.jax_path(name)
            jshape = shapes[path]
            if layout == "dp":
                want = (None,) * len(jshape)
            else:
                want = _spec(j_sharding.param_spec(j_mesh, path, jshape,
                                                   fsdp=fsdp))
            assert sharding.param_spec(mesh0, path, jshape, fsdp=fsdp) == (
                _spec(j_sharding.param_spec(j_mesh, path, jshape,
                                            fsdp=fsdp)))
            if path.startswith("layers/"):
                assert want[0] is None
                want = want[1:]
            got = sharding.leaf_spec(MeshShape(mesh_shape), name,
                                     tuple(t.shape), fsdp=fsdp,
                                     layout=layout)
            assert got == want, (layout, name, got, want)
            want_all[name] = want
        ranks = sorted({0, mesh_shape[1] - 1, int(np.prod(mesh_shape)) - 1})
        for rank in ranks:
            mesh = MeshShape(mesh_shape, NAMES, rank)
            local = sharding.shard_params(mesh, params, fsdp=fsdp,
                                          layout=layout)
            assert sharding.tree_specs(local) == want_all
            for name, t in local.named_buffers():
                whole = port[name].shape
                spec = want_all[name]
                exp = tuple(n // sharding.axis_size(mesh, ax)
                            for n, ax in zip(whole, spec))
                assert tuple(t.shape) == exp, (name, t.shape, exp)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_batch_spec_matches_jax(mesh_shape):
    j_mesh = AbstractMesh(mesh_shape, NAMES)
    mesh = MeshShape(mesh_shape, NAMES)
    for global_batch in (1, 2, 3, 4, 8, 16, 24, 256):
        for extra in (0, 1, 2):
            assert _spec(sharding.batch_spec(mesh, global_batch, extra)) == (
                _spec(j_sharding.batch_spec(j_mesh, global_batch, extra)))
    assert sharding.batch_axes(mesh) == j_sharding.batch_axes(j_mesh)
    assert sharding.all_axes(mesh) == j_sharding.all_axes(j_mesh)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_zero1_specs_match_jax(arch, mesh_shape):
    """On the same shapes (JAX's stacked ones and the port's per-layer
    ones), the port's ZeRO-1 rule gives JAX's spec for every leaf."""
    j_mesh = AbstractMesh(mesh_shape, NAMES)
    shapes = dict(_jax_shapes(arch))
    shapes.update({n: tuple(t.shape)
                   for n, t in _meta_params(arch).named_buffers()})
    shapes["step"] = ()
    want = j_sharding.shard_opt_state_zero1(
        j_mesh, {n: jax.ShapeDtypeStruct(s, np.float32)
                 for n, s in shapes.items()})
    got = sharding.shard_opt_state_zero1(MeshShape(mesh_shape, NAMES),
                                         shapes)
    def whole_as_empty(spec):   # JAX writes a whole leaf as P()
        return () if all(e is None for e in spec) else spec

    assert {n: whole_as_empty(_spec(g)) for n, g in got.items()} == {
        n: _spec(w.spec) for n, w in want.items()}
