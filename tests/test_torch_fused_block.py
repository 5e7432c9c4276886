"""The port's RMS-MAX (``rmsnorm_quant``), SwiGLU requant (``swiglu_quant``)
and the fused FFN built on them (``core/fused_block.py``) against the JAX
package on the same inputs; the JAX kernels run in interpret mode, as its
own tests run them.

Tolerances are the JAX kernel tests' own: scales within rtol 1e-6 and int8
codes at most one apart (a sum of squares or an ``exp`` taken in another
order can move a value across a rounding boundary).  The fused FFN is held
to JAX's fused FFN within 1e-5 (f32 outputs of order 0.1-1: its integer
stages agree, its scales by ULPs) and to the port's unfused packed path
with the tolerance of ``tests/test_fused_block.py``, which covers the one
extra int8 requant of the SwiGLU output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import fused_block as j_fb
from repro.kernels.rmsnorm_quant import ops as j_rq
from repro.kernels.swiglu_quant import ops as j_sq
from repro.models import layers as j_layers

from repro_torch.convert import packed_from_jax
from repro_torch.core import fused_block
from repro_torch.kernels.rmsnorm_quant import ops as rq_ops
from repro_torch.kernels.rmsnorm_quant import ref as rq_ref
from repro_torch.kernels.swiglu_quant import ops as sq_ops
from repro_torch.kernels.swiglu_quant import ref as sq_ref
from repro_torch.kernels.tlmm import ops as tlmm_ops

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _assert_quant_close(got, want):
    """(int8, scale) pairs: scales within rtol 1e-6, codes at most one
    apart."""
    (q, s), (q_want, s_want) = got, want
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), rtol=1e-6)
    assert q.dtype == torch.int8 and q.shape == tuple(q_want.shape)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(q_want, np.int32))
    assert diff.max() <= 1


@pytest.mark.parametrize("m,d", [(8, 128), (5, 96), (16, 1024), (1, 64)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_quant_matches_jax(m, d, dtype):
    """The inputs of the JAX kernel test (``tests/test_kernels.py``)."""
    x = (jax.random.normal(jax.random.PRNGKey(m * d), (m, d)) * 3
         ).astype(dtype)
    w = jax.random.normal(jax.random.PRNGKey(1), (d,)).astype(dtype)
    want = j_rq.rmsnorm_quant(x, w, interpret=True)
    xt, wt = (_to_torch(a, TORCH_DTYPE[dtype]) for a in (x, w))
    got = rq_ops.rmsnorm_quant(xt, wt)
    assert got[1].dtype == torch.float32 and got[1].shape == (m, 1)
    _assert_quant_close(got, want)
    _assert_quant_close(rq_ref.rmsnorm_quant_ref(xt, wt), want)


def test_rmsnorm_quant_3d_input():
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 7, 64))
    w = jnp.ones((64,))
    want = j_rq.rmsnorm_quant(x, w, interpret=True)
    got = rq_ops.rmsnorm_quant(_to_torch(x), _to_torch(w))
    assert got[0].shape == (2, 7, 64) and got[1].shape == (2, 7, 1)
    _assert_quant_close(got, want)


@pytest.mark.parametrize("m,f", [(8, 256), (3, 128), (16, 512)])
def test_swiglu_quant_matches_jax(m, f):
    """The inputs of the JAX kernel test (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(m + f)
    gate = rng.integers(-2000, 2000, size=(m, f)).astype(np.int32)
    up = rng.integers(-2000, 2000, size=(m, f)).astype(np.int32)
    gs = rng.uniform(1e-4, 1e-2, size=(m, 1)).astype(np.float32)
    us = rng.uniform(1e-4, 1e-2, size=(m, 1)).astype(np.float32)
    want = j_sq.swiglu_quant(*map(jnp.asarray, (gate, up, gs, us)),
                             interpret=True)
    args = tuple(map(torch.from_numpy, (gate, up, gs, us)))
    _assert_quant_close(sq_ops.swiglu_quant(*args), want)
    _assert_quant_close(sq_ref.swiglu_quant_ref(*args), want)
    # a leading batch shape passes through
    q, s = sq_ops.swiglu_quant(*(a.reshape((1,) + a.shape) for a in args))
    assert q.shape == (1, m, f) and s.shape == (1, m, 1)


def _mlp(m, d, ff, dtype=jnp.float32):
    """JAX-packed MLP (g = 5), norm weight and input, the fused-block test's
    construction, with the port's copy of the same packed linears."""
    packed = j_layers.mlp_pack(
        j_layers.mlp_init(jax.random.PRNGKey(d + ff), d, ff), 5)
    norm_w = jnp.ones((d,)) + 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                                      (d,))
    x = jax.random.normal(jax.random.PRNGKey(2), (m, d)).astype(dtype)
    ours = nn.ModuleDict({
        name: packed_from_jax(jax.tree_util.tree_map(np.array, p), 5, "cpu")
        for name, p in packed.items()})
    return packed, norm_w, x, ours


@pytest.mark.parametrize("m,d,ff", [(8, 64, 128), (4, 128, 256), (1, 64, 96)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_ffn_matches_jax_and_unfused(m, d, ff, dtype):
    packed, norm_w, x, ours = _mlp(m, d, ff, dtype)
    xt, wt = _to_torch(x, TORCH_DTYPE[dtype]), _to_torch(norm_w)
    got = fused_block.fused_ffn_packed(ours, wt, xt)
    assert got.dtype == xt.dtype and got.shape == (m, d)
    want = j_fb.fused_ffn_packed(packed, norm_w, x, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5, rtol=1e-5)
    ref = fused_block.unfused_reference(ours, wt, xt).float().numpy()
    j_ref = np.asarray(j_fb.unfused_reference(packed, norm_w, x), np.float32)
    np.testing.assert_allclose(ref, j_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=0.05 * float(np.std(ref)) + 1e-3,
                               rtol=0.1)


def test_fused_ffn_integer_dataflow(monkeypatch):
    """No float activation between the norm and the down projection: the
    kernels exchange int8/int32 tensors, and the only float tensors made
    between them are (m, 1) row scales.  Each kernel wrapper is opaque here
    (on the card its float work stays in registers); a dispatch mode records
    every other op's outputs in order."""
    _, norm_w, x, ours = _mlp(4, 64, 128)
    events = []
    depth = [0]

    def opaque(name, fn):
        def wrapped(*a, **k):
            depth[0] += 1
            try:
                out = fn(*a, **k)
            finally:
                depth[0] -= 1
            events.append(("kernel", name, list(out)
                           if isinstance(out, tuple) else [out]))
            return out
        return wrapped

    for mod, name in ((rq_ops, "rmsnorm_quant"), (sq_ops, "swiglu_quant"),
                      (tlmm_ops, "tlmm")):
        monkeypatch.setattr(mod, name, opaque(name, getattr(mod, name)))

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if depth[0] == 0:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                events.append(("op", str(func), [
                    t for t in outs if isinstance(t, torch.Tensor)]))
            return out

    with Record():
        fused_block.fused_ffn_packed(ours, _to_torch(norm_w), _to_torch(x))
    kernels = [(name, [t.dtype for t in ts]) for kind, name, ts in events
               if kind == "kernel"]
    assert kernels == [
        ("rmsnorm_quant", [torch.int8, torch.float32]),
        ("tlmm", [torch.int32]), ("tlmm", [torch.int32]),
        ("swiglu_quant", [torch.int8, torch.float32]),
        ("tlmm", [torch.int32])]
    first = next(i for i, e in enumerate(events) if e[0] == "kernel")
    last = max(i for i, e in enumerate(events) if e[0] == "kernel")
    between = [(name, t) for kind, name, ts in events[first:last]
               if kind == "op" for t in ts]
    assert between, "no glue op recorded: the dispatch mode saw nothing"
    for name, t in between:
        assert not t.is_floating_point() or t.shape[-1] == 1, (name, t.shape)


def test_fused_ffn_refuses_bias():
    _, norm_w, x, ours = _mlp(2, 64, 128)
    ours["up"].b = torch.zeros(128)
    with pytest.raises(ValueError, match="without bias"):
        fused_block.fused_ffn_packed(ours, _to_torch(norm_w), _to_torch(x))
