"""Attention kernels, contiguous and paged: the port's plain versions
against the JAX Pallas kernels (interpret mode) on the same inputs, and the
paged plain versions against the contiguous ones on the same rows (equal
bits).  The CUDA kernels are held against these plain versions in
``test_torch_gpu.py``.

Float tolerance: 2e-5 absolute and relative in f32, the JAX kernel tests'
own tolerance against their oracles; the two sides sum in different orders
(dense softmax vs tiled online softmax), which moves results by a few ULPs
of values of order one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.decode_attention import ops as j_da
from repro.kernels.flash_prefill import ops as j_fp
from repro.models import attention as j_attn

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_prefill import ops as fp_ops

TOL = dict(atol=2e-5, rtol=2e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,h,kv_h,s,d,window", [
    (1, 4, 4, 32, 32, None),     # MHA
    (2, 4, 2, 37, 16, None),     # GQA 2:1, s not a block multiple
    (1, 8, 2, 24, 32, None),     # GQA 4:1
    (1, 2, 2, 40, 16, 8),        # sliding window
])
def test_plain_flash_prefill_matches_jax(b, h, kv_h, s, d, window):
    rng = np.random.default_rng(s + d)
    q, k, v = (_normal(rng, b, hh, s, d) for hh in (h, kv_h, kv_h))
    want = np.asarray(j_fp.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        bq=16, bkv=16, interpret=True))
    got = fp_ops.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        np.asarray(j_attn.attention_xla_skip(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), window=window)),
        got.numpy(), **TOL)


@pytest.mark.parametrize("b,h,kv_h,t,S,d,offsets,window,cache_dtype", [
    (3, 4, 2, 12, 40, 16, [0, 5, 28], None, torch.float32),  # ragged, GQA
    (1, 4, 4, 16, 64, 32, [48], None, torch.bfloat16),  # ends at the row end
    (2, 2, 1, 8, 48, 16, [0, 20], 6, torch.float32),    # sliding window
    (2, 4, 2, 8, 24, 16, [3, 16], None, torch.bfloat16),  # bf16, ragged
])
def test_plain_chunk_prefill_matches_jax(b, h, kv_h, t, S, d, offsets,
                                         window, cache_dtype):
    """The port's chunk attention reads the cache in its dtype plus the
    chunk's fresh f32 K/V; JAX's chunk kernel gets what the JAX model feeds
    it, the cache cast to f32 with the chunk's span overlaid.  (A span
    clamped back to S - t only occurs for masked rows, whose outputs are
    don't-care; ``test_torch_gpu.py`` holds the kernel to the plain version
    there.)"""
    rng = np.random.default_rng(t + S)
    q = _normal(rng, b, h, t, d)
    k, v = (torch.from_numpy(_normal(rng, b, kv_h, S, d)).to(cache_dtype)
            for _ in range(2))
    k_new, v_new = _normal(rng, b, kv_h, t, d), _normal(rng, b, kv_h, t, d)
    off = np.asarray(offsets, np.int32)
    kj, vj = k.float().numpy().copy(), v.float().numpy().copy()
    for i, o in enumerate(off):
        kj[i, :, o:o + t] = k_new[i]
        vj[i, :, o:o + t] = v_new[i]
    want = np.asarray(j_fp.flash_chunk_prefill(
        jnp.asarray(q), jnp.asarray(kj), jnp.asarray(vj), jnp.asarray(off),
        window=window, bq=8, bkv=16, interpret=True))
    got = fp_ops.flash_chunk_prefill(
        torch.from_numpy(q), k, v, torch.from_numpy(k_new),
        torch.from_numpy(v_new), torch.from_numpy(off), window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b,h,kv_h,S,d,lens", [
    (3, 4, 2, 48, 32, [1, 17, 48]),   # GQA, ragged lengths, one full row
    (2, 4, 4, 40, 16, [40, 9]),       # S not a multiple of the JAX block
])
def test_plain_decode_attention_matches_jax(b, h, kv_h, S, d, lens):
    """The cache is bf16, as on the serving path; both sides read the same
    rounded values."""
    rng = np.random.default_rng(S + d)
    q = _normal(rng, b, h, 1, d)
    k, v = _normal(rng, b, kv_h, S, d), _normal(rng, b, kv_h, S, d)
    cl = np.asarray(lens, np.int32)
    kj, vj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
    want = np.asarray(j_da.decode_attention(jnp.asarray(q), kj, vj,
                                            jnp.asarray(cl), bkv=16,
                                            interpret=True))
    kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    got = da_ops.decode_attention(torch.from_numpy(q), kt, vt,
                                  torch.from_numpy(cl))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_decode_attention_ignores_stale_tail():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, 2, 2, 1, 16))
    k, v = (torch.from_numpy(_normal(rng, 2, 2, 24, 16)) for _ in range(2))
    cl = torch.tensor([5, 11], dtype=torch.int32)
    base = da_ref.decode_attention_ref(q, k, v, cl)
    stale = torch.arange(24)[None, None, :, None] >= cl[:, None, None, None]
    noisy = da_ref.decode_attention_ref(q, torch.where(stale, 100.0, k),
                                        torch.where(stale, -100.0, v), cl)
    torch.testing.assert_close(noisy, base)


# ---------------------------------------------------------------------------
# Paged kernels: the page pool holds each slot's rows in shuffled pages, with
# garbage in every page and row no slot owns (as tests/test_paged.py does)
# ---------------------------------------------------------------------------

def _scatter_pages(rng, rows, ps, fill):
    """rows (b, S, ...) -> pool (1 + b * n, ps, ...) filled by ``fill`` and
    holding row i's positions in pages bt[i] (shuffled), and bt (b, n)."""
    b, S = rows.shape[:2]
    n = -(-S // ps)
    bt = (rng.permutation(b * n) + 1).reshape(b, n).astype(np.int32)
    pool = fill((1 + b * n, ps) + rows.shape[2:])
    for i in range(b):
        for j in range(n):
            span = rows[i, j * ps:(j + 1) * ps]
            pool[bt[i, j], :len(span)] = span
    return pool, bt


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_plain_paged_decode_matches_jax(page_size):
    b, h, kv_h, d, lens = 3, 4, 2, 8, [7, 16, 2]
    S = 16
    rng = np.random.default_rng(page_size)
    q = _normal(rng, b, h, 1, d)
    k, v = _normal(rng, b, S, kv_h, d), _normal(rng, b, S, kv_h, d)

    def garbage(shape):
        return _normal(rng, *shape) * 100

    (kp, bt), (vp, _) = (_scatter_pages(np.random.default_rng(0), x,
                                        page_size, garbage) for x in (k, v))
    cl = np.asarray(lens, np.int32)
    want = np.asarray(j_da.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), interpret=True))
    t = torch.from_numpy
    got = da_ops.decode_attention_paged(t(q), t(kp), t(vp), t(bt), t(cl))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the plain paged version gives the contiguous one's bits
    assert torch.equal(got, da_ops.decode_attention(
        t(q), t(k).transpose(1, 2), t(v).transpose(1, 2), t(cl)))


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_plain_windowed_decode_matches_jax(page_size):
    """Sliding-window decode, which the JAX package runs in XLA only: the
    contiguous version against it, and the paged versions (f32 and int8)
    against the contiguous one on the same rows, bit for bit."""
    b, h, kv_h, d, lens, window = 3, 4, 2, 8, [7, 16, 2], 5
    S = 16
    rng = np.random.default_rng(23 + page_size)
    q = _normal(rng, b, h, 1, d)
    k, v = _normal(rng, b, S, kv_h, d), _normal(rng, b, S, kv_h, d)
    cl = np.asarray(lens, np.int32)
    t = torch.from_numpy
    kc, vc = t(k).transpose(1, 2), t(v).transpose(1, 2)
    got = da_ops.decode_attention(t(q), kc, vc, t(cl), window=window)
    want = np.asarray(j_attn.decode_attention_xla(
        jnp.asarray(q), jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()),
        jnp.asarray(cl), window=window))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    def garbage(shape):
        return _normal(rng, *shape) * 100

    (kp, bt), (vp, _) = (_scatter_pages(np.random.default_rng(0), x,
                                        page_size, garbage) for x in (k, v))
    assert torch.equal(got, da_ops.decode_attention_paged(
        t(q), t(kp), t(vp), t(bt), t(cl), window=window))

    ki, vi = (rng.integers(-127, 128, (b, S, kv_h, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((b, S, kv_h)) * 0.05).astype(np.float32)
              for _ in range(2))
    kip, bt = _scatter_pages(np.random.default_rng(0), ki, page_size,
                             lambda s: np.zeros(s, np.int8))
    vip, _ = _scatter_pages(np.random.default_rng(0), vi, page_size,
                            lambda s: np.zeros(s, np.int8))
    ksp, _ = _scatter_pages(np.random.default_rng(0), ks, page_size, np.zeros)
    vsp, _ = _scatter_pages(np.random.default_rng(0), vs, page_size, np.zeros)
    got = da_ops.decode_attention_paged_quant(
        *(t(x) for x in (q, kip, vip, ksp.astype(np.float32),
                         vsp.astype(np.float32), bt, cl)), window=window)
    kd, vd = (da_ref.dequant_bf16(t(x), t(s)) for x, s in ((ki, ks), (vi, vs)))
    assert torch.equal(got, da_ops.decode_attention(
        t(q), kd.transpose(1, 2), vd.transpose(1, 2), t(cl), window=window))


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_plain_paged_int8_decode_matches_jax(page_size):
    """Zero scales on the null page, garbage int8 values everywhere; 1e-5,
    the JAX test's own tolerance for this kernel."""
    b, h, kv_h, d, lens = 3, 4, 2, 8, [7, 16, 2]
    S = 16
    rng = np.random.default_rng(11 + page_size)
    q = _normal(rng, b, h, 1, d)

    def ints(shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    def scales(shape):
        return (rng.random(shape) * 0.05).astype(np.float32)

    k, v = ints((b, S, kv_h, d)), ints((b, S, kv_h, d))
    ks, vs = scales((b, S, kv_h)), scales((b, S, kv_h))
    kp, bt = _scatter_pages(np.random.default_rng(0), k, page_size, ints)
    vp, _ = _scatter_pages(np.random.default_rng(0), v, page_size, ints)
    ksp, _ = _scatter_pages(np.random.default_rng(0), ks, page_size, scales)
    vsp, _ = _scatter_pages(np.random.default_rng(0), vs, page_size, scales)
    ksp[0], vsp[0] = 0.0, 0.0
    cl = np.asarray(lens, np.int32)
    want = np.asarray(j_da.decode_attention_paged_quant(
        *(jnp.asarray(x) for x in (q, kp, vp, ksp, vsp, bt, cl)),
        interpret=True))
    t = torch.from_numpy
    got = da_ops.decode_attention_paged_quant(
        *(t(x) for x in (q, kp, vp, ksp, vsp, bt, cl)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    kd, vd = da_ref.dequant_bf16(t(k), t(ks)), da_ref.dequant_bf16(t(v), t(vs))
    assert torch.equal(got, da_ops.decode_attention(
        t(q), kd.transpose(1, 2), vd.transpose(1, 2), t(cl)))


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_plain_paged_chunk_prefill_matches_jax(page_size):
    """Ragged offsets that start and end inside pages; the JAX kernel
    streams the [0, offset) prefix from the pool and the chunk from its
    fresh operand."""
    b, h, kv_h, t_, d, S = 3, 4, 2, 6, 8, 20
    offsets = [0, 5, 11]
    rng = np.random.default_rng(20 + page_size)
    q = _normal(rng, b, h, t_, d)
    k, v = _normal(rng, b, S, kv_h, d), _normal(rng, b, S, kv_h, d)
    k_new, v_new = _normal(rng, b, kv_h, t_, d), _normal(rng, b, kv_h, t_, d)

    def garbage(shape):
        return np.full(shape, 99.0, np.float32)

    (kp, bt), (vp, _) = (_scatter_pages(np.random.default_rng(1), x,
                                        page_size, garbage) for x in (k, v))
    off = np.asarray(offsets, np.int32)
    want = np.asarray(j_fp.flash_chunk_prefill_paged(
        *(jnp.asarray(x) for x in (q, kp, vp, bt, off, k_new, v_new)),
        bq=8, interpret=True))
    t = torch.from_numpy
    got = fp_ops.flash_chunk_prefill_paged(
        *(t(x) for x in (q, kp, vp, bt, off, k_new, v_new)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, fp_ops.flash_chunk_prefill(
        t(q), t(k).transpose(1, 2), t(v).transpose(1, 2), t(k_new),
        t(v_new), t(off)))
