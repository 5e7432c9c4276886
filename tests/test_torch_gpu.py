"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device (``pytest -m gpu tests/test_torch_gpu.py`` on the card; every test
skips without one).  Imports no JAX, so it runs where JAX is not installed.

tlmm, tlmm_lut and the packed linear are compared for equality (int32
sums); swiglu_quant with its plain version for equality (the same
operations on each value, the scale the same product); rmsnorm_quant with
its plain version by scales within rtol 1e-6 and codes at most one apart
(a sum of squares taken in another order), and for equality with the
plain version summing in the kernel's order; the f32 attention kernels
within 2e-5 absolute and relative — they sum in another order than the plain versions, a few ULPs
of values of order one.  The
paged kernels walk keys in the contiguous kernels' order, so against those
on the same rows they are compared with ``torch.equal``.

The serving engine's device-resident decode block runs as a captured CUDA
graph on the card; its tokens are compared with the host-driven engine's
for equality (the same kernels on the same rows, replayed), and under
injected faults (a NaN lane, a dispatch outage that degrades and promotes
the engine, a retry) the surviving and retried requests with the
fault-free tokens.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import bitlinear, fused_block, ternary
from repro_torch.configs import get_config
from repro_torch.kernels import build, launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill import ref as fp_ref
from repro_torch.kernels.rmsnorm_quant import kernel as rq_kernel
from repro_torch.kernels.rmsnorm_quant import ops as rq_ops
from repro_torch.kernels.rmsnorm_quant import plan as rq_plan
from repro_torch.kernels.rmsnorm_quant import ref as rq_ref
from repro_torch.kernels.swiglu_quant import kernel as sq_kernel
from repro_torch.kernels.swiglu_quant import ops as sq_ops
from repro_torch.kernels.swiglu_quant import plan as sq_plan
from repro_torch.kernels.swiglu_quant import ref as sq_ref
from repro_torch.kernels.tlmm import ops as tlmm_ops
from repro_torch.kernels.tlmm import ref as tlmm_ref
from repro_torch.kernels.tlmm_lut import ops as lut_ops
from repro_torch.kernels.tlmm_lut import ref as lut_ref
from repro_torch.models import layers, transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving import (FaultInjector, Request, RequestStatus,
                                 ServingEngine)
from repro_torch.testing import (leaf_grad_errors, pinned_quantizers,
                                 pinned_routing)

TOL = dict(atol=2e-5, rtol=2e-5)
PAGE_SIZES = (4, 5, 16)
WINDOWS = (None, 33)   # 33: the first live key falls inside a 32-key tile


def _assert_contiguous_decode_close(got, q, k, v, cl, window):
    """The contiguous decode read against its plain version: with a window
    on a bf16 cache (the kernel's RP instantiation) the rounded plain read,
    within 1e-3 and 2e-5 on average, the most one probability rounding to
    the other bf16 neighbour moves an output (the kernel's scores differ by
    ULPs); else the plain read within TOL."""
    if window is not None and v.dtype == torch.bfloat16:
        want = da_ref.decode_attention_rounded_ref(q, k, v, cl, window=window)
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
        assert (got - want).abs().mean() < 2e-5
    else:
        torch.testing.assert_close(got, da_ref.decode_attention_ref(
            q, k, v, cl, window=window), **TOL)


def _unrounded(x, window):
    """A contiguous cache the decode read takes without rounding its
    probabilities, as the paged reads take theirs: a windowed bf16 cache
    as f32 (the same values, read in the same order)."""
    return x.float() if window is not None and x.dtype == torch.bfloat16 else x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (m, n, k, g, row_multiple): the regime edge m = 16 / 17, m = 1 at full
# width, k = 130 and 257 (not a multiple of 4 columns), n = 0 (all zeros),
# and a split whose last block ends inside a step (TLMM_PARTIAL_STEP)
TLMM_PARTIAL_STEP = (73, 1536, 1536, 5, 64)
TLMM_SHAPES = [
    (1, 1536, 1536, 5, 64), (70, 165, 130, 5, 1), (5, 96, 64, 3, 8),
    (130, 4096, 200, 5, 64), (3, 64, 48, 4, 1), (16, 1536, 1536, 5, 64),
    (17, 1536, 1536, 5, 64), (1, 1536, 4096, 5, 64), (1, 4096, 1536, 5, 64),
    (4, 1536, 130, 5, 64), (17, 300, 257, 3, 1), (128, 1536, 257, 5, 64),
    (4, 0, 96, 5, 1), (40, 0, 64, 3, 1), TLMM_PARTIAL_STEP]


def _ternary_operands(cuda, m, n, k, g, row_multiple, lead):
    """Codes of a random (n, k) ternary matrix and (m, n) int8 activations;
    lead > 0 takes the activations as a column slice, from column lead, of
    a wider tensor (lda = n + lead + 13, a misaligned start when lead is
    odd)."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + k + g + lead)
    w = torch.randint(-1, 2, (n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    codes = ternary.pack_ternary(w, g, row_multiple)
    wide = torch.randint(-128, 128, (m, n + (lead + 13 if lead else 0)),
                         generator=gen, device=cuda, dtype=torch.int8)
    return codes, wide[:, lead:lead + n]


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [0, 3])
@pytest.mark.parametrize("m,n,k,g,row_multiple", TLMM_SHAPES)
def test_tlmm_kernel_equals_plain(cuda, m, n, k, g, row_multiple, lead):
    codes, a = _ternary_operands(cuda, m, n, k, g, row_multiple, lead)
    before = launch_counts()["tlmm"]
    got = tlmm_ops.tlmm(a, codes, g=g)
    assert launch_counts()["tlmm"] == before + (n > 0)
    torch.testing.assert_close(got, tlmm_ref.tlmm_ref(a, codes, g, n),
                               rtol=0, atol=0)
    assert torch.equal(got, tlmm_ops.tlmm(a, codes, g=g))   # atomics: any order
    if n == 0:
        assert not got.any()


@pytest.mark.gpu
def test_apply_packed_kernel_equals_predecoded(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = bitlinear.pack(bitlinear.init(gen, 1536, 4096, bias=True))
    x = torch.randn(7, 1536, generator=gen, device=cuda)
    got = bitlinear.apply_packed(p, x, out_dtype=torch.float32)
    want = bitlinear.apply_predecoded(bitlinear.predecode(p), x,
                                      out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv_h,s,d", [(1, 24, 24, 128, 64),
                                          (2, 8, 2, 77, 32),
                                          (1, 4, 1, 50, 128)])
def test_flash_kernel_matches_plain(cuda, b, h, kv_h, s, d):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, s, kv_h, d, generator=gen, device=cuda
                        ).transpose(1, 2) for _ in range(2))
    for window in (None, 16):
        got = fp_ops.flash_prefill(q, k, v, window=window)
        torch.testing.assert_close(
            got, fp_ref.flash_prefill_ref(q, k, v, window=window), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv_h,t,S,d,offsets", [
    (4, 24, 24, 32, 256, 64, [0, 37, 100, 224]),
    (3, 8, 2, 12, 40, 32, [0, 5, 28]),
    (2, 4, 4, 20, 64, 128, [44, 3]),
    (2, 4, 2, 16, 40, 64, [30, 7])])   # row 0's span clamps to S - t
def test_chunk_kernel_matches_plain(cuda, cache_dtype, b, h, kv_h, t, S, d,
                                    offsets):
    gen = torch.Generator(device=cuda).manual_seed(t + S)
    q = torch.randn(b, t, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).to(cache_dtype).transpose(1, 2) for _ in range(2))
    k_new, v_new = (torch.randn(b, t, kv_h, d, generator=gen, device=cuda
                                ).transpose(1, 2) for _ in range(2))
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    for window in (None, 9):
        got = fp_ops.flash_chunk_prefill(q, k, v, k_new, v_new, off,
                                         window=window)
        torch.testing.assert_close(
            got, fp_ref.flash_chunk_prefill_ref(q, k, v, k_new, v_new, off,
                                                window=window), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv_h,S,d,lens", [
    (4, 24, 24, 256, 64, [1, 77, 200, 257]),   # 257: a lane parked past S
    (3, 8, 2, 48, 32, [0, 17, 48]),            # an empty row reads as zeros
    (2, 4, 1, 300, 128, [300, 129])])
def test_decode_kernel_matches_plain(cuda, kv_dtype, b, h, kv_h, S, d, lens):
    gen = torch.Generator(device=cuda).manual_seed(S + d)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).to(kv_dtype).transpose(1, 2) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for window in WINDOWS:
        got = da_ops.decode_attention(q, k, v, cl, window=window)
        _assert_contiguous_decode_close(got, q, k, v, cl, window)



@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv_h,S,d,lens,window", [
    (4, 24, 24, 256, 64, [1, 77, 200, 257], 33),
    (3, 8, 2, 48, 32, [0, 17, 48], 16),
    (2, 25, 5, 1600, 64, [1100, 1500], 1024)])
def test_decode_kernel_rounded_probs_matches_plain(cuda, b, h, kv_h, S, d,
                                                   lens, window):
    """The RP instantiation (a windowed contiguous bf16 cache, probabilities
    rounded to bf16 against the row's maximum) against its plain version,
    at hymba's window and GQA among others."""
    gen = torch.Generator(device=cuda).manual_seed(S + d + 1)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).bfloat16().transpose(1, 2) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = da_ops.decode_attention(q, k, v, cl, window=window)
    _assert_contiguous_decode_close(got, q, k, v, cl, window)


def _paged(rows, ps, gen, garbage):
    """(b, S, kv_h, d) rows -> a shuffled (1 + b * n, ps, kv_h, d) pool
    holding them, garbage in page 0 and in every slack row, and its (b, n)
    int32 block table."""
    b, S = rows.shape[:2]
    n = -(-S // ps)
    perm = torch.randperm(b * n, generator=torch.Generator().manual_seed(ps))
    bt = (perm + 1).reshape(b, n).to(torch.int32).to(rows.device)
    pool = garbage((1 + b * n, ps) + tuple(rows.shape[2:]))
    pad = torch.cat([rows, garbage((b, n * ps - S) + tuple(rows.shape[2:]))],
                    dim=1)
    pool[bt.long()] = pad.reshape((b, n, ps) + tuple(rows.shape[2:]))
    return pool, bt


def _float_garbage(gen, dtype, dev):
    return lambda shape: (torch.randn(shape, generator=gen, device=dev)
                          * 100).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv_h,S,d,lens", [
    (4, 24, 24, 256, 64, [1, 77, 200, 256]),
    (3, 8, 2, 48, 32, [0, 17, 48]),
    (2, 4, 1, 70, 128, [70, 33])])
def test_paged_decode_kernel_matches_plain_and_contiguous(
        cuda, ps, kv_dtype, b, h, kv_h, S, d, lens):
    gen = torch.Generator(device=cuda).manual_seed(S + ps)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).to(kv_dtype) for _ in range(2))
    junk = _float_garbage(gen, kv_dtype, cuda)
    (kp, bt), (vp, _) = _paged(k, ps, gen, junk), _paged(v, ps, gen, junk)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for window in WINDOWS:
        before = launch_counts()["decode_attention_paged"]
        got = da_ops.decode_attention_paged(q, kp, vp, bt, cl, window=window)
        assert launch_counts()["decode_attention_paged"] == before + 1
        torch.testing.assert_close(got, da_ref.paged_decode_attention_ref(
            q, kp, vp, bt, cl, window=window), **TOL)
        assert torch.equal(got, da_ops.decode_attention(
            q, _unrounded(k, window).transpose(1, 2),
            _unrounded(v, window).transpose(1, 2), cl, window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("b,h,kv_h,S,d,lens", [
    (4, 24, 24, 256, 64, [1, 77, 200, 256]),
    (3, 8, 2, 48, 32, [0, 17, 48])])
def test_paged_int8_decode_kernel_matches_plain_and_contiguous(
        cuda, ps, b, h, kv_h, S, d, lens):
    """Against the contiguous kernel reading the bf16 dequantized copy;
    the null page and the slack rows carry garbage values and scales."""
    gen = torch.Generator(device=cuda).manual_seed(S + ps)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).transpose(1, 2)

    def ints(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=cuda,
                             dtype=torch.int8)

    def scales(shape):
        return torch.rand(shape, generator=gen, device=cuda) * 0.05

    k, v = ints((b, S, kv_h, d)), ints((b, S, kv_h, d))
    ks, vs = scales((b, S, kv_h)), scales((b, S, kv_h))
    (kp, bt), (vp, _) = _paged(k, ps, gen, ints), _paged(v, ps, gen, ints)
    (ksp, _), (vsp, _) = _paged(ks, ps, gen, scales), _paged(vs, ps, gen, scales)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kd, vd = da_ref.dequant_bf16(k, ks), da_ref.dequant_bf16(v, vs)
    for window in WINDOWS:
        before = launch_counts()["decode_attention_paged_quant"]
        got = da_ops.decode_attention_paged_quant(q, kp, vp, ksp, vsp, bt, cl,
                                                  window=window)
        assert launch_counts()["decode_attention_paged_quant"] == before + 1
        torch.testing.assert_close(
            got, da_ref.paged_decode_attention_quant_ref(
                q, kp, vp, ksp, vsp, bt, cl, window=window), **TOL)
        assert torch.equal(got, da_ops.decode_attention(
            q, _unrounded(kd, window).transpose(1, 2),
            _unrounded(vd, window).transpose(1, 2), cl, window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv_h,t,S,d,offsets,window", [
    (4, 24, 24, 32, 256, 64, [0, 37, 100, 224], None),
    (3, 8, 2, 12, 40, 32, [0, 5, 28], 9),
    (2, 4, 4, 20, 64, 128, [44, 3], None)])
def test_paged_chunk_kernel_matches_plain_and_contiguous(
        cuda, ps, cache_dtype, b, h, kv_h, t, S, d, offsets, window):
    gen = torch.Generator(device=cuda).manual_seed(t + S + ps)
    q = torch.randn(b, t, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).to(cache_dtype) for _ in range(2))
    k_new, v_new = (torch.randn(b, t, kv_h, d, generator=gen, device=cuda
                                ).transpose(1, 2) for _ in range(2))
    junk = _float_garbage(gen, cache_dtype, cuda)
    (kp, bt), (vp, _) = _paged(k, ps, gen, junk), _paged(v, ps, gen, junk)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    before = launch_counts()["flash_chunk_prefill_paged"]
    got = fp_ops.flash_chunk_prefill_paged(q, kp, vp, bt, off, k_new, v_new,
                                           window=window)
    assert launch_counts()["flash_chunk_prefill_paged"] == before + 1
    torch.testing.assert_close(got, fp_ref.flash_chunk_prefill_paged_ref(
        q, kp, vp, bt, off, k_new, v_new, window=window), **TOL)
    assert torch.equal(got, fp_ops.flash_chunk_prefill(
        q, k.transpose(1, 2), v.transpose(1, 2), k_new, v_new, off,
        window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("b,h,kv_h,s,d,chunk", [
    (1, 24, 24, 128, 64, 32),    # the oracle's prompt as the engine's chunks
    (2, 8, 2, 77, 32, 20),       # chunks cross 16-row and key-tile edges
    (1, 4, 1, 50, 128, 16)])
def test_prompt_kernel_equals_chunk_kernel_on_f32_rows(cuda, window, b, h,
                                                       kv_h, s, d, chunk):
    """A prompt fed as chunks against an f32 cache holding its earlier rows
    gives the prompt kernel's bits: keys fall to tiles and warps by absolute
    position alone.  The cache rows from each chunk on hold NaN: the chunk
    kernel never reads them."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, s, kv_h, d, generator=gen, device=cuda
                        ).transpose(1, 2) for _ in range(2))
    whole = fp_ops.flash_prefill(q, k, v, window=window)
    S = s + 40
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        kc, vc = (torch.full((b, kv_h, S, d), float("nan"), device=cuda)
                  for _ in range(2))
        kc[:, :, :lo], vc[:, :, :lo] = k[:, :, :lo], v[:, :, :lo]
        off = torch.full((b,), lo, dtype=torch.int32, device=cuda)
        got = fp_ops.flash_chunk_prefill(
            q[:, :, lo:hi], kc, vc, k[:, :, lo:hi], v[:, :, lo:hi], off,
            window=window)
        assert torch.equal(got, whole[:, :, lo:hi]), (lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [5, 16])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_chunk_kernels_never_read_dead_rows(cuda, ps, cache_dtype):
    """Slack rows, the null page every dead table entry names, and the rows
    of each slot at or past offset + t hold NaN: the paged and contiguous
    outputs are finite, equal, and the plain version's on zeroed rows."""
    b, h, kv_h, t, S, d = 3, 8, 4, 20, 96, 64
    off = torch.tensor([0, 37, 70], dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(ps)
    q = torch.randn(b, t, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).to(cache_dtype) for _ in range(2))
    dead = (torch.arange(S, device=cuda)[None, :] >= off[:, None] + t)
    k[dead], v[dead] = float("nan"), float("nan")
    k_new, v_new = (torch.randn(b, t, kv_h, d, generator=gen, device=cuda
                                ).transpose(1, 2) for _ in range(2))

    def nans(shape):
        return torch.full(shape, float("nan"), device=cuda).to(cache_dtype)

    (kp, bt), (vp, _) = _paged(k, ps, gen, nans), _paged(v, ps, gen, nans)
    # table entries wholly past a slot's live rows name the null page 0
    pages_live = (off + t + ps - 1) // ps
    bt[torch.arange(bt.shape[1], device=cuda)[None, :]
       >= pages_live[:, None]] = 0
    got = fp_ops.flash_chunk_prefill_paged(q, kp, vp, bt, off, k_new, v_new)
    contiguous = fp_ops.flash_chunk_prefill(
        q, k.transpose(1, 2), v.transpose(1, 2), k_new, v_new, off)
    assert torch.isfinite(got).all()
    assert torch.equal(got, contiguous)
    kz, vz = (torch.nan_to_num(x, nan=0.0).transpose(1, 2) for x in (k, v))
    torch.testing.assert_close(got, fp_ref.flash_chunk_prefill_ref(
        q, kz, vz, k_new, v_new, off), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv_h,t,S,d,offsets,window", [
    (2, 4, 2, 20, 70, 64, [3, 50], None),    # row 1's span crosses key 64
    (1, 2, 2, 7, 9, 32, [2], None),          # one tile: the other warps idle
    (3, 4, 4, 33, 100, 128, [0, 31, 67], 40),
    (2, 6, 3, 17, 130, 64, [120, 60], 50)])  # row 0's span clamps to S - t
def test_chunk_kernel_ragged_tiles(cuda, cache_dtype, b, h, kv_h, t, S, d,
                                   offsets, window):
    """t and S off the 16-row and key-tile grids, spans crossing a key
    tile, blocks in which some warps get no live tile."""
    gen = torch.Generator(device=cuda).manual_seed(t * S)
    q = torch.randn(b, t, h, d, generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).to(cache_dtype).transpose(1, 2) for _ in range(2))
    k_new, v_new = (torch.randn(b, t, kv_h, d, generator=gen, device=cuda
                                ).transpose(1, 2) for _ in range(2))
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    got = fp_ops.flash_chunk_prefill(q, k, v, k_new, v_new, off,
                                     window=window)
    torch.testing.assert_close(got, fp_ref.flash_chunk_prefill_ref(
        q, k, v, k_new, v_new, off, window=window), **TOL)
    # the prompt kernel at a length off both grids
    qp, kp, vp = q[:1, :, :t], k_new[:1], v_new[:1]
    torch.testing.assert_close(
        fp_ops.flash_prefill(qp, kp, vp, window=window),
        fp_ref.flash_prefill_ref(qp, kp, vp, window=window), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_take_misaligned_operands(cuda, cache_dtype):
    """Operands starting off a 16-byte boundary (column slices of wider
    tensors) are copied element by element: the aligned operands' bits."""
    b, h, kv_h, t, S, d = 2, 4, 2, 20, 70, 64
    gen = torch.Generator(device=cuda).manual_seed(7)

    def sliced(*shape, dtype=torch.float32):
        wide = torch.randn(*shape[:-1], shape[-1] + 2, generator=gen,
                           device=cuda).to(dtype)
        return wide[..., 1:shape[-1] + 1].transpose(1, 2)

    q = sliced(b, t, h, d)
    k, v = sliced(b, S, kv_h, d, dtype=cache_dtype), sliced(
        b, S, kv_h, d, dtype=cache_dtype)
    k_new, v_new = sliced(b, t, kv_h, d), sliced(b, t, kv_h, d)
    off = torch.tensor([3, 50], dtype=torch.int32, device=cuda)
    got = fp_ops.flash_chunk_prefill(q, k, v, k_new, v_new, off)
    assert torch.equal(got, fp_ops.flash_chunk_prefill(
        q.contiguous(), k.contiguous(), v.contiguous(), k_new.contiguous(),
        v_new.contiguous(), off))
    torch.testing.assert_close(got, fp_ref.flash_chunk_prefill_ref(
        q, k, v, k_new, v_new, off), **TOL)
    prompt = fp_ops.flash_prefill(q, k_new, v_new)
    assert torch.equal(prompt, fp_ops.flash_prefill(
        q.contiguous(), k_new.contiguous(), v_new.contiguous()))


def _decode_rows(cuda, gen, b, S, kv_h, d):
    """Cache rows (b, S, kv_h, d) for the three decode forms: bf16 K, V;
    int8 K, V and their (b, S, kv_h) f32 scales."""
    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).to(torch.bfloat16) for _ in range(2))
    ki, vi = (torch.randint(-127, 128, (b, S, kv_h, d), generator=gen,
                            device=cuda, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, S, kv_h, generator=gen, device=cuda) * 0.05
              for _ in range(2))
    return k, v, ki, vi, ks, vs


def _decode_forms(cuda, gen, rows, ps):
    """The three decode forms on the same rows, each a callable of (q,
    cache_len, window): the contiguous kernel on the bf16 rows, the paged
    kernel on a shuffled pool of them, the paged int8 kernel on the int8
    rows and scales (pools of ``ps``-token pages, garbage in the null page
    and every slack row)."""
    k, v, ki, vi, ks, vs = rows
    junk = _float_garbage(gen, torch.bfloat16, cuda)

    def ints(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=cuda,
                             dtype=torch.int8)

    def scales(shape):
        return torch.rand(shape, generator=gen, device=cuda)

    (kp, bt), (vp, _) = _paged(k, ps, gen, junk), _paged(v, ps, gen, junk)
    (kip, bti), (vip, _) = _paged(ki, ps, gen, ints), _paged(vi, ps, gen, ints)
    (ksp, _), (vsp, _) = _paged(ks, ps, gen, scales), _paged(vs, ps, gen,
                                                             scales)
    return {
        "decode_attention": lambda q, cl, w: da_ops.decode_attention(
            q, k.transpose(1, 2), v.transpose(1, 2), cl, window=w),
        "decode_attention_paged": lambda q, cl, w:
            da_ops.decode_attention_paged(q, kp, vp, bt, cl, window=w),
        "decode_attention_paged_quant": lambda q, cl, w:
            da_ops.decode_attention_paged_quant(q, kip, vip, ksp, vsp, bti,
                                                cl, window=w)}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128])
def test_decode_kernels_are_batch_invariant(cuda, d):
    """Each slot of a ragged 4-slot batch (256-row cache, 16-token pages)
    decoded alone against a 300-row cache holding its rows and garbage
    past them (5-token pages) gives its batch row bit for bit, in all three
    forms: a slot's keys fall to units by position and head dim alone."""
    b, h, kv_h, S = 4, 8, 4, 256
    lens = [1, 77, 200, 256]
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).transpose(1, 2)
    rows = _decode_rows(cuda, gen, b, S, kv_h, d)
    more = _decode_rows(cuda, gen, 1, 300 - S, kv_h, d)
    batch = _decode_forms(cuda, gen, rows, 16)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for i, n in enumerate(lens):
        alone = _decode_forms(cuda, gen, [
            torch.cat([x[i:i + 1], y], dim=1) for x, y in zip(rows, more)],
            5)
        one = torch.tensor([n], dtype=torch.int32, device=cuda)
        for name in batch:
            for window in WINDOWS:
                assert torch.equal(alone[name](q[i:i + 1], one, window),
                                   batch[name](q, cl, window)[i:i + 1]), (
                    name, i, window)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [5, 16])
def test_decode_kernels_never_read_dead_keys(cuda, ps):
    """NaN in every row at or past a slot's cache_len, in every slack row,
    in the null page (named by the table entries past a slot's live pages)
    and, windowed, below the window's start: every form's output is finite
    and equals the plain version's on zeroed rows."""
    b, h, kv_h, S, d = 3, 8, 4, 96, 64
    lens = [0, 37, 90]
    gen = torch.Generator(device=cuda).manual_seed(ps)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).transpose(1, 2)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)

    def nans(shape):
        return torch.full(shape, float("nan"), device=cuda
                          ).to(torch.bfloat16)

    k, v = (torch.randn(b, S, kv_h, d, generator=gen, device=cuda
                        ).to(torch.bfloat16) for _ in range(2))
    ki, vi = (torch.randint(-127, 128, (b, S, kv_h, d), generator=gen,
                            device=cuda, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, S, kv_h, generator=gen, device=cuda) * 0.05
              for _ in range(2))
    for window in WINDOWS:
        lo = (cl - window).clamp(min=0) if window else torch.zeros_like(cl)
        pos = torch.arange(S, device=cuda)[None, :]
        dead = (pos >= cl[:, None]) | (pos < lo[:, None])
        kz, vz = (x.masked_fill(dead[..., None, None], 0.0) for x in (k, v))
        want = da_ref.decode_attention_ref(q, kz.transpose(1, 2),
                                           vz.transpose(1, 2), cl,
                                           window=window)
        kn, vn = (x.masked_fill(dead[..., None, None], float("nan"))
                  for x in (k, v))
        ksn, vsn = (x.masked_fill(dead[..., None], float("nan"))
                    for x in (ks, vs))
        (kp, bt), (vp, _) = _paged(kn, ps, gen, nans), _paged(vn, ps, gen,
                                                              nans)
        (kip, _), (vip, _) = _paged(ki, ps, gen, lambda s: torch.zeros(
            s, dtype=torch.int8, device=cuda)), _paged(
            vi, ps, gen, lambda s: torch.zeros(s, dtype=torch.int8,
                                               device=cuda))
        (ksp, _), (vsp, _) = (_paged(x, ps, gen, lambda s: torch.full(
            s, float("nan"), device=cuda)) for x in (ksn, vsn))
        # table entries wholly past a slot's live rows name the null page 0
        live_pages = (cl + ps - 1) // ps
        bt[torch.arange(bt.shape[1], device=cuda)[None, :]
           >= live_pages[:, None]] = 0
        got = {
            "contiguous": da_ops.decode_attention(
                q, kn.transpose(1, 2), vn.transpose(1, 2), cl,
                window=window),
            "paged": da_ops.decode_attention_paged(q, kp, vp, bt, cl,
                                                   window=window),
            "paged int8": da_ops.decode_attention_paged_quant(
                q, kip, vip, ksp, vsp, bt, cl, window=window)}
        kd = da_ref.dequant_bf16(ki, ks.masked_fill(dead[..., None], 0.0))
        vd = da_ref.dequant_bf16(vi, vs.masked_fill(dead[..., None], 0.0))
        want_int8 = da_ref.decode_attention_ref(
            q, kd.transpose(1, 2), vd.transpose(1, 2), cl, window=window)
        for name, out in got.items():
            assert torch.isfinite(out).all(), (name, window)
            if name == "contiguous":
                _assert_contiguous_decode_close(
                    out, q, kz.transpose(1, 2), vz.transpose(1, 2), cl,
                    window)
            else:
                torch.testing.assert_close(
                    out, want_int8 if name == "paged int8" else want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_take_misaligned_operands(cuda, kv_dtype):
    """A query, cache and pools starting off a 16-byte boundary (column
    slices of wider tensors) are copied element by element: the aligned
    operands' bits."""
    b, h, kv_h, S, d, ps = 3, 8, 4, 70, 64, 5
    gen = torch.Generator(device=cuda).manual_seed(11)

    def sliced(*shape, dtype=torch.float32):
        wide = torch.randn(*shape[:-1], shape[-1] + 2, generator=gen,
                           device=cuda).to(dtype)
        return wide[..., 1:shape[-1] + 1]

    q = sliced(b, 1, h, d).transpose(1, 2)
    k, v = sliced(b, S, kv_h, d, dtype=kv_dtype), sliced(b, S, kv_h, d,
                                                         dtype=kv_dtype)
    cl = torch.tensor([0, 33, 70], dtype=torch.int32, device=cuda)
    for window in WINDOWS:
        got = da_ops.decode_attention(q, k.transpose(1, 2),
                                      v.transpose(1, 2), cl, window=window)
        assert torch.equal(got, da_ops.decode_attention(
            q.contiguous(), k.contiguous().transpose(1, 2),
            v.contiguous().transpose(1, 2), cl, window=window))
        _assert_contiguous_decode_close(got, q, k.transpose(1, 2),
                                        v.transpose(1, 2), cl, window)
    junk = _float_garbage(gen, kv_dtype, cuda)
    (kp, bt), (vp, _) = _paged(k.contiguous(), ps, gen, junk), _paged(
        v.contiguous(), ps, gen, junk)
    wide = [torch.cat([x, x[..., :2]], dim=-1) for x in (kp, vp)]
    kp_s, vp_s = (x[..., 1:d + 1] for x in wide)
    for x, y in zip((kp_s, vp_s), (kp, vp)):
        x.copy_(y)
    assert torch.equal(
        da_ops.decode_attention_paged(q, kp_s, vp_s, bt, cl),
        da_ops.decode_attention_paged(q.contiguous(), kp, vp, bt, cl))


def _bf16_calls(cuda, gen):
    """The six attention wrappers on bf16-typed queries (and chunk K/V)
    at reduced shapes: name -> (the wrapper as a callable of the query
    dtype, its plain version on the bf16 inputs)."""
    b, h, kv_h, t, S, d, ps = 2, 8, 4, 20, 70, 64, 5

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    qp = randn(b, t, h, d).transpose(1, 2)
    kp_, vp_ = (randn(b, t, kv_h, d).transpose(1, 2) for _ in range(2))
    qc = randn(b, t, h, d).transpose(1, 2)
    kc, vc = (randn(b, S, kv_h, d).transpose(1, 2) for _ in range(2))
    kn, vn = (randn(b, t, kv_h, d).transpose(1, 2) for _ in range(2))
    off = torch.tensor([3, 50], dtype=torch.int32, device=cuda)
    junk = _float_garbage(gen, torch.bfloat16, cuda)
    kr, vr = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    (kpool, bt), (vpool, _) = _paged(kr, ps, gen, junk), _paged(vr, ps, gen,
                                                                 junk)
    qd = randn(b, 1, h, d).transpose(1, 2)
    cl = torch.tensor([33, 70], dtype=torch.int32, device=cuda)
    ki, vi = (torch.randint(-127, 128, (b, S, kv_h, d), generator=gen,
                            device=cuda, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, S, kv_h, generator=gen, device=cuda) * 0.05
              for _ in range(2))
    (kip, bti), (vip, _) = _paged(ki, ps, gen, lambda s: torch.zeros(
        s, dtype=torch.int8, device=cuda)), _paged(vi, ps, gen, lambda s:
                                                  torch.zeros(
            s, dtype=torch.int8, device=cuda))
    (ksp, _), (vsp, _) = (_paged(x, ps, gen, lambda s: torch.zeros(
        s, device=cuda)) for x in (ks, vs))
    return {
        "flash_prefill": (
            lambda dt: fp_ops.flash_prefill(qp.to(dt), kp_, vp_),
            lambda: fp_ref.flash_prefill_ref(qp, kp_, vp_)),
        "flash_chunk_prefill": (
            lambda dt: fp_ops.flash_chunk_prefill(qc.to(dt), kc, vc,
                                                  kn.to(dt), vn.to(dt), off),
            lambda: fp_ref.flash_chunk_prefill_ref(qc, kc, vc, kn, vn, off)),
        "flash_chunk_prefill_paged": (
            lambda dt: fp_ops.flash_chunk_prefill_paged(
                qc.to(dt), kpool, vpool, bt, off, kn.to(dt), vn.to(dt)),
            lambda: fp_ref.flash_chunk_prefill_paged_ref(
                qc, kpool, vpool, bt, off, kn, vn)),
        "decode_attention": (
            lambda dt: da_ops.decode_attention(qd.to(dt), kc, vc, cl),
            lambda: da_ref.decode_attention_ref(qd, kc, vc, cl)),
        "decode_attention_paged": (
            lambda dt: da_ops.decode_attention_paged(qd.to(dt), kpool, vpool,
                                                     bt, cl),
            lambda: da_ref.paged_decode_attention_ref(qd, kpool, vpool, bt,
                                                      cl)),
        "decode_attention_paged_quant": (
            lambda dt: da_ops.decode_attention_paged_quant(
                qd.to(dt), kip, vip, ksp, vsp, bti, cl),
            lambda: da_ref.paged_decode_attention_quant_ref(
                qd, kip, vip, ksp, vsp, bti, cl))}


@pytest.mark.gpu
def test_attention_wrappers_take_bf16_queries(cuda):
    """Each of the six attention wrappers takes a bf16 query (and bf16
    fresh chunk K/V), launches its kernel once and returns bf16: the f32
    launch on the same (exactly widened) values, rounded to bf16, and
    within TOL plus one bf16 ULP (2^-7 of the value) of its plain version
    on the same bf16 inputs, which rounds its own f32 result to bf16."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for name, (call, plain) in _bf16_calls(cuda, gen).items():
        before = launch_counts()[name]
        got = call(torch.bfloat16)
        assert launch_counts()[name] == before + 1, name
        assert got.dtype == torch.bfloat16, name
        assert torch.equal(got, call(torch.float32).to(torch.bfloat16)), name
        want = plain()
        assert want.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL["atol"], rtol=2 ** -7, msg=name)


@pytest.mark.gpu
def test_decode_launches_once_per_call(cuda):
    """One launch per decode call in each form, windowed or not, at every
    head dim."""
    for d in (32, 64, 128):
        gen = torch.Generator(device=cuda).manual_seed(d)
        forms = _decode_forms(cuda, gen, _decode_rows(cuda, gen, 2, 64, 2, d),
                              16)
        q = torch.randn(2, 1, 4, d, generator=gen, device=cuda
                        ).transpose(1, 2)
        cl = torch.tensor([40, 64], dtype=torch.int32, device=cuda)
        for name, call in forms.items():
            for window in WINDOWS:
                before = launch_counts()[name]
                call(q, cl, window)
                assert launch_counts()[name] == before + 1, (name, d)


# (m, n, k, row_multiple), at g in {2, 3, 5}: as TLMM_SHAPES, the split
# with a partial step being LUT_PARTIAL_STEP at g = 5
LUT_PARTIAL_STEP = (128, 1536, 4096, 64)
LUT_SHAPES = [
    (1, 1536, 1536, 64), (4, 4096, 1536, 64), (70, 165, 130, 1),
    (5, 96, 300, 8), (130, 1536, 257, 64), (16, 1536, 1536, 64),
    (17, 1536, 1536, 64), (1, 1536, 4096, 64), (1, 4096, 1536, 64),
    (4, 1536, 130, 64), (3, 0, 64, 1), LUT_PARTIAL_STEP]


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [0, 3])
@pytest.mark.parametrize("g", [2, 3, 5])
@pytest.mark.parametrize("m,n,k,row_multiple", LUT_SHAPES)
def test_tlmm_lut_kernel_equals_plain_and_tlmm(cuda, g, m, n, k,
                                               row_multiple, lead):
    codes, a = _ternary_operands(cuda, m, n, k, g, row_multiple, lead)
    before = launch_counts()["tlmm_lut"]
    got = lut_ops.tlmm_lut(a, codes, g=g)
    assert launch_counts()["tlmm_lut"] == before + (n > 0)
    assert torch.equal(got, lut_ref.tlmm_lut_ref(a, codes, g, n))
    assert torch.equal(got, tlmm_ops.tlmm(a, codes, g=g))
    assert torch.equal(got, lut_ops.tlmm_lut(a, codes, g=g))
    if n == 0:
        assert not got.any()
        return
    # activations longer than the codes: the columns past rows * g are unused
    short = codes[:n // (2 * g)]
    assert torch.equal(lut_ops.tlmm_lut(a, short, g=g),
                       tlmm_ops.tlmm(a, short, g=g))


def _assert_quant_close(got, want):
    (q, s), (q_want, s_want) = got, want
    torch.testing.assert_close(s, s_want, rtol=1e-6, atol=0)
    assert q.dtype == torch.int8 and q.shape == q_want.shape
    assert (q.int() - q_want.int()).abs().max().item() <= 1


def _assert_quant_equal(got, want):
    (q, s), (q_want, s_want) = got, want
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, q_want) and torch.equal(s, s_want)


def _norm_inputs(cuda, m, d, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(m * d + seed)
    x = (torch.randn(m, d, generator=gen, device=cuda) * 3).to(dtype)
    w = torch.randn(d, generator=gen, device=cuda).to(dtype)
    return x, w


@pytest.mark.gpu
def test_scalar_division_on_the_card_is_the_reciprocal_product(cuda):
    """ATen divides a CUDA tensor by a Python scalar as a product by the
    scalar's f32 reciprocal, the arithmetic XLA gives the JAX package under
    jit; a tensor divisor gives the true quotient.  So the main path's
    ``amax / 127.0`` (core/ternary.py) on the card is the reference's."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.rand(1 << 20, generator=gen, device=cuda) * 64
    prod = a * ternary.INV_127
    assert torch.equal(a / 127.0, prod)
    quot = a / torch.tensor(127.0, device=cuda)
    assert not torch.equal(quot, prod)
    assert torch.equal(quot.cpu(), a.cpu() / 127.0)   # the CPU divides


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(4, 1536), (128, 1536), (4, 1024),
                                 (128, 1024), (5, 96), (3, 1000)])
def test_rmsnorm_quant_kernel_matches_plain(cuda, dtype, m, d):
    """Within the tolerance of the plain version (its sum of squares runs
    in torch's order), and bit for bit the plain version in the kernel's
    order (plan.sum_of_squares)."""
    x, w = _norm_inputs(cuda, m, d, dtype)
    warps = rq_plan.warps_per_row(d)
    before = launch_counts()["rmsnorm_quant"]
    got = rq_ops.rmsnorm_quant(x, w)
    assert launch_counts()["rmsnorm_quant"] == before + 1
    _assert_quant_close(got, rq_ref.rmsnorm_quant_ref(x, w))
    _assert_quant_equal(got, rq_ref.rmsnorm_quant_ref(x, w, warps=warps))
    # f32 weight on bf16 activations, as the model's norms
    got = rq_ops.rmsnorm_quant(x, w.float())
    _assert_quant_close(got, rq_ref.rmsnorm_quant_ref(x, w.float()))
    _assert_quant_equal(got, rq_ref.rmsnorm_quant_ref(x, w.float(),
                                                      warps=warps))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1536, 1024, 1000, 96])
def test_rmsnorm_quant_row_alone_and_strided_equal_the_batch(cuda, d):
    """A row alone gives the bits it has in a batch of 128; a column slice
    (rows not on 16 bytes: the scalar instantiation) gives the bits of its
    contiguous copy (16-byte loads); bf16 x gives the bits of its f32
    widening."""
    x, w = _norm_inputs(cuda, 128, d + 3, torch.bfloat16, seed=1)
    xs, w = x[:, 1:d + 1], w[:d]
    assert not rq_plan.vector_ok(xs.data_ptr(), xs.stride(0) * 2,
                                 w.data_ptr(), d)
    xc = xs.contiguous()
    want = rq_ops.rmsnorm_quant(xc, w)
    for i in (0, 5, 127):
        q, s = rq_ops.rmsnorm_quant(xc[i:i + 1], w)
        assert torch.equal(q, want[0][i:i + 1]) and torch.equal(s, want[1][i:i + 1])
    _assert_quant_equal(rq_ops.rmsnorm_quant(xs, w), want)
    _assert_quant_equal(rq_ops.rmsnorm_quant(xc.float(), w.float()), want)
    _assert_quant_equal(rq_ops.rmsnorm_quant(xs.float(), w), want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 9, 2048, 4100, rq_plan.MAX_D])
def test_rmsnorm_quant_widths_equal_the_replay(cuda, d):
    """From one value to the widest row of one chunk a thread (one warp to
    32): bit for bit the plain version summing in the plan's order; an
    empty row is refused before a launch."""
    x, w = _norm_inputs(cuda, 37, d, torch.float32, seed=2)
    _assert_quant_equal(rq_kernel.rmsnorm_quant_cuda(x, w, eps=1e-5),
                        rq_ref.rmsnorm_quant_ref(
                            x, w, warps=rq_plan.warps_per_row(d)))
    x, w = _norm_inputs(cuda, 2, 0, torch.float32)
    before = launch_counts()["rmsnorm_quant"]
    with pytest.raises(ValueError):
        rq_kernel.rmsnorm_quant_cuda(x, w, eps=1e-5)
    assert launch_counts()["rmsnorm_quant"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [rq_plan.MAX_D + 8, 16384, 16384 + 3])
def test_rmsnorm_quant_wide_rows_equal_the_replay(cuda, d, dtype):
    """Rows past one chunk a thread take the looping kernel (32 warps, a
    thread's chunks t, t + 1024, ... in order): bit for bit the plain
    version summing in that order, with 16-byte loads and (d = 16387) by
    value; within the usual tolerance of the plain version's own order."""
    x, w = _norm_inputs(cuda, 5, d, dtype, seed=3)
    assert rq_plan.looped(d)
    before = launch_counts()["rmsnorm_quant"]
    got = rq_ops.rmsnorm_quant(x, w)
    assert launch_counts()["rmsnorm_quant"] == before + 1
    _assert_quant_equal(got, rq_ref.rmsnorm_quant_ref(
        x, w, warps=rq_plan.warps_per_row(d)))
    (q, sc), (q_w, sc_w) = got, rq_ref.rmsnorm_quant_ref(x, w)
    assert ((sc - sc_w).abs() / sc_w).max().item() <= 1e-6
    assert (q.int() - q_w.int()).abs().max().item() <= 1


def _swiglu_inputs(cuda, m, f, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(m + f + seed)
    gate, up = (torch.randint(-3000, 3000, (m, f), generator=gen,
                              device=cuda, dtype=torch.int32)
                for _ in range(2))
    gs, us = (torch.rand(m, 1, generator=gen, device=cuda) * 1e-3
              for _ in range(2))
    return gate, up, gs, us


@pytest.mark.gpu
@pytest.mark.parametrize("m,f", [(4, 4096), (128, 4096), (4, 2816),
                                 (128, 2816), (3, 100), (1, 4096), (2, 4100),
                                 (2, 8192), (2, 8196), (2, 11008),
                                 (2, sq_plan.MAX_F), (4, 29568),
                                 (128, 29568), (2, 65536), (3, 65539)])
def test_swiglu_quant_kernel_matches_plain(cuda, m, f):
    """Bit for bit: the kernel runs the plain version's operations on each
    value and the scale is the same product.  f = 4100 takes more than the
    plan's 512 threads to stay in registers, f = 8192 is the widest row
    kept there; f = 8196 is staged in shared memory, 11008 (a 7B model's
    FFN) in 88 KB, the widest row staged in 227 KB; 29568 (qwen2-72b's
    FFN), 65536 and 65539 (by value) are looped, read twice."""
    gate, up, gs, us = _swiglu_inputs(cuda, m, f)
    before = launch_counts()["swiglu_quant"]
    got = sq_ops.swiglu_quant(gate, up, gs, us)
    assert launch_counts()["swiglu_quant"] == before + 1
    _assert_quant_equal(got, sq_ref.swiglu_quant_ref(gate, up, gs, us))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [4096, 2816, 100, 8196])
def test_swiglu_quant_every_layout_equal(cuda, f):
    """Registers (f <= 8192) or shared memory (8196), a column slice of
    gate and up (the scalar instantiation) and a row alone give the bits
    of the plain version on a batch of 128; a row wider than the kernel
    takes is looped, and an empty one refused before a launch."""
    gate, up, gs, us = _swiglu_inputs(cuda, 128, f + 3, seed=1)
    gs1, us1 = gs.reshape(-1), us.reshape(-1)
    g, u = gate[:, :f].contiguous(), up[:, :f].contiguous()
    want = sq_ref.swiglu_quant_ref(g, u, gs, us)
    _assert_quant_equal(sq_kernel.swiglu_quant_cuda(g, u, gs1, us1), want)
    gsl, usl = gate[:, 1:f + 1], up[:, 3:f + 3]
    assert not sq_plan.vector_ok((gsl.data_ptr(), usl.data_ptr()),
                                 (4 * gsl.stride(0), 4 * usl.stride(0)), f)
    _assert_quant_equal(sq_kernel.swiglu_quant_cuda(gsl, usl, gs1, us1),
                        sq_ref.swiglu_quant_ref(gsl, usl, gs, us))
    wide = torch.zeros((1, sq_plan.MAX_F + 4), dtype=torch.int32,
                       device=cuda)
    assert sq_plan.looped(wide.shape[1])
    _assert_quant_equal(sq_kernel.swiglu_quant_cuda(wide, wide, gs1[:1],
                                                    us1[:1]),
                        sq_ref.swiglu_quant_ref(wide, wide, gs[:1], us[:1]))
    empty = torch.zeros((1, 0), dtype=torch.int32, device=cuda)
    before = launch_counts()["swiglu_quant"]
    with pytest.raises(ValueError):
        sq_kernel.swiglu_quant_cuda(empty, empty, gs1[:1], us1[:1])
    assert launch_counts()["swiglu_quant"] == before
    for i in (0, 64, 127):
        q, s = sq_ops.swiglu_quant(g[i:i + 1], u[i:i + 1], gs[i:i + 1],
                                   us[i:i + 1])
        assert torch.equal(q, want[0][i:i + 1]) and torch.equal(s, want[1][i:i + 1])


@pytest.mark.gpu
def test_empty_launch(cuda):
    """The launch floor's empty kernel launches and returns no error."""
    build.check(build.load().repro_empty_launch(
        torch.cuda.current_stream().cuda_stream), "repro_empty_launch")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_on_the_card(cuda, dtype):
    """bitnet-0.73b's FFN widths: five kernel launches and the same
    dataflow as on the CPU's plain versions; in f32, within the tolerance
    of tests/test_fused_block.py (an f32 test) of the unfused packed path.
    In bf16 the unfused path rounds its norm and SwiGLU outputs to bf16
    before it quantizes them, which moves a share of the 4096 SwiGLU codes
    of a row by one: at this width that moved outputs by up to 0.077 std
    on the H100, past that tolerance, without a fault in either path."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    mlp = torch.nn.ModuleDict({
        name: bitlinear.pack(bitlinear.init(gen, n_in, n_out))
        for name, n_in, n_out in (("gate", 1536, 4096), ("up", 1536, 4096),
                                  ("down", 4096, 1536))})
    norm_w = 1 + 0.1 * torch.randn(1536, generator=gen, device=cuda)
    x = torch.randn(7, 1536, generator=gen, device=cuda).to(dtype)
    before = launch_counts()
    got = fused_block.fused_ffn_packed(mlp, norm_w, x)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in
            ("rmsnorm_quant", "tlmm", "swiglu_quant")} == {
        "rmsnorm_quant": 1, "tlmm": 3, "swiglu_quant": 1}
    on_cpu = fused_block.fused_ffn_packed(mlp.cpu(), norm_w.cpu(), x.cpu())
    torch.testing.assert_close(got.float().cpu(), on_cpu.float(),
                               atol=1e-2, rtol=1e-2)
    if dtype == torch.float32:
        ref = fused_block.unfused_reference(mlp.to(cuda), norm_w, x)
        torch.testing.assert_close(got, ref, rtol=0.1,
                                   atol=0.05 * ref.std().item() + 1e-3)


# ---------------------------------------------------------------------------
# The serving engine's captured decode block
# ---------------------------------------------------------------------------

def _served_on_card(cuda):
    """The reduced qwen1.5-0.5b (2 layers, 2 heads of 32) with random
    packed weights on the card."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    return cfg, transformer.pack_params(cfg, transformer.init_params(cfg, gen))


def _card_requests(cfg, temperature, template=None):
    rng = np.random.default_rng(4)
    reqs = []
    for i in range(7):
        tail = rng.integers(1, cfg.vocab_size, size=int(rng.integers(2, 14)))
        prompt = tail if template is None else np.concatenate(
            [template[:int(rng.integers(4, len(template) + 1))], tail])
        reqs.append(Request(prompt=prompt,
                            max_new_tokens=int(rng.integers(2, 12)),
                            temperature=temperature, seed=100 + i))
    return reqs


ENGINE_MODES = {
    "contiguous": ({}, "decode_attention"),
    "paged": (dict(paged=True, page_size=5, kv_pages=8),
              "decode_attention_paged"),
    "int8": (dict(kv_quant=True), "decode_attention"),
    "paged_int8": (dict(paged=True, page_size=5, kv_pages=8, kv_quant=True),
                   "decode_attention_paged_quant"),
    "bf16": (dict(ctx=Ctx(act_dtype=torch.bfloat16)), "decode_attention"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_captured_engine_equals_host_driven(cuda, mode, temperature):
    """The device-resident engine (its decode block one captured CUDA graph,
    replayed) emits the host-driven engine's tokens bit for bit, greedy and
    sampled; every block's decode launches are counted, replays included,
    and no steady block waited on the host."""
    cfg, packed = _served_on_card(cuda)
    extra, decode_kernel = ENGINE_MODES[mode]
    kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=4,
              device="cuda", **extra)
    host = _card_requests(cfg, temperature)
    ServingEngine(cfg, packed, device_sched=False, **kw).run(host)
    eng = ServingEngine(cfg, packed, **kw)
    reset_launch_counts()
    dev = eng.run(_card_requests(cfg, temperature))
    torch.cuda.synchronize()
    for h, d in zip(host, dev):
        assert d.done and d.output.tolist() == h.output.tolist()
    st = eng.stats
    assert eng._graph is not None and st["decode_blocks"] >= 3
    assert launch_counts()[decode_kernel] == (
        st["decode_blocks"] * eng.decode_block * cfg.n_layers)
    assert st["steady_state_syncs_per_block"] == 0.0
    if "paged" in extra:
        assert st["admissions_deferred_pages"] > 0
        assert st["kv_pages_in_use"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-350m"])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_captured_recurrent_engine_equals_host_driven(cuda, name,
                                                      cache_dtype):
    """Reduced hymba and xLSTM on the card (whole-prompt admission, the
    state planes written in place by the replayed block): the captured
    engine emits the host-driven engine's tokens, greedy and sampled, 1-
    and 2-token prompts among the requests; hymba's decode launches are
    counted, replays included (blocks x ticks x layers)."""
    cfg = get_config(name).reduced(n_layers=4)
    packed = transformer.init_packed_params(
        cfg, torch.Generator(device=cuda).manual_seed(0))
    kw = dict(max_seq=32, batch_slots=3, decode_block=4, device="cuda",
              cache_dtype=cache_dtype)

    def requests(temperature):
        reqs = _card_requests(cfg, temperature)
        reqs[0].prompt, reqs[-1].prompt = np.asarray([5, 9]), np.asarray([3])
        return reqs

    for temperature in (0.0, 0.8):
        host = ServingEngine(cfg, packed, device_sched=False, **kw).run(
            requests(temperature))
        eng = ServingEngine(cfg, packed, **kw)
        eng.run(requests(temperature)[:1])   # capture the block
        reset_launch_counts()
        dev = eng.run(requests(temperature))
        torch.cuda.synchronize()
        assert eng._graph is not None
        for h, d in zip(host, dev):
            assert d.done and d.output.tolist() == h.output.tolist()
        if cfg.block_kind == "hymba":
            assert launch_counts()["decode_attention"] == (
                eng.stats["decode_blocks"] * eng.decode_block * cfg.n_layers)
        else:
            assert sum(launch_counts().values()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_captured_moe_engine_equals_host_driven(cuda, paged):
    """A reduced mixtral (8 experts, top-2) on the card, drop-free: the
    captured engine, its expert banks one tlmm launch an expert inside the
    replayed block, emits the host-driven engine's tokens, contiguous or
    paged (the same tokens either way), greedy and sampled; the block's
    tlmm launches are counted, replays included (blocks x ticks x layers x
    3 banks x 8 experts)."""
    import dataclasses
    cfg = get_config("mixtral-8x22b").reduced(d_model=128, n_heads=4,
                                              n_experts=8)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    gen = torch.Generator(device=cuda).manual_seed(0)
    packed = transformer.init_packed_params(cfg, gen)
    kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=4,
              device="cuda")
    contiguous = ServingEngine(cfg, packed, **kw).run(
        _card_requests(cfg, 0.0))
    if paged:
        kw.update(paged=True, page_size=5, kv_pages=16)
    for temperature in (0.0, 0.8):
        host = ServingEngine(cfg, packed, device_sched=False, **kw).run(
            _card_requests(cfg, temperature))
        eng = ServingEngine(cfg, packed, **kw)
        eng.run(_card_requests(cfg, temperature)[:1])   # capture the block
        reset_launch_counts()
        dev = eng.run(_card_requests(cfg, temperature))
        torch.cuda.synchronize()
        for h, d in zip(host, dev):
            assert d.done and d.output.tolist() == h.output.tolist()
        if temperature == 0.0:
            assert [d.output.tolist() for d in dev] == [
                c.output.tolist() for c in contiguous]
        st = eng.stats
        assert eng._graph is not None and eng._graph.launches["tlmm"] == (
            eng.decode_block * cfg.n_layers * 3 * cfg.n_experts)
        decode_tlmm = st["decode_blocks"] * eng._graph.launches["tlmm"]
        wave_tlmm = (st["prefill_chunks"] * cfg.n_layers * 3
                     * cfg.n_experts)
        assert launch_counts()["tlmm"] == decode_tlmm + wave_tlmm


@pytest.mark.gpu
def test_captured_engine_prefix_sharing_equals_plain_paged(cuda):
    """Prefix sharing on the card (5-token pages, 4-token chunks: bases
    inside a page copy it first): the plain paged engine's tokens, and both
    equal the contiguous engine's."""
    cfg, packed = _served_on_card(cuda)
    template = np.arange(3, 19)
    kw = dict(max_seq=40, batch_slots=3, prefill_chunk=4, decode_block=4,
              device="cuda")
    contiguous = ServingEngine(cfg, packed, **kw).run(
        _card_requests(cfg, 0.0, template))
    plain = ServingEngine(cfg, packed, paged=True, page_size=5, **kw).run(
        _card_requests(cfg, 0.0, template))
    eng = ServingEngine(cfg, packed, paged=True, page_size=5,
                        enable_prefix_sharing=True, **kw)
    shared = eng.run(_card_requests(cfg, 0.0, template))
    for c, p, s in zip(contiguous, plain, shared):
        assert s.output.tolist() == p.output.tolist() == c.output.tolist()
    st = eng.stats
    assert st["prefix_hits"] > 0 and st["kv_cow_splits"] > 0
    assert st["kv_pages_in_use"] == st["kv_prefix_cached_pages"]


# ---------------------------------------------------------------------------
# The captured decode block under injected faults
# ---------------------------------------------------------------------------

class _Readbacks(FaultInjector):
    """Counts the blocks read back: each launched its decode kernels, and a
    block whose dispatch failed after its retries is never read back."""
    n = 0

    def on_readback(self, blk, mask, bad_token):
        self.n += 1
        return super().on_readback(blk, mask, bad_token)


def _captured_ptrs(eng):
    """The addresses the captured graph reads and writes: the scheduler
    state, the NaN-lane buffer, the cache, the block table, the outputs."""
    tensors = [*eng._state.values(), eng._nan_dev, *eng._cache.values(),
               *eng._graph.outputs]
    if eng.paged:
        tensors.append(eng._bt_dev)
    return [t.data_ptr() for t in tensors]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_captured_engine_isolates_a_nan_lane(cuda, mode):
    """A NaN lane in a replayed block (block 4; block 0 was captured): the
    block's non-finite latch fails that request alone, every other request
    emits the fault-free tokens, and the pool rolls back."""
    cfg, packed = _served_on_card(cuda)
    extra, _ = ENGINE_MODES[mode]
    kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=4,
              device="cuda", **extra)
    base = ServingEngine(cfg, packed, **kw).run(_card_requests(cfg, 0.0))
    eng = ServingEngine(cfg, packed, audit_on_retire=True,
                        fault_injector=FaultInjector().inject_nan(lane=1,
                                                                  block=4),
                        **kw)
    reqs = eng.run(_card_requests(cfg, 0.0))
    assert eng._graph is not None and eng.stats["graph_captures"] == 1
    assert eng.stats["integrity_faults"] == 1
    failed = [r for r in reqs if r.status is RequestStatus.FAILED]
    assert len(failed) == 1 and "non-finite" in failed[0].error
    for r, b in zip(reqs, base):
        if r.status is RequestStatus.OK:
            assert r.output.tolist() == b.output.tolist()
        else:
            assert r.output.tolist() == b.output.tolist()[:len(r.output)]
    assert eng.audit()["ok"]
    if eng.paged:
        assert eng.stats["kv_pages_in_use"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_captured_engine_degrades_and_promotes_in_place(cuda, mode):
    """A dispatch outage past the retries degrades a captured engine to
    host-driven blocks (a request finishing there is DEGRADED); the canary
    passes and the same graph replays again on the same tensors: the
    host-driven engine's tokens (sampled), one
    capture in the engine's life, every captured address unchanged, and
    the decode launches counted for every block, eager or replayed."""
    cfg, packed = _served_on_card(cuda)
    extra, decode_kernel = ENGINE_MODES[mode]
    kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=4,
              device="cuda", **extra)
    host = _card_requests(cfg, 0.8)
    ServingEngine(cfg, packed, device_sched=False, **kw).run(host)
    fi = _Readbacks()
    eng = ServingEngine(cfg, packed, fault_injector=fi, dispatch_retries=2,
                        **kw)
    fi.armed = False
    eng.run(_card_requests(cfg, 0.8)[:2])   # captures the block
    fi.armed, fi.n = True, 0
    fi.dispatch_outage(2, 3)
    ptrs = _captured_ptrs(eng)
    reset_launch_counts()
    reqs = eng.run(_card_requests(cfg, 0.8))
    torch.cuda.synchronize()
    st = eng.stats
    assert st["sched_fallbacks"] == 1 and st["repromotions"] == 1
    assert st["degraded_blocks"] >= 1
    assert eng.lifetime["graph_captures"] == 1
    assert st["graph_captures"] == 0
    assert _captured_ptrs(eng) == ptrs
    assert all(r.status in (RequestStatus.OK, RequestStatus.DEGRADED)
               for r in reqs)
    for h, d in zip(host, reqs):
        assert d.output.tolist() == h.output.tolist()
    # the block whose dispatch failed is counted, never read back, and
    # launched nothing
    assert fi.n < st["decode_blocks"]
    assert launch_counts()[decode_kernel] == (
        fi.n * eng.decode_block * cfg.n_layers)
    assert st["steady_state_syncs_per_block"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_engine_retry_replays_the_fault_free_tokens(cuda,
                                                             temperature):
    """A NaN lane in a replayed block retries: the replay prefills the
    prompt plus the tokens so far and continues with the fault-free
    tokens, greedy and sampled."""
    cfg, packed = _served_on_card(cuda)
    kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=4,
              device="cuda")
    base = ServingEngine(cfg, packed, **kw).run(
        _card_requests(cfg, temperature))
    eng = ServingEngine(cfg, packed, max_retries=1, retry_backoff_s=0.0,
                        fault_injector=FaultInjector().inject_nan(lane=1,
                                                                  block=4),
                        **kw)
    reqs = eng.run(_card_requests(cfg, temperature))
    assert eng.stats["retries_total"] == 1
    assert all(r.status is RequestStatus.OK for r in reqs)
    for r, b in zip(reqs, base):
        assert r.output.tolist() == b.output.tolist()


# -- split-K decode and the mesh engine on the card --------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("s", [31, 101, 256, 257])
def test_splitk_on_the_card_matches_plain_and_merges_bitwise(cuda, s):
    """Split-K (plain PyTorch on the card) against the decode kernel's plain
    version, and the partials of simulated ranks merged in rank order
    against one call, bit for bit: every chunk is the same program."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn(3, 4, 1, 32, generator=gen, device=cuda)
    k, v = (torch.randn(3, 2, s, 32, generator=gen, device=cuda)
            for _ in range(2))
    cl = torch.tensor([1, s // 2, s - 2], dtype=torch.int32, device=cuda)
    for K in (2, 4, 8):
        ref = da_ops.decode_attention_splitk(q, k, v, cl, num_splits=K)
        torch.testing.assert_close(ref, da_ref.decode_attention_ref(
            q, k, v, cl), **TOL)
        kp, vp, chunk = da_ops._pad_seq(k, v, K)
        for shards in (2, K) if K > 2 else (2,):
            n = K // shards
            parts = [da_ops.splitk_partials(
                q, kp[:, :, r * n * chunk:(r + 1) * n * chunk],
                vp[:, :, r * n * chunk:(r + 1) * n * chunk], cl, n_splits=n,
                chunk=chunk, split0=r * n) for r in range(shards)]
            out = da_ops.splitk_combine(
                *(torch.cat(x, dim=2) for x in zip(*parts)), torch.float32)
            assert torch.equal(out, ref), (s, K, shards)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_captured_splitk_engine_equals_host_driven(cuda, mode):
    """kv_splits=2 on the card: the captured engine emits the host-driven
    engine's tokens and no decode kernel launches (every decode read is
    split-K); the chunk kernels still do."""
    cfg, packed = _served_on_card(cuda)
    extra, decode_kernel = ENGINE_MODES[mode]
    kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=4,
              device="cuda", kv_splits=2, **extra)
    host = _card_requests(cfg, 0.8)
    ServingEngine(cfg, packed, device_sched=False, **kw).run(host)
    eng = ServingEngine(cfg, packed, **kw)
    reset_launch_counts()
    dev = eng.run(_card_requests(cfg, 0.8))
    torch.cuda.synchronize()
    for h, d in zip(host, dev):
        assert d.done and d.output.tolist() == h.output.tolist()
    counts = launch_counts()
    assert eng._graph is not None and counts[decode_kernel] == 0
    # the paged int8 chunk read gathers and dequantizes, then runs the
    # contiguous chunk kernel
    paged_chunk = "paged" in extra and "kv_quant" not in extra
    assert counts["flash_chunk_prefill_paged" if paged_chunk
                  else "flash_chunk_prefill"] > 0
    assert eng.stats["steady_state_syncs_per_block"] == 0.0


@pytest.mark.gpu
def test_mesh_engine_in_an_nccl_world_of_one(cuda):
    """A (1, 1) DeviceMesh engine on NCCL: its captured block holds the
    gather of its outputs, and it emits the single-device engine's tokens
    (contiguous and paged with sharing); a gloo mesh drives the card too
    (ranks sharing it), a mesh of two backends is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serving.engine import check_mesh

    cfg, packed = _served_on_card(cuda)
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for extra in ({}, dict(paged=True, page_size=5, kv_pages=20,
                               enable_prefix_sharing=True)):
            kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4,
                      decode_block=4, device="cuda", **extra)
            want = ServingEngine(cfg, packed, **kw).run(
                _card_requests(cfg, 0.8))
            eng = ServingEngine(cfg, packed, mesh=mesh, **kw)
            got = eng.run(_card_requests(cfg, 0.8))
            torch.cuda.synchronize()
            assert eng._graph is not None and eng.mesh_shape == (1, 1)
            assert [r.output.tolist() for r in got] == \
                [r.output.tolist() for r in want]
            assert eng.stats["steady_state_syncs_per_block"] == 0.0
        gloo = dist.new_group(backend="gloo")

        def fake(groups):
            return type("Mesh", (), {
                "mesh_dim_names": ("data", "model"),
                "get_group": staticmethod(lambda axis: groups[axis]),
                "size": staticmethod(lambda i: 1)})()

        # ranks sharing the card: gloo, each collective staged through host
        # memory; groups of two backends are refused
        assert check_mesh(fake({"data": gloo, "model": gloo}),
                          cuda) == (1, 1)
        with pytest.raises(ValueError, match="needs nccl or gloo"):
            check_mesh(fake({"data": gloo, "model": dist.group.WORLD}),
                       cuda)
    finally:
        dist.destroy_process_group()


# -- MoE: the expert banks through tlmm ----------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rows", [2, 40, 8, 256])
def test_moe_expert_matmul_mixtral_banks_equal_plain(cuda, rows):
    """One tlmm launch an expert at mixtral-8x22b's bank shapes (8 experts,
    d 6144 <-> f 16384) at the capacities the smoke run reaches (cf 1.25:
    2 rows a tick, 40 a wave; drop-free: 8 and 256), bit for bit against
    the plain version per expert; the bank is never unpacked."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    cfg = get_config("mixtral-8x22b")
    for n_in, n_out in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
        wt = torch.randint(-1, 2, (cfg.n_experts, n_in, n_out), generator=gen,
                           device=cuda, dtype=torch.int8)
        codes = torch.stack([ternary.pack_ternary(w, 5, bitlinear.ROW_MULTIPLE)
                             for w in wt])
        del wt
        gamma = torch.rand(cfg.n_experts, generator=gen, device=cuda)
        x = torch.randn((cfg.n_experts, rows, n_in), generator=gen,
                        device=cuda)
        before = launch_counts()["tlmm"]
        got = layers._expert_matmul_packed(codes, gamma, n_in, 5, x)
        assert launch_counts()["tlmm"] == before + cfg.n_experts
        xq, xs = ternary.absmax_quant(x)
        for e in range(cfg.n_experts):
            acc = tlmm_ref.tlmm_ref(xq[e], codes[e], 5, n_in)
            assert torch.equal(got[e], acc.float() * xs[e] * gamma[e])
        del codes


@pytest.mark.gpu
def test_moe_captured_replay_equals_eager(cuda):
    """A CUDA graph holding a packed MoE layer (its per-expert tlmm
    launches, dispatch and combine) replays to its eager result bit for
    bit, on new inputs copied into the captured buffer, at 1.25 (drops)
    and drop-free."""
    cfg = get_config("mixtral-8x22b").reduced(d_model=256, n_heads=4,
                                              d_ff=512, n_experts=8)
    gen = torch.Generator(device=cuda).manual_seed(5)
    moe = layers.moe_pack(layers.moe_init(gen, cfg.d_model, cfg.d_ff,
                                          cfg.n_experts), 5)
    x = torch.randn((24, cfg.d_model), generator=gen, device=cuda)
    for cf in (1.25, float(cfg.n_experts)):
        kw = dict(top_k=cfg.top_k, capacity_factor=cf, ctx=Ctx())
        static = x.clone()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            layers.moe_apply(moe, static, **kw)      # warm-up
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = layers.moe_apply(moe, static, **kw)
        for seed in (1, 2):
            new = torch.randn(x.shape, generator=gen, device=cuda)
            static.copy_(new)
            before = launch_counts()["tlmm"]
            graph.replay()
            torch.cuda.synchronize()
            assert launch_counts()["tlmm"] == before   # a replay counts nothing here
            eager = layers.moe_apply(moe, new, **kw)
            assert torch.equal(out, eager), (cf, seed)


# ---------------------------------------------------------------------------
# QAT training on the card against the same call on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 8])
def test_flash_vjp_on_the_card_matches_the_cpu(cuda, window):
    """The live-tile attention and its flash backward (plain PyTorch, f32,
    TF32 off) on the card against the CPU: other summation orders, within
    TOL of outputs and gradients of order one."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(21)
    q = torch.randn(2, 4, 40, 16, generator=gen)
    k, v = (torch.randn(2, 2, 40, 16, generator=gen) for _ in range(2))
    do = torch.randn(2, 4, 40, 16, generator=gen)
    outs = []
    for dev in ("cpu", cuda):
        ins = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = attention.attention_skip(*ins, window=window, q_chunk=8,
                                       kv_chunk=8)
        grads = torch.autograd.grad(out, ins, do.to(dev))
        outs.append([out.detach().cpu()] + [g.cpu() for g in grads])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, **TOL)


# A leaf's gradient on the card against the CPU's with the quantizers
# pinned: both run the same int8 and ternary codes, so they differ in the
# order of their f32 sums alone.  The geometric mean of a calibration run's
# worst leaves on an H100 (6.7e-7 f32, 8.7e-4 TF32, which must exceed it;
# PERF.md section 6).
TRAIN_GRAD_RTOL = 2e-5


@pytest.mark.gpu
def test_qat_train_step_on_the_card_matches_the_cpu(cuda):
    """One QAT step of reduced bitnet-0.73b from the same masters and batch
    on the card and on the CPU, with chip_smoke.py phase 11 (b)'s gates:
    the loss within 1e-3 of itself, the gradient norm within 1e-2, every
    parameter within 2.2 lr (AdamW's first update is +-lr an element, so a
    gradient that ULPs or a moved int8 code take across zero moves an
    element by up to 2 lr), the update itself (the card's gradients
    through AdamW on the CPU give the card's parameters within 1e-6 of each
    tensor's largest), and every leaf's gradient within TRAIN_GRAD_RTOL of
    its largest element against the CPU replaying the card's quantized
    values, which a TF32 run of the card must fail."""
    import copy
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import apply_updates, trainable
    from repro_torch.training import loss_and_grads
    cfg = get_config("bitnet-0.73b").reduced()
    master = transformer.init_params(cfg, torch.Generator().manual_seed(22))
    batch = SyntheticLMDataset(cfg, batch=4, seq_len=32, seed=2,
                               device="cpu").batch_at(0)
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
    lr = 1e-3
    opt = adamw(lr=lr)

    def one_step(dev, tape=None, replay=False, tf32=False):
        p = copy.deepcopy(master).to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with (pinned_quantizers(tape, replay) if tape is not None
                  else contextlib.nullcontext()):
                loss, grads = loss_and_grads(cfg, ctx, p, b, 16)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        # a copy: AdamW clips the gradients in place
        grads_cpu = {n: g.to("cpu", copy=True) for n, g in grads.items()}
        upd, _ = opt.update(grads, opt.init(p), p)
        p = apply_updates(p, upd)
        return (float(loss), float(gnorm),
                {n: t.cpu() for n, t in trainable(p).items()}, grads_cpu)

    tape32, tape_tf32 = [], []
    l_c, g_c, p_c, gr_c = one_step(cuda, tape32)
    l_h, g_h, p_h, _ = one_step("cpu")
    err32 = leaf_grad_errors(gr_c, one_step("cpu", tape32, replay=True)[3])
    err_tf32 = leaf_grad_errors(one_step(cuda, tape_tf32, tf32=True)[3],
                                one_step("cpu", tape_tf32, replay=True)[3])
    print(f"pinned gradients, worst leaf: f32 {max(err32.values()):.3g}, "
          f"TF32 {max(err_tf32.values()):.3g}")
    assert abs(l_c - l_h) <= 1e-3 * abs(l_h)
    assert abs(g_c - g_h) <= 1e-2 * g_h
    p_ref = copy.deepcopy(master)
    upd, _ = opt.update({n: g.clone() for n, g in gr_c.items()},
                        opt.init(p_ref), p_ref)
    p_ref = trainable(apply_updates(p_ref, upd))
    for n, t in p_h.items():
        assert (p_c[n] - t).abs().max() <= 2.2 * lr, n
        assert (p_c[n] - p_ref[n]).abs().max() <= 1e-6 * t.abs().max(), n
    assert max(err32.values()) <= TRAIN_GRAD_RTOL, err32
    assert max(err_tf32.values()) > TRAIN_GRAD_RTOL, err_tf32


def _pinned_step_grads(cfg, master, batch, dev, tapes, replay, tf32=False):
    """One QAT step's gradients (on the CPU) from ``master`` on ``dev``,
    with the quantizers and the MoE routing recorded into ``tapes`` or
    replayed from them."""
    import copy
    from repro_torch.training import loss_and_grads
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
    p = copy.deepcopy(master).to(dev)
    b = {k: v.to(dev) for k, v in batch.items()}
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with pinned_quantizers(tapes[0], replay), \
                pinned_routing(tapes[1], replay):
            loss, grads = loss_and_grads(cfg, ctx, p, b, 16)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return float(loss), {n: g.to("cpu", copy=True) for n, g in grads.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mixtral-8x22b", "hymba-1.5b",
                                  "xlstm-350m"])
def test_qat_step_of_moe_and_recurrent_kinds_on_the_card(cuda, name):
    """One QAT step of reduced mixtral-8x22b, hymba-1.5b and xlstm-350m on
    the card against the CPU replaying the card's quantized values and, for
    MoE, its top-k indices (a routing ULP flips an expert, which no
    gradient tolerance describes): every gradient leaf within
    TRAIN_GRAD_RTOL of its largest element, finite, and the loss within
    1e-5 of itself; a TF32 run of the card replayed the same way must
    exceed the limit."""
    from repro_torch.data.pipeline import SyntheticLMDataset
    cfg = get_config(name).reduced()
    master = transformer.init_params(cfg, torch.Generator().manual_seed(25))
    batch = SyntheticLMDataset(cfg, batch=4, seq_len=32, seed=5,
                               device="cpu").batch_at(0)
    errs, losses = {}, {}
    for tf32 in (False, True):
        tapes = ([], [])
        l_c, g_c = _pinned_step_grads(cfg, master, batch, cuda, tapes, False,
                                      tf32)
        l_h, g_h = _pinned_step_grads(cfg, master, batch, "cpu", tapes, True)
        assert all(torch.isfinite(g).all() for g in g_c.values())
        errs[tf32], losses[tf32] = leaf_grad_errors(g_c, g_h), (l_c, l_h)
        if cfg.n_experts:
            assert tapes[1], "no MoE routing recorded"
    print(f"{name}: pinned gradients, worst leaf: f32 "
          f"{max(errs[False].values()):.3g}, TF32 "
          f"{max(errs[True].values()):.3g}; losses {losses}")
    assert abs(losses[False][0] - losses[False][1]) <= 1e-5 * abs(
        losses[False][1])
    assert max(errs[False].values()) <= TRAIN_GRAD_RTOL, errs[False]
    assert max(errs[True].values()) > TRAIN_GRAD_RTOL, errs[True]


@pytest.mark.gpu
def test_moe_qat_gradients_are_deterministic_on_the_card(cuda, monkeypatch):
    """Reduced mixtral-8x22b's QAT loss and gradients, twice on the card
    under ``torch.use_deterministic_algorithms`` (as the resumed run of
    chip_smoke.py phase 11 (c) is), bit for bit: the MoE dispatch's
    backward is an accumulating index put into the tokens' gradient, with
    atomics on the card outside that mode."""
    import copy
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.training import loss_and_grads
    cfg = get_config("mixtral-8x22b").reduced()
    assert cfg.n_experts
    master = transformer.init_params(cfg, torch.Generator().manual_seed(25))
    batch = SyntheticLMDataset(cfg, batch=4, seq_len=64, seed=5,
                               device="cpu").batch_at(0)
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    def grads():
        p = copy.deepcopy(master).to(cuda)
        b = {k: v.to(cuda) for k, v in batch.items()}
        loss, g = loss_and_grads(cfg, ctx, p, b, 16)
        return loss.detach().cpu(), {n: t.cpu() for n, t in g.items()}

    torch.use_deterministic_algorithms(True)
    try:
        (l1, g1), (l2, g2) = grads(), grads()
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(l1, l2)
    assert all(torch.isfinite(t).all() for t in g1.values())
    assert [n for n in g1 if not torch.equal(g1[n], g2[n])] == []


EP_STEP_BODY = '''
import copy, json
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import layers
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh
from repro_torch.testing import (leaf_grad_errors, pinned_quantizers,
                                 pinned_routing)
from repro_torch.training import loss_and_grads, make_train_step_sharded

dev = torch.device(%(device)r)
cfg = get_config("mixtral-8x22b").reduced(n_layers=2, d_model=64,
                                          n_heads=4, d_ff=128)
master = transformer.init_params(cfg, torch.Generator().manual_seed(25))
batch = {k: v.to(dev) for k, v in SyntheticLMDataset(
    cfg, batch=4, seq_len=32, seed=5, device="cpu").batch_at(0).items()}
ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
tapes = ([], [])
with pinned_quantizers(tapes[0], False), pinned_routing(tapes[1], False):
    l_ref, g_ref = loss_and_grads(cfg, ctx, copy.deepcopy(master).to(dev),
                                  batch, 16)
mesh = TrainMesh(%(shape)r)
zero1 = %(layout)r == "dpzero1"
params = sharding.shard_params(mesh, copy.deepcopy(master).to(dev),
                               fsdp=False, layout="dp" if zero1 else "2d")
z = sharding.Zero1(mesh, params) if zero1 else None
opt = adamw(lr=1e-3)
step = make_train_step_sharded(cfg, ctx, opt, mesh, global_batch=4,
                               layout=%(layout)r, zero1=z, loss_chunk=16,
                               return_grads=True)
drops = [0]
with pinned_quantizers(tapes[0], True), pinned_routing(tapes[1], True):
    replayed = layers.moe_route

    def counting(*a, **kw):   # the pairs the replayed routing drops
        r = replayed(*a, **kw)
        drops[0] += int((~r["keep"]).sum())
        return r

    layers.moe_route = counting
    try:
        params, _, m = step(params, opt.init(params, zero1=z), batch)
    finally:
        layers.moe_route = replayed
specs = sharding.tree_specs(params)
grads = {n: mesh.full_part(g, specs[n]).cpu() for n, g in m["grads"].items()}
err = leaf_grad_errors(grads, {n: g.cpu() for n, g in g_ref.items()})
finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
if RANK == 0:
    print("EP " + json.dumps(dict(loss=float(m["loss"]), loss_ref=float(
        l_ref), worst=max(err.values()), finite=finite, drops=drops[0],
        bank_block=list(params["layers"][0]["moe"].gate_w.shape))),
        flush=True)
finish("EP_STEP_OK")
'''


@pytest.mark.gpu
@pytest.mark.parametrize("shape,layout", [((1, 2), "2d"),
                                          ((2, 1), "dpzero1")])
def test_expert_parallel_moe_step_on_two_ranks_on_the_card(cuda, tmp_path,
                                                           shape, layout):
    """One QAT step of reduced mixtral-8x22b at capacity factor 1.25 on two
    gloo ranks on the one card against the single-device step on the card,
    with the single-device step's quantized values and top-k indices
    replayed on each rank: on (1, 2) ``2d`` each rank computes two of the
    four experts (the router gathered, the partial outputs summed over
    "model"); on (2, 1) ``dpzero1`` each rank its half of the batch, the
    capacity and positions counted over the global batch (the batch drops
    pairs).  The loss within 1e-5 of itself and every gradient leaf within
    TRAIN_GRAD_RTOL of its largest."""
    import json
    from torch_mesh_helpers import launch
    out = launch(tmp_path, EP_STEP_BODY % dict(
        device="cuda", shape=shape, layout=layout), 2, "EP_STEP_OK",
        timeout=300)
    line = next(x for x in out.splitlines() if x.startswith("EP "))
    r = json.loads(line[3:])
    print(f"MoE step on {shape} {layout} on the card: {r}")
    assert r["finite"] and r["drops"] >= 1, r
    assert r["bank_block"][0] == (2 if layout == "2d" else 4), r
    assert abs(r["loss"] - r["loss_ref"]) <= 1e-5 * abs(r["loss_ref"]), r
    assert r["worst"] <= TRAIN_GRAD_RTOL, r


SERVE_MESH_BODY = '''
import json
from repro_torch import kernels
from repro_torch.models.layers import Ctx
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
arch, kw, kv8, matmul = json.loads(%(case)r)
cfg = get_config(arch).reduced(**kw)
full = transformer.init_packed_params(
    cfg, torch.Generator(device=dev).manual_seed(30))
g = torch.Generator(device=dev).manual_seed(31)
for m in full.modules():   # random biases, so that their slices show
    if getattr(m, "b", None) is not None and m.b.dim() == 1:
        m.b = torch.randn(m.b.shape, generator=g, device=dev) * 0.1
B, T, S = 4, 12, 64
if cfg.frontend == "token":
    prompt = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                           device=dev, dtype=torch.int32)
else:
    prompt = torch.randn((B, T, cfg.d_model), generator=g, device=dev)
mesh = TrainMesh((1, 2))
params = sharding.shard_params(mesh, full, fsdp=False)
cache = sharding.local_cache(mesh, transformer.init_cache(
    cfg, B, S, torch.float32, dev, kv_quant=kv8), B)
whole = transformer.init_cache(cfg, B, S, torch.float32, dev, kv_quant=kv8)
ctx = Ctx(mode="packed", matmul=matmul, constrain=sharding.make_constrain(
    mesh, cfg, B, max_seq=S))
ref_ctx = Ctx(mode="packed", matmul=matmul, kv_splits=2)
kernels.reset_launch_counts()
with torch.no_grad():
    want, _ = transformer.prefill_step(cfg, full, prompt, ref_ctx, whole)
    got, _ = transformer.prefill_step(cfg, params, prompt, ctx, cache)
    out = {"prefill": float((got - want).abs().max() / want.abs().max()),
           "decode": []}
    tok = want.argmax(-1)
    for i in range(4):
        inp = (tok[:, None].to(torch.int32) if cfg.frontend == "token"
               else torch.randn((B, 1, cfg.d_model), generator=g,
                                device=dev))
        want, _ = transformer.decode_step(cfg, full, inp, ref_ctx, whole,
                                          T + i)
        got, _ = transformer.decode_step(cfg, params, inp, ctx, cache, T + i)
        out["decode"].append(float((got - want).abs().max()))
        tok = want.argmax(-1)
out["launches"] = kernels.launch_counts()
if RANK == 0:
    print("SERVE " + json.dumps(out), flush=True)
finish("SERVE_MESH_OK")
'''


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    ("bitnet-0.73b", dict(n_heads=3, d_model=96), False, "tlmm"),
    ("qwen2-72b", dict(n_heads=8, n_kv_heads=1, d_model=256), False, "tlmm"),
    ("musicgen-medium", dict(n_heads=4, d_model=128), False, "tlmm"),
    ("bitnet-0.73b", dict(n_heads=4, d_model=128), True, "tlmm"),
    ("bitnet-0.73b", dict(n_heads=4, d_model=128), False, "tlmm_lut"),
    ("mixtral-8x22b", dict(n_heads=4, d_model=128, n_experts=3), False,
     "tlmm"),
    ("hymba-1.5b", dict(n_heads=4, n_kv_heads=2, d_model=128), False,
     "tlmm")],
    ids=["bitnet 3 heads", "qwen2 kv 1", "musicgen", "bitnet kv8",
         "bitnet tlmm_lut", "mixtral split banks", "hymba heads split"])
def test_partitioned_serving_on_two_ranks_on_the_card(cuda, tmp_path, case):
    """JAX's partitioned packed serving program (``make_constrain(max_seq=)``)
    on a (1, 2) mesh of two gloo ranks on the one card, reduced configs with
    head dim 32: the mixer whole on each rank (3 heads), K/V split inside a
    head (8 heads on 1 KV head, random QKV biases), the embed frontend, an
    int8 cache, ``tlmm_lut``, mixtral's 3 experts (each bank split inside
    each expert: every expert's ``tlmm`` on a rank's columns) and hymba's
    heads split (the SSM's scan and state on a rank's heads, its state
    whole in its heads), against the single-device port on the card
    reading its cache by split-K over the 2 shards' chunks: prefill logits
    within 1e-4 of their largest, 4 decode steps within 2e-3, the packed
    matmul's kernel launched."""
    import json
    from torch_mesh_helpers import launch
    arch, kw, kv8, matmul = case
    kw = dict(n_layers=2, d_ff=256, vocab_size=128, **kw)
    out = launch(tmp_path, SERVE_MESH_BODY % dict(case=json.dumps(
        [arch, kw, kv8, matmul])), 2, "SERVE_MESH_OK", timeout=300)
    r = json.loads(next(x for x in out.splitlines()
                        if x.startswith("SERVE "))[len("SERVE "):])
    print(f"partitioned serving {case} on the card: {r}")
    assert r["prefill"] <= 1e-4, r
    assert max(r["decode"]) <= 2e-3, r
    assert r["launches"][matmul] > 0 and r["launches"]["flash_prefill"] > 0, r
