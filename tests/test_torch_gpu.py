"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device (``pytest -m gpu tests/test_torch_gpu.py`` on the card; every test
skips without one).  Imports no JAX, so it runs where JAX is not installed.

tlmm, tlmm_lut and the packed linear are compared for equality (int32
sums); rmsnorm_quant and swiglu_quant with their plain versions by scales
within rtol 1e-6 and codes at most one apart (a sum of squares taken in
another order); the f32 attention kernels within 2e-5 absolute and
relative — they sum in another order than the plain versions, a few ULPs
of values of order one.  The
paged kernels walk keys in the contiguous kernels' order, so against those
on the same rows they are compared with ``torch.equal``.
"""

import pytest
import torch

from repro_torch.core import bitlinear, fused_block, ternary
from repro_torch.kernels import launch_counts
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill import ref as fp_ref
from repro_torch.kernels.rmsnorm_quant import ops as rq_ops
from repro_torch.kernels.rmsnorm_quant import ref as rq_ref
from repro_torch.kernels.swiglu_quant import ops as sq_ops
from repro_torch.kernels.swiglu_quant import ref as sq_ref
from repro_torch.kernels.tlmm import ops as tlmm_ops
from repro_torch.kernels.tlmm import ref as tlmm_ref
from repro_torch.kernels.tlmm_lut import ops as lut_ops
from repro_torch.kernels.tlmm_lut import ref as lut_ref

TOL = dict(atol=2e-5, rtol=2e-5)
PAGE_SIZES = (4, 5, 16)
WINDOWS = (None, 33)   # 33: the first live key falls inside a 32-key tile


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,g,row_multiple", [
    (1, 1536, 1536, 5, 64), (70, 165, 130, 5, 1), (5, 96, 64, 3, 8),
    (130, 4096, 200, 5, 64), (3, 64, 48, 4, 1)])
def test_tlmm_kernel_equals_plain(cuda, m, n, k, g, row_multiple):
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    w = torch.randint(-1, 2, (n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    codes = ternary.pack_ternary(w, g, row_multiple)
    a = torch.randint(-128, 128, (m, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    before = launch_counts()["tlmm"]
    got = tlmm_ops.tlmm(a, codes, g=g)
    assert launch_counts()["tlmm"] == before + 1
    torch.testing.assert_close(got, tlmm_ref.tlmm_ref(a, codes, g, n),
                               rtol=0, atol=0)


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
        torch.testing.assert_close(
            got, da_ref.decode_attention_ref(q, k, v, cl, window=window),
            **TOL)



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
            q, k.transpose(1, 2), v.transpose(1, 2), cl, window=window))


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
            q, kd.transpose(1, 2), vd.transpose(1, 2), cl, window=window))


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
@pytest.mark.parametrize("g", [2, 3, 5])
@pytest.mark.parametrize("m,n,k,row_multiple", [
    (1, 1536, 1536, 64), (4, 4096, 1536, 64), (70, 165, 130, 1),
    (5, 96, 300, 8), (130, 1536, 257, 64)])
def test_tlmm_lut_kernel_equals_plain_and_tlmm(cuda, g, m, n, k,
                                               row_multiple):
    gen = torch.Generator(device=cuda).manual_seed(m + n + k + g)
    w = torch.randint(-1, 2, (n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    codes = ternary.pack_ternary(w, g, row_multiple)
    a = torch.randint(-128, 128, (m, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    before = launch_counts()["tlmm_lut"]
    got = lut_ops.tlmm_lut(a, codes, g=g)
    assert launch_counts()["tlmm_lut"] == before + 1
    assert torch.equal(got, lut_ref.tlmm_lut_ref(a, codes, g, n))
    assert torch.equal(got, tlmm_ops.tlmm(a, codes, g=g))
    # activations longer than the codes: the columns past rows * g are unused
    short = codes[:n // (2 * g)]
    assert torch.equal(lut_ops.tlmm_lut(a, short, g=g),
                       tlmm_ops.tlmm(a, short, g=g))


def _assert_quant_close(got, want):
    (q, s), (q_want, s_want) = got, want
    torch.testing.assert_close(s, s_want, rtol=1e-6, atol=0)
    assert q.dtype == torch.int8 and q.shape == q_want.shape
    assert (q.int() - q_want.int()).abs().max().item() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(4, 1536), (128, 1536), (5, 96), (3, 1000)])
def test_rmsnorm_quant_kernel_matches_plain(cuda, dtype, m, d):
    gen = torch.Generator(device=cuda).manual_seed(m * d)
    x = (torch.randn(m, d, generator=gen, device=cuda) * 3).to(dtype)
    w = torch.randn(d, generator=gen, device=cuda).to(dtype)
    before = launch_counts()["rmsnorm_quant"]
    got = rq_ops.rmsnorm_quant(x, w)
    assert launch_counts()["rmsnorm_quant"] == before + 1
    _assert_quant_close(got, rq_ref.rmsnorm_quant_ref(x, w))
    # f32 weight on bf16 activations, as the model's norms
    _assert_quant_close(rq_ops.rmsnorm_quant(x, w.float()),
                        rq_ref.rmsnorm_quant_ref(x, w.float()))


@pytest.mark.gpu
@pytest.mark.parametrize("m,f", [(4, 4096), (128, 4096), (3, 100)])
def test_swiglu_quant_kernel_matches_plain(cuda, m, f):
    gen = torch.Generator(device=cuda).manual_seed(m + f)
    gate, up = (torch.randint(-3000, 3000, (m, f), generator=gen,
                              device=cuda, dtype=torch.int32)
                for _ in range(2))
    gs, us = (torch.rand(m, 1, generator=gen, device=cuda) * 1e-3
              for _ in range(2))
    before = launch_counts()["swiglu_quant"]
    got = sq_ops.swiglu_quant(gate, up, gs, us)
    assert launch_counts()["swiglu_quant"] == before + 1
    _assert_quant_close(got, sq_ref.swiglu_quant_ref(gate, up, gs, us))


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
