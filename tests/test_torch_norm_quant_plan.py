"""The designs of the RMS-MAX kernel (``repro_torch/csrc/rmsnorm_quant.cu``)
and the SwiGLU requant kernel (``csrc/swiglu_quant.cu``) checked on the CPU
before the card, and the scale arithmetic they share with the JAX package.

rmsnorm_quant: ``kernels/rmsnorm_quant/plan.py`` fixes the order of a row's
sum of squares by d alone.  Its torch replay (``plan.sum_of_squares``) is
held bit for bit to a lane-by-lane, shuffle-by-shuffle emulation in numpy
f32 built from the plan's partition, a row gives the same scale and codes
alone as in any batch, and the replayed kernel stays within the JAX kernel
tests' tolerance (scales rtol 1e-6, codes at most one apart) of the plain
version and of the JAX Pallas kernel in interpret mode.

swiglu_quant: ``kernels/swiglu_quant/plan.py`` serves a row with one
block, in registers or staged in shared memory by f.  The plan covers each
value of a row exactly once at every width, from one chunk to the widest
row the kernel takes, and the kernel's dataflow replayed over that
partition (h once per value, each thread's maximum, the block's maximum,
each thread's codes) equals the plain version bit for bit.

Both: the choice between 16-byte and scalar loads follows the tensors'
alignment and strides, and the scale is ``amax * f32(1/127)``, the product
the JAX kernels compute (they run jitted, and XLA turns the division by the
constant 127 into a product by its reciprocal; eager JAX and PyTorch on the
CPU divide, PyTorch on the card multiplies: ``tests/test_torch_gpu.py``).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as j_ternary
from repro.kernels.rmsnorm_quant import ops as j_rq
from repro.kernels.rmsnorm_quant import ref as j_rq_ref
from repro.kernels.swiglu_quant import ops as j_sq

from repro_torch.core import ternary
from repro_torch.kernels.rmsnorm_quant import plan as rq_plan
from repro_torch.kernels.rmsnorm_quant import ref as rq_ref
from repro_torch.kernels.swiglu_quant import plan as sq_plan
from repro_torch.kernels.swiglu_quant import ref as sq_ref

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc"
F32_INV_127 = np.float32(1) / np.float32(127)
D_CASES = (96, 1000, 1024, 1536)
F_CASES = (100, 2816, 4096)
WIDE_F_CASES = (sq_plan.MAX_REGISTER_F, sq_plan.MAX_REGISTER_F + 4, 11008,
                sq_plan.MAX_F)
# past shared memory: the looped row (29568 is qwen2-72b's d_ff)
LOOPED_F_CASES = (sq_plan.MAX_F + 4, 29568, 65536, 65536 + 3)
# past one chunk a thread: the looping RMS-MAX kernel (8 values past the
# widest one-chunk row, and twice its width)
WIDE_D_CASES = (8192 + 8, 16384)
BATCHES = (1, 4, 5, 128)


def _assert_quant_close(got, want):
    """(int8, scale) pairs: scales within rtol 1e-6, codes at most one
    apart (a sum of squares in another order)."""
    (q, s), (q_want, s_want) = got, want
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_want), rtol=1e-6)
    diff = np.abs(np.asarray(q, np.int32) - np.asarray(q_want, np.int32))
    assert diff.max() <= 1


def _assert_quant_equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _inputs(d, dtype, m=128, seed=0):
    rng = np.random.default_rng(seed + d)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32) * 3)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(d).astype(np.float32))
    return x.to(dtype), w


# -- rmsnorm_quant: the plan and its order --------------------------------------

def test_rmsnorm_plan_matches_the_kernel_source():
    src = (CSRC / "rmsnorm_quant.cu").read_text()
    assert _constant(src, "CHUNK") == rq_plan.CHUNK
    assert _constant(src, "MAX_THREADS") == rq_plan.MAX_THREADS
    # the C launch's block: whole warps, one chunk a thread
    assert "32 * ((d + 32 * CHUNK - 1) / (32 * CHUNK))" in src
    assert "d > CHUNK * MAX_THREADS" in src


@pytest.mark.parametrize("d", D_CASES + (1, 8, 9, 4096, rq_plan.MAX_D))
def test_rmsnorm_plan_covers_each_chunk_once(d):
    """The plan's block holds every chunk of a row exactly once, one chunk
    a thread, in whole warps the kernel's launch bound takes."""
    warps = rq_plan.warps_per_row(d)
    assert 32 * warps <= rq_plan.MAX_THREADS
    assert 32 * (warps - 1) < rq_plan.n_chunks(d) <= 32 * warps
    seen = []
    for t in range(32 * warps):
        chunks = rq_plan.thread_chunks(d, warps, t)
        assert chunks == ([t] if t < rq_plan.n_chunks(d) else [])
        seen += chunks
    assert sorted(seen) == list(range(rq_plan.n_chunks(d)))


def test_rmsnorm_plan_refuses_what_the_kernel_does_not_take():
    """An empty row is refused; a row wider than one chunk a thread is
    taken by the looping kernel at the launch bound's 32 warps."""
    with pytest.raises(ValueError):
        rq_plan.warps_per_row(0)
    assert rq_plan.warps_per_row(rq_plan.MAX_D) == rq_plan.MAX_THREADS // 32
    assert not rq_plan.looped(rq_plan.MAX_D)
    for d in (rq_plan.MAX_D + 1, 16384, 65536):
        assert rq_plan.looped(d)
        assert rq_plan.warps_per_row(d) == rq_plan.MAX_THREADS // 32


@pytest.mark.parametrize("d", WIDE_D_CASES + (rq_plan.MAX_D + 1, 65536 + 3))
def test_rmsnorm_wide_plan_covers_each_chunk_once(d):
    """The looping kernel's partition: 1024 threads, thread t walking
    chunks t, t + 1024, ... in order, every chunk of a row once."""
    warps = rq_plan.warps_per_row(d)
    T = 32 * warps
    assert T == rq_plan.MAX_THREADS
    seen = []
    for t in range(T):
        chunks = rq_plan.thread_chunks(d, warps, t)
        assert chunks == list(range(t, rq_plan.n_chunks(d), T))
        seen += chunks
    assert sorted(seen) == list(range(rq_plan.n_chunks(d)))
    # the kernel's f32(1/d) equals the plain version's rounded 1/d here too
    assert (np.float32(1.0 / d) == np.float32(1) / np.float32(d))


@pytest.mark.parametrize("d", WIDE_D_CASES)
def test_rmsnorm_wide_order_equals_lane_emulation(d):
    """The looping kernel's sum of squares, lane by lane: the replay (the
    plain version's order argument) gives its bits."""
    x, _ = _inputs(d, torch.float32, m=2)
    warps = rq_plan.warps_per_row(d)
    got = rq_plan.sum_of_squares(x, warps)
    for i in range(x.shape[0]):
        want = _lane_emulation(x[i].numpy(), warps)
        assert got[i, 0].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_D_CASES)
def test_rmsnorm_wide_replay_matches_plain_and_jax(d, dtype):
    """A wide row in the looping kernel's order stays within the JAX
    kernel tests' tolerance of the plain version and of the JAX Pallas
    kernel (interpret mode), which takes any width as one block."""
    x, w = _inputs(d, dtype, m=3)
    got = rq_ref.rmsnorm_quant_ref(x, w, warps=rq_plan.warps_per_row(d))
    _assert_quant_close(got, rq_ref.rmsnorm_quant_ref(x, w))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_rq.rmsnorm_quant(jnp.asarray(x.float().numpy()).astype(jdt),
                              jnp.asarray(w.numpy()), interpret=True)
    _assert_quant_close(got, want)


def test_rmsnorm_reciprocal_of_d_rounds_once():
    """The kernel takes f32(1/d) as a correctly rounded f32 reciprocal; the
    plain version as the double 1/d rounded to f32 in its product.  They
    are the same f32 for every d the kernel takes."""
    d = np.arange(1, rq_plan.MAX_D + 1)
    np.testing.assert_array_equal((1.0 / d).astype(np.float32),
                                  np.float32(1) / d.astype(np.float32))


def _lane_emulation(row: np.ndarray, warps: int) -> np.float32:
    """One row's sum of squares as the kernel's threads compute it, lane by
    lane and shuffle by shuffle, in numpy f32 scalars."""
    T = 32 * warps
    d = row.shape[0]
    lanes = []
    for t in range(T):
        acc = np.float32(0)
        for c in rq_plan.thread_chunks(d, warps, t):
            for j in range(rq_plan.CHUNK):
                e = c * rq_plan.CHUNK + j
                v = row[e] if e < d else np.float32(0)
                acc = np.float32(acc + np.float32(v * v))
        lanes.append(acc)
    sums = []
    for w in range(warps):
        lane = lanes[32 * w:32 * (w + 1)]
        for o in (16, 8, 4, 2, 1):
            lane = [np.float32(lane[i] + lane[i ^ o]) for i in range(32)]
        assert len(set(x.tobytes() for x in lane)) == 1   # every lane agrees
        sums.append(lane[0])
    total = sums[0]
    for s in sums[1:]:
        total = np.float32(total + s)
    return total


@pytest.mark.parametrize("warps", [1, 2, 3, 6])
@pytest.mark.parametrize("d", [96, 1000, 1536])
def test_rmsnorm_replay_equals_lane_emulation(d, warps):
    x, _ = _inputs(d, torch.float32, m=3)
    got = rq_plan.sum_of_squares(x, warps)
    for i in range(x.shape[0]):
        want = _lane_emulation(x[i].numpy(), warps)
        assert got[i, 0].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("d", [1, 9, 2048, 4096, rq_plan.MAX_D])
def test_rmsnorm_plan_order_equals_lane_emulation(d):
    """The plan's own warps, one warp to 32, from one value a row to the
    widest row the kernel takes."""
    x, _ = _inputs(d, torch.float32, m=2)
    warps = rq_plan.warps_per_row(d)
    got = rq_plan.sum_of_squares(x, warps)
    for i in range(x.shape[0]):
        want = _lane_emulation(x[i].numpy(), warps)
        assert got[i, 0].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", D_CASES)
def test_rmsnorm_row_alone_equals_its_batch_row(d, dtype):
    """The kernel's order depends on d alone: a row's scale and codes are
    the same bits alone and in batches of m = 1, 4, 5, 128, and the same
    for bf16 x as for its f32 widening."""
    x, w = _inputs(d, dtype)
    warps = rq_plan.warps_per_row(d)
    q_all, s_all = rq_ref.rmsnorm_quant_ref(x, w, warps=warps)
    for m in BATCHES:
        q, s = rq_ref.rmsnorm_quant_ref(x[:m], w, warps=warps)
        assert torch.equal(q, q_all[:m]) and torch.equal(s, s_all[:m])
    for i in (0, 77, 127):
        q, s = rq_ref.rmsnorm_quant_ref(x[i:i + 1], w, warps=warps)
        assert torch.equal(q, q_all[i:i + 1]) and torch.equal(s, s_all[i:i + 1])
    _assert_quant_equal(rq_ref.rmsnorm_quant_ref(x.float(), w, warps=warps),
                        (q_all, s_all))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", D_CASES)
def test_rmsnorm_replay_matches_plain_and_jax(d, dtype):
    x, w = _inputs(d, dtype, m=16)
    got = rq_ref.rmsnorm_quant_ref(x, w, warps=rq_plan.warps_per_row(d))
    _assert_quant_close(got, rq_ref.rmsnorm_quant_ref(x, w))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_rq.rmsnorm_quant(jnp.asarray(x.float().numpy()).astype(jdt),
                              jnp.asarray(w.numpy()), interpret=True)
    _assert_quant_close(got, want)


@pytest.mark.parametrize("d", [96, 1000])
def test_rmsnorm_vector_choice_follows_alignment(d):
    """16-byte loads where x's rows and w start on 16 bytes and d is a
    whole number of chunks; a column slice or a ragged d reads by value."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((5, d + 8), dtype=dtype)
        w = torch.zeros(d + 8, dtype=dtype)

        def ok(t, ww):
            return rq_plan.vector_ok(t.data_ptr(), t.stride(0)
                                     * t.element_size(), ww.data_ptr(),
                                     t.shape[1])
        assert ok(x[:, :d], w[:d])
        assert ok(x[1:, :d], w[:d])           # a row slice stays aligned
        assert not ok(x[:, 1:d + 1], w[:d])   # a column slice does not
        assert not ok(x[:, :d], w[1:d + 1])
        assert not ok(x[:, :d - 1], w[:d - 1])   # d not a multiple of 8
    # a row stride that is not a multiple of 16 bytes
    x = torch.zeros((5, d + 1), dtype=torch.bfloat16)
    assert not rq_plan.vector_ok(x.data_ptr(), x.stride(0) * 2,
                                 x.data_ptr(), d)


# -- swiglu_quant: the partition and the dataflow -------------------------------

def test_swiglu_plan_matches_the_kernel_source():
    src = (CSRC / "swiglu_quant.cu").read_text()
    for name in ("CHUNK", "THREADS", "MAX_THREADS", "KMAX", "MAX_SMEM"):
        assert _constant(src, name) == getattr(sq_plan, name)
    # the static exchange the shared-memory check counts
    assert "__shared__ float red[MAX_THREADS / 32];" in src
    assert "int64_t(sizeof(float)) * (MAX_THREADS / 32) > MAX_SMEM" in src


@pytest.mark.parametrize("f", (1, 4, 5) + F_CASES + WIDE_F_CASES)
def test_swiglu_partition_covers_each_value_once(f):
    t = sq_plan.threads(f)
    assert t % 32 == 0 and t <= sq_plan.MAX_THREADS
    per = -(-sq_plan.n_chunks(f) // t)
    seen = []
    for i in range(t):
        chunks = sq_plan.thread_chunks(f, i)
        assert len(chunks) <= per
        seen += [e for ch in chunks for e in
                 range(ch * sq_plan.CHUNK, (ch + 1) * sq_plan.CHUNK)
                 if e < f]
    assert sorted(seen) == list(range(f))
    assert sq_plan.staged(f) == (f > sq_plan.MAX_REGISTER_F)
    if sq_plan.staged(f):
        assert t == sq_plan.MAX_THREADS
        assert sq_plan.smem_bytes(f) + sq_plan.STATIC_SMEM <= sq_plan.MAX_SMEM
    else:
        assert per <= sq_plan.KMAX
    sq_plan.check(f)


def test_swiglu_plan_choices():
    # THREADS threads while KMAX chunks a thread hold the row, then up to
    # MAX_THREADS, then a staged row of MAX_THREADS threads; wider than
    # shared memory beside the static exchange is refused
    f = sq_plan.CHUNK * sq_plan.THREADS * sq_plan.KMAX
    assert sq_plan.threads(f) == sq_plan.THREADS and not sq_plan.staged(f)
    assert sq_plan.threads(f + 4) > sq_plan.THREADS
    assert not sq_plan.staged(f + 4)
    assert sq_plan.threads(4096) == 512 and sq_plan.threads(2816) == 512
    assert sq_plan.threads(100) == 32
    assert sq_plan.MAX_F == 29040
    assert (sq_plan.smem_bytes(sq_plan.MAX_F + 4) + sq_plan.STATIC_SMEM
            > sq_plan.MAX_SMEM)
    with pytest.raises(ValueError):
        sq_plan.check(0)
    # wider than shared memory: looped, not refused (29568: qwen2-72b's
    # d_ff)
    assert sq_plan.staged(sq_plan.MAX_F) and not sq_plan.looped(sq_plan.MAX_F)
    for f in (sq_plan.MAX_F + 1, 29568, 65536):
        sq_plan.check(f)
        assert sq_plan.looped(f) and not sq_plan.staged(f)
        assert sq_plan.threads(f) == sq_plan.MAX_THREADS


@pytest.mark.parametrize("f", LOOPED_F_CASES)
def test_swiglu_looped_partition_covers_each_value_once(f):
    """The looped row: 1024 threads, thread t walking chunks t, t + 1024,
    ... (each walk twice in the kernel), every value of a row once."""
    t = sq_plan.threads(f)
    assert t == sq_plan.MAX_THREADS and sq_plan.looped(f)
    seen = []
    for i in range(t):
        chunks = sq_plan.thread_chunks(f, i)
        assert chunks == list(range(i, sq_plan.n_chunks(f), t))
        seen += [e for ch in chunks for e in
                 range(ch * sq_plan.CHUNK, (ch + 1) * sq_plan.CHUNK)
                 if e < f]
    assert sorted(seen) == list(range(f))


def _swiglu_replay(gate, up, gs, us):
    """The kernel's dataflow over the plan's partition: h once per value
    (the plain version's operations), each thread's maximum, the block's
    maximum of those, then each thread's codes."""
    m, f = gate.shape
    q = torch.empty((m, f), dtype=torch.int8)
    scale = torch.empty((m, 1), dtype=torch.float32)
    t = sq_plan.threads(f)
    for r in range(m):
        maxima, hs = [], []
        for i in range(t):
            idx = torch.tensor([e for ch in sq_plan.thread_chunks(f, i)
                                for e in range(ch * sq_plan.CHUNK,
                                               (ch + 1) * sq_plan.CHUNK)
                                if e < f], dtype=torch.long)
            g = gate[r, idx].float() * gs[r]
            u = up[r, idx].float() * us[r]
            h = g * (1.0 / (1.0 + torch.exp(-g))) * u
            hs.append((idx, h))
            maxima.append(h.abs().max() if idx.numel() else torch.tensor(0.0))
        amax = torch.stack(maxima).max().clamp_min(1e-5)
        sc = amax * ternary.INV_127
        for idx, h in hs:
            q[r, idx] = torch.clamp(torch.round(h / sc), -127, 127).to(
                torch.int8)
        scale[r, 0] = sc
    return q, scale


def _swiglu_inputs(m, f, seed=0):
    rng = np.random.default_rng(seed + m + f)
    gate = rng.integers(-3000, 3000, size=(m, f)).astype(np.int32)
    up = rng.integers(-3000, 3000, size=(m, f)).astype(np.int32)
    gs = (rng.random((m, 1)) * 1e-3).astype(np.float32)
    us = (rng.random((m, 1)) * 1e-3).astype(np.float32)
    return tuple(map(torch.from_numpy, (gate, up, gs, us)))


@pytest.mark.parametrize("f", (5,) + F_CASES + WIDE_F_CASES
                         + LOOPED_F_CASES[:2])
def test_swiglu_replay_equals_plain(f):
    args = _swiglu_inputs(2, f)
    want = sq_ref.swiglu_quant_ref(*args)
    _assert_quant_equal(_swiglu_replay(*args), want)


@pytest.mark.parametrize("f", F_CASES)
def test_swiglu_plain_matches_jax(f):
    gate, up, gs, us = _swiglu_inputs(4, f)
    want = j_sq.swiglu_quant(*(jnp.asarray(a.numpy())
                               for a in (gate, up, gs, us)), interpret=True)
    _assert_quant_close(sq_ref.swiglu_quant_ref(gate, up, gs, us), want)


def test_swiglu_vector_choice_follows_alignment():
    g = torch.zeros((4, 4100), dtype=torch.int32)
    u = torch.zeros((4, 4100), dtype=torch.int32)

    def ok(a, b):
        return sq_plan.vector_ok((a.data_ptr(), b.data_ptr()),
                                 (4 * a.stride(0), 4 * b.stride(0)),
                                 a.shape[1])
    assert ok(g[:, :4096], u[:, :4096])
    assert not ok(g[:, 1:4097], u[:, :4096])   # a column slice
    assert not ok(g[:, :4096], u[:, 2:4098])
    assert not ok(g[:, :100 - 2], u[:, :100 - 2])   # f not a multiple of 4
    odd = torch.zeros((4, 4097), dtype=torch.int32)[:, :4096]
    assert not ok(odd, u[:, :4096])            # a row stride of 4097 values


# -- the scale: amax * f32(1/127), as the JAX package runs -------------------------

def _split_values(n=4):
    """f32 values a in [0.5, 64) whose quotient a / 127 differs from the
    product a * f32(1/127)."""
    rng = np.random.default_rng(7)
    a = (rng.random(4096).astype(np.float32) * 63.5 + 0.5).astype(np.float32)
    split = a[(a / np.float32(127)) != (a * F32_INV_127)]
    assert split.size >= n
    return split[:n]


def test_reference_scale_is_the_reciprocal_product():
    """JAX's absmax quant, jitted, and both Pallas kernels in interpret
    mode take scale = amax * f32(1/127); eager JAX and torch on the CPU
    divide; the port's kernels' plain versions take the product."""
    a = _split_values()
    prod, quot = a * F32_INV_127, a / np.float32(127)
    x = np.zeros((a.size, 8), np.float32)
    x[:, 0] = a
    x[:, 1] = -a / 3
    jx = jnp.asarray(x)
    _, s_jit = jax.jit(j_ternary.absmax_quant)(jx)
    _, s_eager = j_ternary.absmax_quant(jx)
    np.testing.assert_array_equal(np.asarray(s_jit)[:, 0], prod)
    np.testing.assert_array_equal(np.asarray(s_eager)[:, 0], quot)
    assert np.all(prod != quot)
    # the port's quantizer divides on the CPU, as eager JAX and torch do,
    # and takes the product when asked (the kernels' plain versions)
    _, s = ternary.absmax_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(s[:, 0].numpy(), quot)
    assert np.array_equal((torch.from_numpy(a) / 127.0).numpy(), quot)
    _, s = ternary.absmax_quant(torch.from_numpy(x), reciprocal=True)
    np.testing.assert_array_equal(s[:, 0].numpy(), prod)

    # rmsnorm_quant with eps = 0 on rows of 2s: var = 4, rsqrt = 1/2 and
    # xn = w exactly, so amax is w's largest |value|
    ones = np.full((a.size, 8), 2.0, np.float32)
    for i, v in enumerate(a):
        w = np.full(8, v / 4, np.float32)
        w[3] = v
        want_s = prod[i]
        _, s_k = j_rq.rmsnorm_quant(jnp.asarray(ones[i:i + 1]), jnp.asarray(w),
                                    eps=0.0, interpret=True)
        _, s_r = jax.jit(j_rq_ref.rmsnorm_quant_ref, static_argnums=2)(
            jnp.asarray(ones[i:i + 1]), jnp.asarray(w), 0.0)
        _, s_p = rq_ref.rmsnorm_quant_ref(torch.from_numpy(ones[i:i + 1]),
                                          torch.from_numpy(w), eps=0.0)
        assert np.asarray(s_k)[0, 0] == want_s
        assert np.asarray(s_r)[0, 0] == want_s
        assert s_p[0, 0].item() == want_s

    # swiglu_quant on gate 1000 (sigmoid 1 exactly) with unit scales:
    # h = 1000 * up exactly; up picks amax = 1000 * k
    k = np.arange(1, 16385, dtype=np.float32)
    h = np.float32(1000) * k
    k = k[(h / np.float32(127)) != (h * F32_INV_127)][:4].astype(np.int32)
    gate = np.full((k.size, 8), 1000, np.int32)
    up = np.ones((k.size, 8), np.int32)
    up[:, 5] = k
    sc = np.ones((k.size, 1), np.float32)
    _, s_k = j_sq.swiglu_quant(*map(jnp.asarray, (gate, up, sc, sc)),
                               interpret=True)
    want = (np.float32(1000) * k.astype(np.float32)) * F32_INV_127
    np.testing.assert_array_equal(np.asarray(s_k)[:, 0], want)
    _, s_p = sq_ref.swiglu_quant_ref(*map(torch.from_numpy,
                                          (gate, up, sc, sc)))
    np.testing.assert_array_equal(s_p[:, 0].numpy(), want)


def test_reference_mean_is_the_reciprocal_product():
    """jnp.mean is sum * f32(1/d) (the rmsnorm kernels' variance), torch's
    CPU mean a quotient; the port's plain rmsnorm takes the product.  Rows
    of integers keep the sums exact."""
    d = 96
    rng = np.random.default_rng(3)
    x = rng.integers(-50, 50, (512, d)).astype(np.float32)
    s = (x * x).sum(-1, dtype=np.float64).astype(np.float32)
    prod, quot = s * np.float32(1.0 / d), s / np.float32(d)
    assert np.any(prod != quot)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda v: jnp.mean(v * v, axis=-1))(x)), prod)
    t = torch.from_numpy(x)
    assert np.array_equal((t * t).mean(-1).numpy(), quot)
    got = (t * t).sum(-1) * (1.0 / d)
    assert np.array_equal(got.numpy(), prod)
