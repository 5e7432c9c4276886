"""The launch plans of the port's two ternary matmul kernels
(``repro_torch/kernels/tlmm/plan.py``), on the CPU.

A plan cuts the (row, column, group) space into blocks: every point must
lie in exactly one block and no block may be empty, for the regimes' edge
sizes of m, the three ternary linears of bitnet-0.73b, ragged shapes, every
group size and a full (132 SMs) and a small (7) card.  A plain replay of a
plan's partition, block by block in the plan's split order, must give the
int32 sums of the port's ``tlmm_ref`` and of the JAX package's ``tlmm_ref``
on the same numpy inputs (compared with ``torch.equal``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tlmm import ref as j_ref

from repro_torch.core import ternary
from repro_torch.kernels.tlmm import plan as tp
from repro_torch.kernels.tlmm import ref as tlmm_ref

MS = (1, 4, 16, 17, 73, 128, 130)
# (n, k): the three linears of bitnet-0.73b, then k not a multiple of 4
SHAPES = ((1536, 1536), (1536, 4096), (4096, 1536), (165, 130), (96, 300))
PLANS = {"tlmm": tp.plan_tlmm, "tlmm_lut": tp.plan_tlmm_lut}


def _cover(axis_len, intervals):
    """How often each index of [0, axis_len) lies in one of the distinct
    intervals."""
    count = np.zeros(axis_len, dtype=np.int64)
    for lo, hi in set(intervals):
        count[lo:hi] += 1
    return count


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_plan_covers_every_point_once(kernel, g, sms):
    for m in MS:
        for n, k in SHAPES:
            p = PLANS[kernel](m, n, k, g, sms)
            n_groups = -(-n // g)
            assert p.n_groups == n_groups
            blocks = list(p.blocks())
            gx, gy, gz = p.grid
            assert len(blocks) == gx * gy * gz == len(set(blocks))
            for r0, r1, c0, c1, z0, z1 in blocks:
                assert 0 <= r0 < r1 <= m and 0 <= c0 < c1 <= k
                assert 0 <= z0 < z1 <= n_groups, (m, n, k, p)
            # distinct products of partitions of each axis, whose volumes
            # sum to the whole: every (row, column, group) exactly once
            for axis, length in ((0, m), (2, k), (4, n_groups)):
                assert (_cover(length, [b[axis:axis + 2] for b in blocks])
                        == 1).all(), (axis, m, n, k, p)
            assert sum((r1 - r0) * (c1 - c0) * (z1 - z0)
                       for r0, r1, c0, c1, z0, z1 in blocks) == m * k * n_groups
            # what each kernel takes
            if p.kernel == "dp4a":
                assert m <= tp.DECODE_MAX_M and p.rows in tp.DECODE_ROWS
                assert p.rows >= m and p.cols == tp.DECODE_COLS
            elif p.kernel == "mma":
                assert m > tp.DECODE_MAX_M and p.per % tp.MMA_STEP == 0
                assert (p.rows, p.cols) == (tp.MMA_ROWS, tp.MMA_COLS)
            else:
                assert p.rows in tp.LUT_ROWS and p.cols == tp.LUT_COLS
            assert p.atomic == (p.split > 1)


def _replay(p, a, wt, g, n):
    """The plan's partition summed block by block in its split order, each
    block's partial sum over its groups' reduction indices below n."""
    out = torch.zeros((p.m, p.k), dtype=torch.int32)
    for r0, r1, c0, c1, z0, z1 in p.blocks():
        i0, i1 = z0 * g, min(z1 * g, n)
        out[r0:r1, c0:c1] += ternary.ternary_matmul_ref(
            a[r0:r1, i0:i1], wt[i0:i1, c0:c1])
    return out


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("m,n,k,g", [
    (1, 1536, 1536, 5), (4, 165, 130, 5), (16, 96, 300, 3), (17, 165, 130, 5),
    (73, 1536, 257, 5), (130, 96, 300, 2), (128, 300, 64, 4)])
def test_plan_replay_equals_tlmm_ref(kernel, sms, m, n, k, g):
    rng = np.random.default_rng(m + n + k + g)
    a_np = rng.integers(-128, 128, size=(m, n)).astype(np.int8)
    w_np = rng.integers(-1, 2, size=(n, k)).astype(np.int8)
    a, w = torch.from_numpy(a_np), torch.from_numpy(w_np)
    codes = ternary.pack_ternary(w, g, 8)
    p = PLANS[kernel](m, n, k, g, sms)
    wt = ternary.unpack_ternary(codes, g, n)
    got = _replay(p, a, wt, g, n)
    assert torch.equal(got, tlmm_ref.tlmm_ref(a, codes, g, n))
    want_jax = j_ref.tlmm_ref(jnp.asarray(a_np), jnp.asarray(codes.numpy()),
                              g, n)
    assert torch.equal(got, torch.from_numpy(np.array(want_jax)))


@pytest.mark.parametrize("kernel,m,n,k,g,step", [
    # tests/test_torch_gpu.py's TLMM_PARTIAL_STEP: the mma kernel walks
    # MMA_STEP code rows a step
    ("tlmm", 73, 1536, 1536, 5, tp.MMA_STEP),
    # its LUT_PARTIAL_STEP at g = 5: tlmm_lut.cu builds 16 groups' tables
    # a step (group_step(5))
    ("tlmm_lut", 128, 1536, 4096, 5, 16)])
def test_gpu_test_shapes_split_inside_a_step(kernel, m, n, k, g, step):
    p = PLANS[kernel](m, n, k, g, 132)
    assert p.split > 1
    assert any((z1 - z0) % step for *_, z0, z1 in p.blocks())
