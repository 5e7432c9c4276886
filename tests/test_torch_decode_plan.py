"""The design of the decode attention kernel
(``repro_torch/csrc/decode_attention.cu``) checked on the CPU before the
card.

The partition is replayed from ``kernels/decode_attention/plan.py``: every
live key of every slot is visited exactly once, by one warp, and which warp
visits a key depends on the slot's own length and the head dim alone, never on the batch, the cache's row count, the page size or
the other slots' lengths (so a slot's output is the same bits decoded alone
or in a ragged batch).

A torch emulation follows the kernel's order in f32: per warp an online
softmax over its 32-key tiles (dead keys staged as zeros, masked scores
-1e30, P.V over the tile's rows up to its last live key), then the warps'
merge in warp order.  Scores
and P.V are taken as torch products, not in the kernel's own accumulation
order.  It is held within 2e-5 (the attention tests' tolerance; 1e-5 for
int8, the JAX int8 kernel's own) to ``decode_attention_ref`` and its paged
forms and to the JAX Pallas decode kernels (interpret mode), at
``chip_smoke.py``'s shapes and the reduced shapes of ``test_torch_gpu.py``,
for the contiguous, paged and paged int8 forms; int8 values are dequantized
with the kernel's bf16 rounding.
"""

import collections
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as j_da

from repro_torch.kernels.decode_attention import plan
from repro_torch.kernels.decode_attention import ref as da_ref

TOL = dict(atol=2e-5, rtol=2e-5)
INT8_TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30

# the warp counts the kernel takes at its head dims, each once: warps -> a
# head dim it serves
PLANS = {w: d for d, w in sorted(plan.PLAN.items(), reverse=True)}
KERNEL_SRC = (pathlib.Path(__file__).resolve().parents[1] / "src"
              / "repro_torch" / "csrc" / "decode_attention.cu")


# -- the plan and the partition -----------------------------------------------

@pytest.mark.parametrize("d", sorted(plan.PLAN))
def test_plan_fits_the_kernel(d):
    """Each head dim's warp count is one the kernel launches for every
    element type it reads, within the kernel's own limits (its source's
    MAX_WARPS and MAX_SMEM); one warp more than fits is refused."""
    src = KERNEL_SRC.read_text()
    for name in ("MAX_WARPS", "MAX_SMEM"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1)) == getattr(plan, name)
    plan.check_plan(d, plan.PLAN[d])
    most = max(w for w in range(1, plan.MAX_WARPS + 1)
               if all(plan.smem_bytes(d, kb, w) <= plan.MAX_SMEM
                      for kb in plan.KV_BYTES))
    assert plan.PLAN[d] <= most
    with pytest.raises(ValueError):
        plan.check_plan(d, most + 1)


def visits(cache_len, S, window, warps):
    """key -> the warps whose tiles hold it, for live keys."""
    seen = collections.defaultdict(list)
    tiles = plan.slot_tiles(cache_len, S, window)
    for w in range(warps):
        for kt in plan.unit_tiles(tiles, w, warps):
            for key in range(kt * plan.TK, (kt + 1) * plan.TK):
                if plan.live(key, cache_len, S, window):
                    seen[key].append(w)
    return dict(seen)


def batch_visits(lens, S, window, d, ps=None):
    """Each slot's visits in one launch of a batch: b = len(lens), a
    contiguous cache of S rows or a paged one of ceil(S / ps) pages."""
    rows = S if ps is None else -(-S // ps) * ps
    return [visits(n, rows, window, plan.PLAN[d]) for n in lens]


@pytest.mark.parametrize("warps", sorted(PLANS))
def test_every_live_key_visited_once(warps):
    plan.check_plan(PLANS[warps], warps)
    for cache_len, S, window in [(1, 256, None), (77, 256, None),
                                 (200, 256, None), (256, 256, None),
                                 (257, 256, None), (0, 48, None),
                                 (300, 300, None), (129, 300, 33),
                                 (70, 70, 33), (33, 48, 33), (1000, 1024, 100)]:
        seen = visits(cache_len, S, window, warps)
        lo = max(0, cache_len - window) if window else 0
        assert set(seen) == set(range(lo, min(cache_len, S)))
        for key, units in seen.items():
            assert units == [(key // plan.TK) % warps]


@pytest.mark.parametrize("d", sorted(plan.PLAN))
def test_partition_is_batch_invariant(d):
    """Slot 0 (77 keys) and slot 1 (200 keys, window 100 or none) are
    visited alike alone, in ragged batches, at other S and page sizes."""
    for window in (None, 100):
        alone = [batch_visits([n], 256, window, d)[0] for n in (77, 200)]
        for lens, S, ps in [([77, 200, 1, 256], 256, None),
                            ([77, 200], 1024, None), ([77, 200, 5], 256, 16),
                            ([77, 200, 300, 0], 300, 5),
                            ([77, 200, 199], 260, 4)]:
            got = batch_visits(lens, S, window, d, ps)
            assert got[:2] == alone


# -- the kernel's order -------------------------------------------------------

def emulate(q, k, v, cache_len, window=None):
    """The kernel's order on the CPU.  q: (b, h, 1, d) f32; k, v:
    (b, kv_h, S, d) f32 values as the kernel widens them (int8 already
    dequantized); cache_len: (b,) -> (b, h, 1, d) f32."""
    b, h, _, d = q.shape
    kv_h, S = k.shape[1], k.shape[2]
    warps = plan.PLAN[d]
    scale = torch.tensor(1.0 / float(d) ** 0.5, dtype=torch.float32)
    out = torch.zeros(b, h, 1, d)
    for bi in range(b):
        n = int(cache_len[bi])
        rows_k = k[bi].float().repeat_interleave(h // kv_h, dim=0)  # (h, S, d)
        rows_v = v[bi].float().repeat_interleave(h // kv_h, dim=0)
        qb = q[bi, :, 0]                                             # (h, d)
        tiles = plan.slot_tiles(n, S, window)
        states = []
        for w in range(warps):
            m = torch.full((h,), NEG_INF)
            l = torch.zeros(h)
            acc = torch.zeros(h, d)
            for kt in plan.unit_tiles(tiles, w, warps):
                key = kt * plan.TK + torch.arange(plan.TK)
                live = torch.tensor([plan.live(int(j), n, S, window)
                                     for j in key])
                kt_k = torch.zeros(h, plan.TK, d)
                kt_v = torch.zeros(h, plan.TK, d)
                kt_k[:, live] = rows_k[:, key[live]]
                kt_v[:, live] = rows_v[:, key[live]]
                s = torch.einsum("hd,hjd->hj", qb, kt_k) * scale
                s = torch.where(live, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.where(live, torch.exp(s - m_new[:, None]), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                jn = min(plan.TK, n - kt * plan.TK)
                acc = acc * alpha[:, None] + torch.einsum(
                    "hj,hjd->hd", p[:, :jn], kt_v[:, :jn])
                m = m_new
            states.append((m, l, acc))
        m, l, acc = merge(states)
        out[bi, :, 0] = acc * (1.0 / torch.clamp_min(l, 1e-30))[:, None]
    return out


def merge(states):
    """(m, l, acc) states -> one, by log-sum-exp in the given order."""
    mt = torch.stack([s[0] for s in states]).amax(0)
    lt = torch.zeros_like(mt)
    o = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        c = torch.exp(m - mt)
        lt = lt + l * c
        o = o + acc * c[:, None]
    return mt, lt, o


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _table(rng, b, S, ps):
    """A shuffled (b, ceil(S / ps)) int32 block table over pages 1.."""
    n = -(-S // ps)
    return torch.from_numpy((rng.permutation(b * n) + 1).reshape(b, n)
                            .astype(np.int32))


def _pool(rows, bt, ps, fill):
    """rows (b, S, ...) -> a (1 + bt.numel(), ps, ...) pool holding row i's
    positions in pages bt[i], ``fill`` in page 0 and every slack row."""
    b, S = rows.shape[:2]
    n, tail = bt.shape[1], tuple(rows.shape[2:])
    pool = fill((1 + b * n, ps) + tail)
    pad = torch.cat([rows, fill((b, n * ps - S) + tail)], dim=1)
    pool[bt.long()] = pad.reshape((b, n, ps) + tail)
    return pool


def _jax(fn, *args):
    return torch.from_numpy(np.array(fn(
        *(jnp.asarray(a.numpy()) if a.dtype != torch.bfloat16
          else jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
          for a in args), interpret=True)))


# (b, h, kv_h, S, d, lens, window): chip_smoke.py's phase-3 tick and the
# oracle's single slot, then test_torch_gpu.py's reduced shapes
DECODE_CASES = [
    (4, 24, 24, 256, 64, [1, 77, 200, 256], None),
    (1, 24, 24, 256, 64, [77], None),
    (1, 24, 24, 256, 64, [200], None),
    (4, 24, 24, 256, 64, [1, 77, 200, 257], 33),
    (3, 8, 2, 48, 32, [0, 17, 48], None),
    (3, 8, 2, 48, 32, [0, 17, 48], 33),
    (2, 4, 1, 300, 128, [300, 129], None),
    (2, 4, 1, 300, 128, [300, 129], 33)]


@pytest.mark.parametrize("b,h,kv_h,S,d,lens,window", DECODE_CASES)
def test_emulated_decode_matches_plain_and_jax(b, h, kv_h, S, d, lens,
                                               window):
    """A bf16 cache, as on the serving path; JAX has no windowed kernel."""
    rng = np.random.default_rng(S + d + b)
    q = _normal(rng, b, h, 1, d)
    k, v = (_normal(rng, b, kv_h, S, d).to(torch.bfloat16) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32)
    got = emulate(q, k, v, cl, window)
    torch.testing.assert_close(
        got, da_ref.decode_attention_ref(q, k, v, cl, window=window), **TOL)
    if window is None:
        want = _jax(j_da.decode_attention, q, k, v, cl.clamp(max=S))
        torch.testing.assert_close(got, want, **TOL)


# (b, h, kv_h, S, d, lens, page size): the phase-3 tick at both page sizes
# against the plain versions; JAX's paged kernels at the reduced shapes
PAGED_CASES = [
    (4, 24, 24, 256, 64, [1, 77, 200, 256], 16, False),
    (4, 24, 24, 256, 64, [1, 77, 200, 256], 5, False),
    (3, 8, 2, 48, 32, [0, 17, 48], 5, True),
    (2, 4, 1, 70, 128, [70, 33], 16, True)]


@pytest.mark.parametrize("b,h,kv_h,S,d,lens,ps,with_jax", PAGED_CASES)
def test_emulated_paged_decode_matches_plain_and_jax(b, h, kv_h, S, d, lens,
                                                     ps, with_jax):
    """Shuffled pages with garbage in the null page and slack rows: the
    emulation reads the slot's rows, the plain versions the pool."""
    rng = np.random.default_rng(S + ps)
    q = _normal(rng, b, h, 1, d)
    k, v = (_normal(rng, b, S, kv_h, d).to(torch.bfloat16) for _ in range(2))

    def junk(shape):
        return (_normal(rng, *shape) * 100).to(torch.bfloat16)

    bt = _table(rng, b, S, ps)
    kp, vp = _pool(k, bt, ps, junk), _pool(v, bt, ps, junk)
    cl = torch.tensor(lens, dtype=torch.int32)
    got = emulate(q, k.transpose(1, 2), v.transpose(1, 2), cl)
    torch.testing.assert_close(got, da_ref.paged_decode_attention_ref(
        q, kp, vp, bt, cl), **TOL)
    if with_jax:
        torch.testing.assert_close(got, _jax(j_da.decode_attention_paged, q,
                                             kp, vp, bt, cl), **TOL)


@pytest.mark.parametrize("b,h,kv_h,S,d,lens,ps,with_jax", PAGED_CASES)
def test_emulated_paged_int8_decode_matches_plain_and_jax(
        b, h, kv_h, S, d, lens, ps, with_jax):
    """int8 pools and f32 scale planes: the emulation reads each value as
    the kernel dequantizes it, f32(bf16(f32(int8) * bf16(scale)))."""
    rng = np.random.default_rng(S + ps + 1)
    q = _normal(rng, b, h, 1, d)

    def ints(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape)
                                .astype(np.int8))

    def scales(shape):
        return torch.from_numpy((rng.random(shape) * 0.05)
                                .astype(np.float32))

    k, v = ints((b, S, kv_h, d)), ints((b, S, kv_h, d))
    ks, vs = scales((b, S, kv_h)), scales((b, S, kv_h))
    bt = _table(rng, b, S, ps)
    kp, vp = _pool(k, bt, ps, ints), _pool(v, bt, ps, ints)
    ksp, vsp = _pool(ks, bt, ps, scales), _pool(vs, bt, ps, scales)
    cl = torch.tensor(lens, dtype=torch.int32)
    kd, vd = da_ref.dequant_bf16(k, ks), da_ref.dequant_bf16(v, vs)
    got = emulate(q, kd.transpose(1, 2), vd.transpose(1, 2), cl)
    torch.testing.assert_close(got, da_ref.paged_decode_attention_quant_ref(
        q, kp, vp, ksp, vsp, bt, cl), **INT8_TOL)
    if with_jax:
        torch.testing.assert_close(got, _jax(
            j_da.decode_attention_paged_quant, q, kp, vp, ksp, vsp, bt, cl),
            **INT8_TOL)


def test_emulated_slot_alone_equals_slot_in_batch():
    """Invariant 7 in the emulation: a slot's row decoded alone, at another
    S, equals its row in a ragged batch, bit for bit."""
    rng = np.random.default_rng(9)
    q = _normal(rng, 4, 24, 1, 64)
    k, v = (_normal(rng, 4, 24, 300, 64) for _ in range(2))
    cl = torch.tensor([1, 77, 200, 256], dtype=torch.int32)
    batch = emulate(q, k[:, :, :256], v[:, :, :256], cl)
    for i in range(4):
        alone = emulate(q[i:i + 1], k[i:i + 1], v[i:i + 1], cl[i:i + 1])
        assert torch.equal(alone, batch[i:i + 1])
