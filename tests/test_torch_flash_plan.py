"""The design of the prompt and chunk attention kernel
(``repro_torch/csrc/flash_prefill.cu``) checked on the CPU before the card.

A torch emulation follows the kernel's order: TF32 rounding by bit
arithmetic (as ``cvt.rna.tf32.f32``), each product as three TF32 products
(lo * hi + hi * lo + hi * hi, summed here in f64: the tensor cores' own sum
order is not emulated), the keys of each 16-row query block split across
warps by absolute key tile (``kernels/flash_prefill/plan.py``), an online
softmax per warp in f32 and the warps' log-sum-exp merge in warp order.  It
is held within 2e-5 (the attention tests' tolerance) to the plain versions
(``flash_prefill_ref``, ``flash_chunk_prefill_ref``) and to the JAX Pallas
kernels (interpret mode) at ``chip_smoke.py``'s shapes and at the reduced
shapes of ``test_torch_gpu.py``.  The partition itself is replayed: every
live (query, key) pair is visited by exactly one warp, and a prompt and any
chunking of it give each pair the same key tile and warp.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import ops as j_fp

from repro_torch.kernels.flash_prefill import plan
from repro_torch.kernels.flash_prefill import ref as fp_ref

TOL = dict(atol=2e-5, rtol=2e-5)
NEG_INF = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as the kernel rounds it: to nearest, ties away from
    zero, the 13 low bits cleared (finite values)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    """x -> (hi, lo): hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def product3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's 3xTF32: lo * hi + hi * lo + hi * hi, in f64,
    rounded to f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = torch.float64
    return ((al.to(f) @ bh.to(f) + ah.to(f) @ bl.to(f))
            + ah.to(f) @ bh.to(f)).float()


def emulate(q, k, v, k_new=None, v_new=None, offset=None, window=None):
    """The kernel's order on the CPU.  q: (b, h, t, d) f32; k, v:
    (b, kv_h, S, d) (the prompt's keys, or the cache with the chunk's fresh
    k_new, v_new (b, kv_h, t, d) over [offset, offset + t), offset clamped
    to [0, S - t]) -> (b, h, t, d) f32."""
    b, h, t, d = q.shape
    kv_h, S = k.shape[1], k.shape[2]
    warps, bk = plan.WARPS[d], plan.BK
    scale = torch.tensor(1.0 / float(d) ** 0.5, dtype=torch.float32)
    out = torch.zeros(b, h, t, d)
    for bi in range(b):
        off = 0 if offset is None else int(offset[bi])
        rows_k, rows_v = k[bi].float().clone(), v[bi].float().clone()
        if k_new is not None:
            f0 = min(max(off, 0), S - t)
            rows_k[:, f0:f0 + t], rows_v[:, f0:f0 + t] = k_new[bi], v_new[bi]
        dead = torch.arange(S) >= off + t          # staged as zeros
        rows_k[:, dead], rows_v[:, dead] = 0.0, 0.0
        rows_k = rows_k.repeat_interleave(h // kv_h, dim=0)   # (h, S, d)
        rows_v = rows_v.repeat_interleave(h // kv_h, dim=0)
        for q_row0 in range(0, t, plan.BQ):
            n = min(plan.BQ, t - q_row0)
            qt = torch.zeros(h, plan.BQ, d)
            qt[:, :n] = q[bi, :, q_row0:q_row0 + n]
            qpos = off + q_row0 + torch.arange(plan.BQ)
            tiles = plan.block_tiles(q_row0, t, S, off, window)
            states = []
            for w in range(warps):
                m = torch.full((h, plan.BQ), NEG_INF)
                l = torch.zeros(h, plan.BQ)
                acc = torch.zeros(h, plan.BQ, d)
                for kt in plan.warp_tiles(tiles, w, warps):
                    key = kt * bk + torch.arange(bk)
                    inside = key < S
                    kt_k = torch.zeros(h, bk, d)
                    kt_v = torch.zeros(h, bk, d)
                    kt_k[:, inside] = rows_k[:, key[inside]]
                    kt_v[:, inside] = rows_v[:, key[inside]]
                    live = (key[None] < S) & (key[None] <= qpos[:, None])
                    if window:
                        live &= key[None] > qpos[:, None] - window
                    s = torch.where(live, product3(qt, kt_k.transpose(1, 2))
                                    * scale, NEG_INF)
                    m_new = torch.maximum(m, s.amax(-1))
                    p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + product3(p, kt_v)
                    m = m_new
                states.append((m, l, acc))
            mt = torch.stack([s_[0] for s_ in states]).amax(0)
            num = torch.zeros(h, plan.BQ, d)
            den = torch.zeros(h, plan.BQ)
            for m_w, l_w, acc_w in states:   # in warp order
                e = torch.exp(m_w - mt)
                num = num + acc_w * e[..., None]
                den = den + l_w * e
            o = num / torch.clamp_min(den, 1e-30)[..., None]
            out[bi, :, q_row0:q_row0 + n] = o[:, :n]
    return out


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# -- the arithmetic ----------------------------------------------------------

def test_tf32_rounds_to_nearest_ties_away():
    """Against f64 rounding of the 10-bit mantissa, on random values over
    a wide exponent range and on exact ties of either sign."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 2.0 ** rng.integers(-60, 60, 20000)
         ).astype(np.float32)
    bits = rng.integers(0, 2**23, 2000).astype(np.uint32)
    ties = ((np.uint32(127 + 3) << 23) | (bits & ~np.uint32(0x1FFF))
            | np.uint32(0x1000)).view(np.float32)
    x = np.concatenate([x, ties, -ties, [0.0, -0.0, 1.0, 2.0**-126]]
                       ).astype(np.float32)
    got = tf32(torch.from_numpy(x)).numpy()
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    m, e = np.frexp(np.abs(x.astype(np.float64)))
    ulp = np.ldexp(1.0, e - 11)      # 10 mantissa bits below the leading 1
    want = np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_split_reconstructs_and_bf16_rows_are_exact():
    rng = np.random.default_rng(1)
    x = _normal(rng, 4096) * 10
    hi, lo = split(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2.0**-21).all()
    xb = x.to(torch.bfloat16).float()     # a bf16 cache row
    hb, lb = split(xb)
    assert torch.equal(hb, xb) and not lb.any()


def test_three_products_are_f32_class():
    """A 64-deep dot product (one score, head dim 64) as 3xTF32 against
    f64: within a few f32 ULPs of the sum's magnitude."""
    rng = np.random.default_rng(2)
    a, b = _normal(rng, 64, 64), _normal(rng, 64, 64)
    exact = a.double() @ b.double()
    bound = (a.double().abs() @ b.double().abs()) * 2.0**-20
    assert ((product3(a, b).double() - exact).abs() <= bound).all()
    # one TF32 product alone is not
    one = tf32(a).double() @ tf32(b).double()
    assert ((one - exact).abs() > bound).any()


# -- the kernel's order against the plain versions and JAX --------------------

@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("b,h,kv_h,s,d", [
    (1, 24, 24, 128, 64),     # chip_smoke.py: the oracle's prompt
    (2, 8, 2, 77, 32),        # test_torch_gpu.py's reduced shapes
    (1, 4, 1, 50, 128),
    (1, 2, 1, 5, 64)])
def test_emulated_prompt_matches_plain_and_jax(b, h, kv_h, s, d, window):
    rng = np.random.default_rng(s + d)
    q, k, v = (_normal(rng, b, hh, s, d) for hh in (h, kv_h, kv_h))
    got = emulate(q, k, v, window=window)
    torch.testing.assert_close(
        got, fp_ref.flash_prefill_ref(q, k, v, window=window), **TOL)
    want = np.asarray(j_fp.flash_prefill(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), window=window, bq=64, bkv=64,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


CHUNK_CASES = [
    # chip_smoke.py: one admission wave against a 256-row cache
    (4, 24, 24, 32, 256, 64, [0, 37, 100, 224], None),
    # test_torch_gpu.py's reduced shapes
    (3, 8, 2, 12, 40, 32, [0, 5, 28], 9),
    (2, 4, 4, 20, 64, 128, [44, 3], None),
    (2, 4, 2, 16, 40, 64, [30, 7], None),      # row 0's span clamps
    (2, 4, 2, 20, 70, 64, [3, 50], None),      # a span crosses key 64
    (1, 2, 2, 7, 9, 32, [2], None),            # one tile: warps idle
    (3, 4, 4, 33, 100, 128, [0, 31, 67], 40),
    (2, 6, 3, 17, 130, 64, [120, 60], 50)]     # row 0's span clamps


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kv_h,t,S,d,offsets,window", CHUNK_CASES)
def test_emulated_chunk_matches_plain_and_jax(b, h, kv_h, t, S, d, offsets,
                                              window, cache_dtype):
    rng = np.random.default_rng(t + S + d)
    q = _normal(rng, b, h, t, d)
    k, v = (_normal(rng, b, kv_h, S, d).to(cache_dtype) for _ in range(2))
    k_new, v_new = _normal(rng, b, kv_h, t, d), _normal(rng, b, kv_h, t, d)
    off = torch.tensor(offsets, dtype=torch.int32)
    got = emulate(q, k, v, k_new, v_new, off, window=window)
    torch.testing.assert_close(got, fp_ref.flash_chunk_prefill_ref(
        q, k, v, k_new, v_new, off, window=window), **TOL)
    if any(o + t > S for o in offsets):
        return   # JAX overlays at the offset itself; its rows differ there
    kj, vj = (fp_ref.overlay_chunk(x, y, off).numpy()
              for x, y in ((k, k_new), (v, v_new)))
    want = np.asarray(j_fp.flash_chunk_prefill(
        jnp.asarray(q.numpy()), jnp.asarray(kj), jnp.asarray(vj),
        jnp.asarray(off.numpy()), window=window, bq=32, bkv=64,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- the partition ------------------------------------------------------------

# every warp count the kernel takes (16-key tiles), at every head dim
WARP_COUNTS = range(1, plan.MAX_WARPS + 1)


def visits(t, S, offset, window, warps):
    """(absolute query position, key) -> the (tile, warp) pairs the
    kernel's walk visits it in, for live pairs."""
    seen = collections.defaultdict(list)
    for q_row0 in range(0, t, plan.BQ):
        tiles = plan.block_tiles(q_row0, t, S, offset, window)
        for w in range(warps):
            for kt in plan.warp_tiles(tiles, w, warps):
                for key in range(kt * plan.BK, (kt + 1) * plan.BK):
                    for r in range(q_row0, min(q_row0 + plan.BQ, t)):
                        if plan.live(offset + r, key, S, window):
                            seen[(offset + r, key)].append((kt, w))
    return seen


@pytest.mark.parametrize("warps", WARP_COUNTS)
def test_every_live_pair_visited_once(warps):
    """Prompts and chunks (ragged, windowed, clamped) under every warp count
    the kernel takes: each live pair once, by warp (key // BK) % warps."""
    for d in (32, 64, 128):
        plan.check_warps(d, warps)
    for t, S, offset, window in [(128, 128, 0, None), (77, 77, 0, 16),
                                 (32, 256, 224, None), (20, 70, 50, None),
                                 (7, 9, 2, None), (33, 100, 67, 40),
                                 (17, 130, 113, 50), (1, 40, 39, None)]:
        seen = visits(t, S, offset, window, warps)
        live = {(offset + r, key) for r in range(t) for key in range(S)
                if plan.live(offset + r, key, S, window)}
        assert set(seen) == live, (t, S, offset, window)
        for (_, key), v in seen.items():
            assert v == [(key // plan.BK, (key // plan.BK) % warps)]


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("chunk", [32, 20, 7])
@pytest.mark.parametrize("warps", WARP_COUNTS)
def test_prompt_and_chunking_partitions_agree(warps, chunk, window):
    """A 77-token prompt and its chunks against a 128-row cache: every
    live pair in the same key tile and warp."""
    s, S = 77, 128
    whole = visits(s, s, 0, window, warps)
    parts = {}
    for lo in range(0, s, chunk):
        parts.update(visits(min(chunk, s - lo), S, lo, window, warps))
    assert parts == whole
