"""The port's paged KV cache and int8 KV: storage, model entry points and
engine, against the JAX package and against the port's own contiguous
cache.

What is held:
  * storage — ``paged_update_kv_cache`` / ``paged_update_kv_scales`` write
    the pools as JAX's functions do, bit for bit, and gathering the pages
    back gives the contiguous rows; dead writes land in the null page only;
  * model — ``prefill_chunk`` / ``decode_step`` with ``page_table`` against
    JAX's on the same packed weights (JAX on its Pallas attention, interpret
    mode) within ``LOGIT_TOL``, and against the port's own contiguous cache
    with equal bits, in bf16 and int8 KV;
  * engine — the paged engine emits the contiguous engine's tokens exactly
    (page sizes that divide nothing, slot reuse, page recycling, deferred
    admission), paged int8 KV emits contiguous int8 KV's, and both agree
    with the oracle and with JAX's paged engine up to a printed near-tie.

Two of the reference's own tests fail on this host (JAX 0.9.0, CPU), with
XLA attention on both engines: ``test_paged.py::
test_paged_kv8_engine_matches_contiguous_kv8[False]`` (one request's last
token: paged [27, 68, 27, 68, 40], contiguous [27, 68, 27, 68, 27]) and
``test_paged_slot_recycling_no_stale_leak`` (paged [40, 88] against the
oracle's [40, 123]).  So nothing here copies an exact expectation across
frameworks: tokens against JAX are judged by the oracle's logit gap, and
exact equality is held only within the port, where paged and contiguous
attention take keys in the same tiles and order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.kernels.decode_attention.ref import gather_pages_ref
from repro_torch.models import attention, transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving import Request, RequestStatus, ServingEngine
from repro_torch.serving.engine import _PagePool, reference_decode

LOGIT_TOL = 2e-3   # as tests/test_torch_model.py: framework ULPs through int8
NEAR_TIE = 1e-2


@pytest.fixture(scope="module")
def served():
    j_cfg = j_get_config("qwen1.5-0.5b").reduced()
    cfg = get_config("qwen1.5-0.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    j_ctx = JCtx(mode="packed", group_size=j_cfg.group_size,
                 attn_impl="pallas")
    return j_cfg, packed, j_ctx, cfg, ours


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

def test_page_pool_allocator():
    pool = _PagePool(6)
    assert pool.usable == 5 and pool.free_pages == 5 and pool.used_pages == 0
    a = pool.alloc(3)
    assert len(set(a)) == 3 and 0 not in a   # the null page is never issued
    assert pool.used_pages == 3
    pool.free(a[:2])
    assert pool.free_pages == 4
    b = pool.alloc(4)
    assert 0 not in b and not set(b) & {a[2]}   # an owned page is not reissued
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(1)
    with pytest.raises(RuntimeError, match="double free"):
        pool.free(a[:1] + a[:1])
    with pytest.raises(ValueError):
        _PagePool(1)   # no room for the null page and one real page


def test_paged_update_matches_jax_and_contiguous_rows():
    """Writes through (block table, offset) equal JAX's bit for bit and
    gather back to the contiguous rows; a masked row and positions past the
    table land in the null page only."""
    b, t, kv_h, d, ps, n = 3, 4, 2, 8, 4, 3
    P = 1 + b * n
    rng = np.random.default_rng(0)
    k_new = rng.standard_normal((b, t, kv_h, d)).astype(np.float32)
    s_new = rng.random((b, t, kv_h)).astype(np.float32)
    bt = np.arange(1, P, dtype=np.int32).reshape(b, n)
    pos = np.asarray([0, 3, 9], np.int32)     # row 1 straddles a page
    mask = np.asarray([True, True, False])
    tt = torch.from_numpy
    kp, vp = torch.zeros(P, ps, kv_h, d), torch.zeros(P, ps, kv_h, d)
    attention.paged_update_kv_cache(kp, vp, tt(k_new), tt(2 * k_new), tt(bt),
                                    tt(pos), tt(mask))
    sp, sp2 = torch.zeros(P, ps, kv_h), torch.zeros(P, ps, kv_h)
    attention.paged_update_kv_scales(sp, sp2, tt(s_new), tt(s_new), tt(bt),
                                     tt(pos), tt(mask))
    j_kp, _ = j_attn.paged_update_kv_cache(
        jnp.zeros((P, ps, kv_h, d)), jnp.zeros((P, ps, kv_h, d)),
        jnp.asarray(k_new), jnp.asarray(2 * k_new), jnp.asarray(bt),
        jnp.asarray(pos), write_mask=jnp.asarray(mask))
    j_sp, _ = j_attn.paged_update_kv_scales(
        jnp.zeros((P, ps, kv_h)), jnp.zeros((P, ps, kv_h)),
        jnp.asarray(s_new), jnp.asarray(s_new), jnp.asarray(bt),
        jnp.asarray(pos), write_mask=jnp.asarray(mask))
    # the null page takes the masked row's writes, in an order neither
    # framework fixes: compare the owned pages
    np.testing.assert_array_equal(kp[1:].numpy(), np.asarray(j_kp)[1:])
    np.testing.assert_array_equal(sp[1:].numpy(), np.asarray(j_sp)[1:])
    ref = np.zeros((b, n * ps, kv_h, d), np.float32)
    for i in range(2):
        ref[i, pos[i]:pos[i] + t] = k_new[i]
    np.testing.assert_array_equal(
        gather_pages_ref(kp, tt(bt)).numpy(), ref.transpose(0, 2, 1, 3))
    assert kp[0].any() and not kp[tt(bt[2]).long()].any()
    # a position past the table goes to the null page too
    before = kp.clone()
    attention.paged_update_kv_cache(kp, vp, tt(k_new), tt(k_new), tt(bt),
                                    tt(np.asarray([n * ps, 0, 0], np.int32)))
    assert torch.equal(kp[tt(bt[0]).long()], before[tt(bt[0]).long()])


def test_kv8_cache_layouts_match_jax(served):
    j_cfg, _, _, cfg, _ = served
    for j_cache, cache in (
            (jtf.init_cache(j_cfg, 2, 12, jnp.bfloat16, kv_quant=True),
             transformer.init_cache(cfg, 2, 12, torch.bfloat16, "cpu",
                                    kv_quant=True)),
            (jtf.init_paged_cache(j_cfg, 8, 4, jnp.bfloat16, kv_quant=True),
             transformer.init_paged_cache(cfg, 8, 4, torch.bfloat16, "cpu",
                                          kv_quant=True))):
        assert sorted(cache) == sorted(j_cache) == ["k", "k_scale", "v",
                                                    "v_scale"]
        for name, plane in cache.items():
            assert tuple(plane.shape) == j_cache[name].shape
            assert str(plane.dtype).split(".")[-1] == str(j_cache[name].dtype)
    with pytest.raises(NotImplementedError):
        transformer.init_paged_cache(
            dataclasses.replace(cfg, block_kind="xlstm_pair"), 8, 4,
            device="cpu")


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------

MAX_SEQ, PS, SLOTS = 16, 5, 3      # 16 is no whole number of 5-token pages
TABLE = np.asarray([[7, 3, 9, 5], [0, 0, 0, 0], [2, 11, 4, 8]], np.int32)


def _schedule(vocab):
    """Three admission waves of 4-token chunks (rows 0 and 2 admit a 9- and
    a 6-token prompt, row 1 idles) and one decode step with row 1 parked
    at max_seq: (waves, decode tokens, decode lengths)."""
    rng = np.random.default_rng(6)
    p0, p2 = rng.integers(0, vocab, 9), rng.integers(0, vocab, 6)
    waves = []
    for lo, rows in ((0, (0, 2)), (4, (0, 2)), (8, (0,))):
        toks = np.zeros((SLOTS, 4), np.int64)
        last = np.zeros(SLOTS, np.int32)
        for i, p in ((0, p0), (2, p2)):
            if i in rows:
                seg = p[lo:lo + 4]
                toks[i, :len(seg)] = seg
                last[i] = len(seg) - 1
        waves.append(dict(toks=toks, rows=rows, kw=dict(
            offsets=np.asarray([lo if i in rows else 0 for i in range(SLOTS)],
                               np.int32),
            admit_mask=np.asarray([i in rows for i in range(SLOTS)]),
            last_index=last)))
    step = rng.integers(0, vocab, (SLOTS, 1))
    return waves, step, np.asarray([9, MAX_SEQ, 6], np.int32)


def _port_run(cfg, ours, cache, page_table):
    """The schedule through the port -> [(logits, rows)] per call."""
    waves, step, lens = _schedule(cfg.vocab_size)
    tt = torch.from_numpy
    out = []
    for w in waves:
        logits, _ = transformer.prefill_chunk(
            cfg, ours, tt(w["toks"]), Ctx(), cache,
            **{k: tt(v) for k, v in w["kw"].items()}, page_table=page_table)
        out.append((logits, w["rows"]))
    logits, _ = transformer.decode_step(cfg, ours, tt(step), Ctx(), cache,
                                        tt(lens), page_table=page_table)
    out.append((logits, (0, 2)))
    return out


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_model_matches_jax(served, kv_quant):
    j_cfg, packed, j_ctx, cfg, ours = served
    P = 1 + SLOTS * TABLE.shape[1]
    got = _port_run(cfg, ours, transformer.init_paged_cache(
        cfg, P, PS, torch.bfloat16, "cpu", kv_quant=kv_quant),
        torch.from_numpy(TABLE))
    waves, step, lens = _schedule(cfg.vocab_size)
    j_cache = jtf.init_paged_cache(j_cfg, P, PS, jnp.bfloat16,
                                   kv_quant=kv_quant)
    want = []
    for w in waves:
        logits, j_cache = jtf.prefill_chunk(
            j_cfg, packed, jnp.asarray(w["toks"]), j_ctx, j_cache,
            **{k: jnp.asarray(v) for k, v in w["kw"].items()},
            page_table=jnp.asarray(TABLE))
        want.append(logits)
    logits, _ = jtf.decode_step(j_cfg, packed, jnp.asarray(step), j_ctx,
                                j_cache, jnp.asarray(lens),
                                page_table=jnp.asarray(TABLE))
    want.append(logits)
    for (g, rows), w in zip(got, want):
        for i in rows:
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w)[i],
                                       atol=LOGIT_TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_model_equals_contiguous(served, kv_quant):
    """Same calls on a contiguous cache and on shuffled pages of 5 tokens
    (a table 20 positions wide against 16 rows): equal logits, bit for
    bit, in bf16 and in int8 KV."""
    _, _, _, cfg, ours = served
    paged = _port_run(cfg, ours, transformer.init_paged_cache(
        cfg, 1 + SLOTS * TABLE.shape[1], PS, torch.bfloat16, "cpu",
        kv_quant=kv_quant), torch.from_numpy(TABLE))
    contig = _port_run(cfg, ours, transformer.init_cache(
        cfg, SLOTS, MAX_SEQ, torch.bfloat16, "cpu", kv_quant=kv_quant), None)
    for (p, rows), (c, _) in zip(paged, contig):
        assert torch.equal(p[list(rows)], c[list(rows)])


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _mixed(n=4):
    """The reference's mixed ragged requests (tests/test_paged.py), and two
    more."""
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7],
               [4, 4, 2, 1, 1, 3, 2, 5, 6, 1, 7, 2, 3], [5, 1],
               [3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4]]
    news = [6, 3, 7, 5, 4, 2]
    return [Request(prompt=np.asarray(p), max_new_tokens=m)
            for p, m in zip(prompts[:n], news[:n])]


def _serve(cfg, ours, reqs, **kw):
    args = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=8,
                device="cpu")
    args.update(kw)
    eng = ServingEngine(cfg, ours, **args)
    eng.run(reqs)
    return eng


def _oracle_gap(cfg, ours, r, max_seq=32):
    """The teacher-forced oracle's largest logit gap to the engine's
    tokens (0 where they agree)."""
    _, gaps = reference_decode(cfg, ours, Ctx(), r.prompt, len(r.output),
                               max_seq, follow=r.output)
    return max(gaps)


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_paged_engine_token_identical(served, page_size):
    """4 requests over 3 slots (slot reuse), page sizes 4, 5 (divides
    neither the 32-key tile nor max_seq) and 16: the contiguous engine's
    tokens exactly, the oracle's up to a near-tie, pages all returned."""
    _, _, _, cfg, ours = served
    base = _mixed()
    _serve(cfg, ours, base)
    reqs = _mixed()
    eng = _serve(cfg, ours, reqs, paged=True, page_size=page_size)
    for r, c in zip(reqs, base):
        assert r.output.tolist() == c.output.tolist()
        assert _oracle_gap(cfg, ours, r) < NEAR_TIE
    st = eng.stats
    assert st["kv_page_size"] == page_size
    assert st["kv_pool_pages"] == 3 * (-(-32 // page_size))
    assert 0 < st["kv_pages_peak"] <= st["kv_pool_pages"]
    assert st["kv_pages_in_use"] == 0
    assert st["kv_pages_peak"] * page_size < 3 * 32
    assert st["kv_pages_peak"] * page_size >= st["kv_live_tokens_peak"]
    assert st["admissions_deferred_pages"] == 0


def test_paged_slot_recycling_no_stale_leak(served):
    """10 usable 4-token pages for 2 slots (contiguous would hold 16):
    recycled pages hold their last owner's KV and are never attended.
    (The reference's test of this name fails on this host, see the module
    docstring; here the contiguous engine and the oracle's gap judge.)"""
    _, _, _, cfg, ours = served
    rng = np.random.default_rng(7)

    def reqs():
        return [Request(prompt=rng.integers(1, cfg.vocab_size,
                                            size=int(rng.integers(2, 12))),
                        max_new_tokens=int(rng.integers(2, 7)))
                for _ in range(6)]

    state = rng.bit_generator.state
    paged_reqs = reqs()
    rng.bit_generator.state = state
    contig_reqs = reqs()
    eng = _serve(cfg, ours, paged_reqs, batch_slots=2, decode_block=4,
                 paged=True, page_size=4, kv_pages=11)
    _serve(cfg, ours, contig_reqs, batch_slots=2, decode_block=4)
    assert eng.stats["kv_pages_peak"] <= 10
    assert eng.stats["kv_pages_in_use"] == 0
    for r, c in zip(paged_reqs, contig_reqs):
        assert r.output.tolist() == c.output.tolist()
        assert _oracle_gap(cfg, ours, r) < NEAR_TIE


def test_paged_admission_defers_until_pages_free(served):
    """Worst cases at page size 4 are 3, 2, 5 and 2 pages; 5 usable pages
    admit the large request only alone, so admission defers (FIFO) and
    every request still finishes with the contiguous engine's tokens."""
    _, _, _, cfg, ours = served
    base = _mixed()
    _serve(cfg, ours, base, decode_block=4)
    reqs = _mixed()
    eng = _serve(cfg, ours, reqs, decode_block=4, paged=True, page_size=4,
                 kv_pages=6)
    assert [eng.worst_case_pages(r) for r in reqs] == [3, 2, 5, 2]
    st = eng.stats
    assert st["admissions_deferred_pages"] > 0
    assert st["kv_pages_peak"] <= 5 and st["kv_reserved_pages_peak"] <= 5
    assert st["kv_pages_in_use"] == 0
    for r, c in zip(reqs, base):
        assert r.done and r.output.tolist() == c.output.tolist()


def test_paged_engine_refuses_what_cannot_run(served):
    _, _, _, cfg, ours = served
    eng = ServingEngine(cfg, ours, max_seq=32, batch_slots=1, paged=True,
                        page_size=4, kv_pages=3, device="cpu")
    big = eng.submit(Request(prompt=np.arange(1, 12), max_new_tokens=4))
    assert big.done and big.status is RequestStatus.REJECTED
    assert "KV pages" in big.error and len(big.output) == 0
    with pytest.raises(ValueError, match="null page"):
        ServingEngine(cfg, ours, max_seq=32, paged=True, kv_pages=1,
                      device="cpu")
    with pytest.raises(ValueError, match="paged KV cache requires "
                       "block_kind='attn'"):
        ServingEngine(dataclasses.replace(cfg, block_kind="hymba"), ours,
                      max_seq=32, paged=True, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, ours, max_seq=32, device="cpu").worst_case_pages(
            Request(prompt=np.arange(3)))


def test_paged_kv8_engine_equals_contiguous_kv8(served):
    """int8 KV: the paged engine (5-token pages, a pool that defers) emits
    the contiguous int8 engine's tokens exactly."""
    _, _, _, cfg, ours = served
    reqs_c = _mixed(6)
    _serve(cfg, ours, reqs_c, kv_quant=True)
    reqs_p = _mixed(6)
    eng = _serve(cfg, ours, reqs_p, kv_quant=True, paged=True, page_size=5,
                 kv_pages=9)
    assert eng.stats["admissions_deferred_pages"] > 0
    for r, c in zip(reqs_p, reqs_c):
        assert r.output.tolist() == c.output.tolist()


def test_paged_engine_matches_jax_engine(served):
    """Same weights and requests through JAX's paged engine (Pallas
    attention, host-driven scheduling) and the port's: equal tokens, or a
    first difference where the port's oracle finds the port's token within
    a near-tie of its own choice (printed)."""
    j_cfg, packed, j_ctx, cfg, ours = served
    reqs = _mixed()
    j_reqs = [JRequest(prompt=np.asarray(r.prompt, np.int32),
                       max_new_tokens=r.max_new_tokens) for r in reqs]
    JServingEngine(j_cfg, packed, max_seq=32, batch_slots=3, ctx=j_ctx,
                   prefill_chunk=4, decode_block=8, paged=True, page_size=5,
                   device_sched=False).run(j_reqs)
    _serve(cfg, ours, reqs, paged=True, page_size=5)
    for r, jr in zip(reqs, j_reqs):
        if r.output.tolist() != jr.output.tolist():
            gap = _oracle_gap(cfg, ours, r)
            print(f"port vs JAX paged engine: {r.output.tolist()} against "
                  f"{jr.output.tolist()}, port's oracle gap {gap:.2e}")
            assert gap < NEAR_TIE
