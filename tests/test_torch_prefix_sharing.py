"""The port's paged prefix sharing, mirroring ``tests/test_prefix_sharing.py``
on the reduced qwen1.5-0.5b with the JAX weights
(``convert.from_jax_packed``).

What is held:
  * the refcounted ``_PagePool`` and the ``_PrefixIndex`` trie behave as
    the JAX engine's (unit cases), and on seeded random admit / retire /
    evict schedules the port's pair and JAX's, driven in lockstep, hand out
    the same pages with the same reference counts, never leak, never free
    twice and never free a page that is read;
  * the sharing engine emits the plain paged engine's tokens exactly
    (share bases are chunk multiples, so its chunk schedule is the plain
    engine's) across prefix lengths {whole prompt, < page, spanning pages,
    zero, = page} and page sizes 4, 5, 16 (copy-on-write splits
    included), and the oracle's up to a near-tie (printed);
  * sharing skips prefill, saves pages, and admits a request that only
    fits through shared pages; the allocator ends every schedule with only
    the prefix cache holding pages;
  * ``transformer.copy_paged_page`` is JAX's ``copy_paged_page``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import transformer as jtf
from repro.serving.engine import _PagePool as JPagePool
from repro.serving.engine import _PrefixIndex as JPrefixIndex

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.models import attention, transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import (_PagePool, _PrefixIndex,
                                        reference_decode)

NEAR_TIE = 1e-2


# ---------------------------------------------------------------------------
# Refcounted allocator + trie units
# ---------------------------------------------------------------------------

def test_refcounted_pool_share_and_release():
    pool = _PagePool(6)
    (a,) = pool.alloc(1)
    pool.incref(a)
    pool.incref(a)
    assert pool.refcount(a) == 3
    assert pool.used_pages == 1      # an aliased page counts once
    assert pool.shared_pages == 1
    assert not pool.decref(a) and not pool.decref(a)   # readers remain
    assert pool.refcount(a) == 1 and pool.free_pages == 4
    assert pool.decref(a)            # the last reader frees it
    assert pool.free_pages == 5 and pool.used_pages == 0
    with pytest.raises(RuntimeError, match="double free"):
        pool.decref(a)
    with pytest.raises(RuntimeError, match="free page"):
        pool.incref(a)


def test_prefix_index_lookup_insert_evict():
    idx = _PrefixIndex(4)
    pool = _PagePool(10)
    p = pool.alloc(4)
    # two full pages and a partial tail: only full pages are indexed
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    new = idx.insert(prompt, p[:2])
    assert [n.page for n in new] == p[:2] and idx.n_pages == 2
    for n in new:
        pool.incref(n.page)
    chain, boundary, blcp = idx.lookup([1, 2, 3, 4, 5, 6, 7, 8, 42])
    assert [n.page for n in chain] == p[:2] and boundary is None
    # divergence inside a page: the best partial child is the CoW donor
    chain, boundary, blcp = idx.lookup([1, 2, 3, 4, 5, 6, 99, 98])
    assert [n.page for n in chain] == p[:1]
    assert boundary.page == p[1] and blcp == 2
    new2 = idx.insert([1, 2, 3, 4, 50, 51, 52, 53], [p[0], p[2]])
    assert [n.page for n in new2] == [p[2]]   # the shared first page dedups
    pool.incref(p[2])
    for q in (p[0], p[1], p[2], p[3]):   # the writing slots retire
        pool.decref(q)
    pool.incref(p[1])                      # a sharing slot still reads p[1]
    evicted = idx.evict_coldest(lambda q: pool.refcount(q) == 1)
    assert evicted == p[2] and idx.n_pages == 2
    assert idx.evict_coldest(lambda q: pool.refcount(q) == 1) is None
    assert idx.evict_coldest(lambda q: pool.refcount(q) == 1,
                             force=True) == p[1]
    assert idx.evict_coldest(lambda q: pool.refcount(q) == 1) == p[0]
    assert idx.n_pages == 0


# ---------------------------------------------------------------------------
# Allocator property: random admit/retire/evict schedules, port and JAX in
# lockstep
# ---------------------------------------------------------------------------

class _AllocSim:
    """The engine's host-side page accounting in miniature (the JAX test's
    model): admissions alias cached prefix pages, allocate the rest,
    register full prompt pages, retire by decref and evict under pressure,
    with an independent oracle refcount map checked after every step."""

    def __init__(self, pool_cls, index_cls, usable: int, page_size: int):
        self.pool = pool_cls(usable + 1)
        self.index = index_cls(page_size)
        self.ps = page_size
        self.initial_free = self.pool.free_pages
        self.oracle: dict = {}
        self.slots: list = []

    def _inc(self, p):
        self.oracle[p] = self.oracle.get(p, 0) + 1

    def _dec(self, p):
        self.oracle[p] -= 1
        if not self.oracle[p]:
            del self.oracle[p]

    def check(self):
        free, live = self.pool._free, self.pool._refs
        assert len(set(free)) == len(free), "duplicate entries in free list"
        assert not set(free) & set(live), "page both free and referenced"
        assert set(free) | set(live) == set(range(1, self.pool.num_pages)), \
            "pages leaked (neither free nor referenced)"
        assert all(c >= 1 for c in live.values())
        assert live == self.oracle, "pool refcounts diverged from oracle"
        assert self.pool.used_pages == len(live)

    def evict(self) -> bool:
        page = self.index.evict_coldest(
            lambda p: self.pool.refcount(p) == 1, force=True)
        if page is None:
            return False
        self.pool.decref(page)
        self._dec(page)
        self.check()
        return True

    def admit(self, prompt) -> bool:
        ps = self.ps
        chain, boundary, blcp = self.index.lookup(prompt)
        base = min(len(chain) * ps + blcp, len(prompt) - 1)
        n_full = base // ps
        shared = [n.page for n in chain[:n_full]]
        need = -(-len(prompt) // ps) - n_full
        for p in shared:   # alias before allocating, as the engine does
            self.pool.incref(p)
            self._inc(p)
        self.check()
        while self.pool.free_pages < need and self.evict():
            pass
        if self.pool.free_pages < need:   # deferred: roll the grant back
            for p in shared:
                self.pool.decref(p)
                self._dec(p)
            self.check()
            return False
        owned = self.pool.alloc(need)
        for p in owned:
            self._inc(p)
        self.check()
        pages = shared + owned
        for node in self.index.insert(prompt, pages[:len(prompt) // ps]):
            self.pool.incref(node.page)
            self._inc(node.page)
        self.slots.append(pages)
        self.check()
        return True

    def retire(self, k) -> None:
        for p in self.slots.pop(k % len(self.slots)):
            self.pool.decref(p)
            self._dec(p)
        self.check()

    def drain(self) -> None:
        while self.slots:
            self.retire(0)
        while self.evict():
            pass
        assert self.pool.used_pages == 0
        assert self.pool.free_pages == self.initial_free, \
            "pages leaked across a full drain"


_TEMPLATES = [list(range(1, 40)), list(range(100, 139)),
              [7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7]]


def _lockstep(sims, picks) -> None:
    """Drive the port's and JAX's simulations with the same picks; after
    every step both pools hold the same pages with the same counts."""
    def same():
        a, b = sims
        assert a.pool._free == b.pool._free and a.pool._refs == b.pool._refs
        assert a.index.n_pages == b.index.n_pages
        assert a.slots == b.slots

    for op, a, b, c in picks:
        if op == 0 and len(sims[0].slots) < 6:
            t = _TEMPLATES[a % len(_TEMPLATES)]
            keep = b % (len(t) + 1)
            suffix = [997 + c, 991 - c, 983 + a][:1 + c % 3]
            admitted = {s.admit(t[:keep] + suffix) for s in sims}
            assert len(admitted) == 1
        elif op == 1 and sims[0].slots:
            for s in sims:
                s.retire(a)
        else:
            assert len({s.evict() for s in sims}) == 1
        same()
    for s in sims:
        s.drain()
    same()


def test_allocator_random_schedules_seeded():
    """60 seeded schedules of interleaved admit / retire / evict: no leak,
    no double free, no page freed while read — and the port's pool and
    trie make JAX's choices, page for page."""
    rng = np.random.default_rng(11)
    for _ in range(60):
        usable = int(rng.integers(4, 24))
        ps = int(rng.integers(3, 7))
        picks = rng.integers(0, 1000, size=(int(rng.integers(1, 40)), 4))
        _lockstep([_AllocSim(_PagePool, _PrefixIndex, usable, ps),
                   _AllocSim(JPagePool, JPrefixIndex, usable, ps)],
                  [tuple(map(int, row)) for row in picks])


# ---------------------------------------------------------------------------
# Engine equivalence: sharing is invisible in the tokens
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    j_cfg = j_get_config("qwen1.5-0.5b").reduced()
    cfg = get_config("qwen1.5-0.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    return cfg, from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                                device="cpu")


def _assert_oracle(cfg, ours, r, max_seq):
    """The f32-cache oracle's greedy tokens, or a first flip at a near-tie
    (its top-2 margin printed): chunked admission reads earlier chunks back
    through the cache where the oracle's prompt prefill does not."""
    want, margins = reference_decode(cfg, ours, Ctx(), r.prompt,
                                     len(r.output), max_seq,
                                     cache_dtype=torch.float32)
    got = r.output.tolist()
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            print(f"oracle flip at emit index {i}: top-2 margin "
                  f"{margins[i]:.2e}")
            assert margins[i] < NEAR_TIE, (got, want, margins)
            return


_TPL = np.asarray([7, 3, 9, 5, 11, 2, 8, 13, 4, 6, 10, 12, 14, 1, 15, 16,
                   17, 18, 19, 20, 21, 22, 23, 24], np.int32)   # 24 tokens


def _sweep_requests():
    """Prefix lengths against the donor r0 (template + tail) covering
    {whole prompt, < page, spanning pages, zero, = page} at page sizes
    4, 5 and 16 (what lands inside a page is copied on write)."""
    prompts = [
        np.concatenate([_TPL, [101, 102]]).astype(np.int32),         # donor
        np.concatenate([_TPL, [101, 102]]).astype(np.int32),         # whole
        np.concatenate([_TPL[:3], [77, 78, 79, 80, 81]]).astype(np.int32),
        np.concatenate([_TPL[:17], [88, 89, 90]]).astype(np.int32),  # spans
        np.asarray([120, 121, 122, 123, 124, 125], np.int32),        # zero
        np.concatenate([_TPL[:4], [91, 92, 93]]).astype(np.int32),   # = page
    ]
    return prompts, [4, 6, 5, 4, 4, 5]


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_prefix_engine_token_identical(served, page_size):
    cfg, ours = served
    max_seq = 32
    prompts, news = _sweep_requests()

    def mk():
        return [Request(prompt=p, max_new_tokens=n)
                for p, n in zip(prompts, news)]

    kw = dict(max_seq=max_seq, batch_slots=2, prefill_chunk=2,
              decode_block=4, paged=True, page_size=page_size,
              cache_dtype=torch.float32, device="cpu")
    plain = ServingEngine(cfg, ours, **kw)
    reqs_p = plain.run(mk())
    shared = ServingEngine(cfg, ours, enable_prefix_sharing=True, **kw)
    reqs_s = shared.run(mk())
    for rp, rs in zip(reqs_p, reqs_s):
        np.testing.assert_array_equal(rs.output, rp.output)
        _assert_oracle(cfg, ours, rs, max_seq)
    st = shared.stats
    assert st["prefix_hits"] >= 3
    assert st["kv_cow_splits"] >= 1
    assert st["prefill_tokens_skipped"] > 0
    assert st["kv_pages_shared"] > 0
    assert st["kv_pages_peak"] <= plain.stats["kv_pages_peak"]
    assert st["kv_pages_shared_peak"] > 0
    assert st["kv_pages_in_use"] == st["kv_prefix_cached_pages"]


def test_prefix_sharing_skips_prefill_and_saves_pages(served):
    """Two slots sharing a 64-token template: the second admission skips
    >= 64 prefill tokens, and the unique-page peak is below the plain
    paged run's."""
    cfg, ours = served
    max_seq = 96
    rng = np.random.default_rng(5)
    tmpl = rng.integers(1, cfg.vocab_size, size=64).astype(np.int32)
    prompts = [np.concatenate([tmpl, [11, 12, 13, 14]]).astype(np.int32),
               np.concatenate([tmpl, [21, 22, 23, 24]]).astype(np.int32)]

    def mk():
        return [Request(prompt=p, max_new_tokens=4) for p in prompts]

    kw = dict(max_seq=max_seq, batch_slots=2, prefill_chunk=16,
              decode_block=4, paged=True, page_size=16,
              cache_dtype=torch.float32, device="cpu")
    plain = ServingEngine(cfg, ours, **kw)
    reqs_p = plain.run(mk())
    shared = ServingEngine(cfg, ours, enable_prefix_sharing=True, **kw)
    reqs_s = shared.run(mk())
    for rp, rs in zip(reqs_p, reqs_s):
        np.testing.assert_array_equal(rs.output, rp.output)
        _assert_oracle(cfg, ours, rs, max_seq)
    st = shared.stats
    assert st["prefill_tokens_skipped"] >= 64
    assert st["kv_pages_shared"] >= 64 // 16
    assert st["prefix_hit_rate"] == 0.5      # 1 hit of 2 admissions
    assert st["admissions_held_for_prefix"] >= 1
    assert st["kv_pages_peak"] < plain.stats["kv_pages_peak"]
    assert st["prefill_chunk_rows"] < plain.stats["prefill_chunk_rows"]


def test_admission_fits_only_via_shared_pages(served):
    """A prompt whose worst-case reservation fits only through granted
    shared pages admits mid-flight, and its CoW split defers nobody; the
    same pool without sharing defers."""
    cfg, ours = served
    max_seq = 32
    tmpl = np.asarray(range(2, 18), np.int32)   # 16 tokens
    pa = tmpl
    pb = np.concatenate([tmpl[:14], [60, 61, 62, 63]]).astype(np.int32)

    def mk():
        return [Request(prompt=pa, max_new_tokens=8),
                Request(prompt=pb, max_new_tokens=6)]

    # worst cases at ps = 4: 6 and 6 pages; 9 usable hold 6 + (6 - 3)
    kw = dict(max_seq=max_seq, batch_slots=2, prefill_chunk=2,
              decode_block=4, paged=True, page_size=4, kv_pages=10,
              cache_dtype=torch.float32, device="cpu")
    plain = ServingEngine(cfg, ours, **kw)
    reqs_p = plain.run(mk())
    assert plain.stats["admissions_deferred_pages"] >= 1
    shared = ServingEngine(cfg, ours, enable_prefix_sharing=True, **kw)
    reqs_s = shared.run(mk())
    st = shared.stats
    assert st["admissions_deferred_pages"] == 0
    assert st["admissions_held_for_prefix"] >= 1
    assert st["mid_flight_admissions"] >= 1
    assert st["kv_cow_splits"] == 1            # base 14 splits page 3
    for rp, rs in zip(reqs_p, reqs_s):
        np.testing.assert_array_equal(rs.output, rp.output)
        _assert_oracle(cfg, ours, rs, max_seq)


# ---------------------------------------------------------------------------
# Adversarial schedules: shared vs plain engines that persist across runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_pair(served):
    """A plain paged and a sharing engine over a tight pool (8 usable
    pages, 2 slots): deferrals, holdbacks, CoW splits, evictions under
    pressure and page recycling.  Both live across the schedules."""
    cfg, ours = served
    kw = dict(max_seq=32, batch_slots=2, prefill_chunk=2, decode_block=4,
              paged=True, page_size=4, kv_pages=9, device="cpu")
    return (ServingEngine(cfg, ours, **kw),
            ServingEngine(cfg, ours, enable_prefix_sharing=True, **kw))


def _schedule_requests(picks):
    """picks: (template, keep, suffix_len, max_new) ints."""
    reqs = []
    for t, keep, sfx, new in picks:
        tmpl = _TPL if t % 2 == 0 else _TPL[::-1]
        suffix = ((90 + np.arange(1 + sfx % 4, dtype=np.int32)
                   + 7 * (t % 5)) % 127)   # inside the reduced vocab
        prompt = np.concatenate([tmpl[:keep % 17], suffix]).astype(np.int32)
        reqs.append((prompt, 1 + new % 5))
    return reqs


_FIXED_SCHEDULES = [
    # templated burst: repeats, divergences at every depth, a cold outlier
    [(0, 16, 0, 3), (0, 16, 0, 4), (0, 9, 1, 2), (1, 12, 2, 3),
     (0, 16, 3, 1), (1, 0, 3, 4), (0, 13, 1, 2), (0, 16, 0, 2)],
    # eviction churn: alternating templates on the tight pool
    [(0, 15, 2, 4), (1, 15, 2, 4), (0, 15, 1, 3), (1, 15, 1, 3),
     (0, 7, 0, 1), (1, 7, 0, 5)],
]


@pytest.mark.parametrize("schedule", range(len(_FIXED_SCHEDULES)))
def test_adversarial_schedules_token_identical(engine_pair, schedule):
    plain, shared = engine_pair
    spec = _schedule_requests(_FIXED_SCHEDULES[schedule])
    reqs_p = plain.run([Request(prompt=p, max_new_tokens=n)
                        for p, n in spec])
    reqs_s = shared.run([Request(prompt=p, max_new_tokens=n)
                         for p, n in spec])
    for rp, rs in zip(reqs_p, reqs_s):
        np.testing.assert_array_equal(rs.output, rp.output)
    st = shared.stats
    assert st["kv_pages_in_use"] == st["kv_prefix_cached_pages"]
    assert plain.stats["kv_pages_in_use"] == 0
    assert st["prefix_hits"] > 0


def test_plain_paged_engine_reports_sharing_stats_as_zero(engine_pair):
    plain, _ = engine_pair
    plain.run([Request(prompt=_TPL[:6].copy(), max_new_tokens=2)])
    st = plain.stats
    for key in ("prefix_hits", "prefill_tokens_skipped", "kv_pages_shared",
                "kv_pages_shared_peak", "kv_cow_splits", "prefix_evictions",
                "admissions_held_for_prefix", "kv_prefix_cached_pages"):
        assert st[key] == 0, key
    assert st["prefix_hit_rate"] == 0.0


def test_share_base_is_chunk_aligned(served):
    """The share base is the longest cached prefix cut to a
    ``prefill_chunk`` multiple, at most ``plen - 1`` and ``max_seq -
    prefill_chunk``: the sharer's chunks are then the plain engine's, which
    is what makes its bits the plain engine's at a bf16 cache too."""
    cfg, ours = served
    eng = ServingEngine(cfg, ours, max_seq=32, batch_slots=1,
                        prefill_chunk=4, decode_block=4, paged=True,
                        page_size=5, enable_prefix_sharing=True, device="cpu")
    eng.run([Request(prompt=_TPL[:23].copy(), max_new_tokens=2)])
    for n, tail in ((3, 0), (7, 1), (11, 0), (13, 2), (22, 1), (23, 0)):
        prompt = np.concatenate([_TPL[:n], [125] * tail]).astype(np.int32)
        g = eng._prefix_lookup(prompt)
        want = min(n, len(prompt) - 1, 32 - 4) // 4 * 4
        assert g["base"] == want, (n, tail, g)
        assert len(g["pages"]) == want // 5
        assert (g["cow_src"] is None) == (want % 5 == 0)


def test_prefix_sharing_requires_paged(served):
    cfg, ours = served
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, ours, max_seq=16, batch_slots=1,
                      enable_prefix_sharing=True, device="cpu")


def test_copy_kv_page_matches_jax():
    """The CoW copy moves exactly one page, in every layer and plane, as
    JAX's ``copy_kv_page`` / ``copy_paged_page`` do."""
    base = np.arange(4 * 3 * 2 * 2, dtype=np.float32).reshape(4, 3, 2, 2)
    got = attention.copy_kv_page(torch.from_numpy(base.copy()), 2, 1)
    want = j_attn.copy_kv_page(jnp.asarray(base), jnp.asarray(2),
                               jnp.asarray(1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    planes = {"k": base[None], "v": (base * 2)[None],
              "k_scale": base[None, ..., 0]}
    got = transformer.copy_paged_page(
        {k: torch.from_numpy(v.copy()) for k, v in planes.items()}, 0, 3)
    want = jtf.copy_paged_page({k: jnp.asarray(v) for k, v in planes.items()},
                               0, 3)
    for name in planes:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
