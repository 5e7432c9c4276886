"""The port's fault-tolerant serving, mirroring every case of
``tests/test_faults.py`` at its sizes, on the reduced qwen1.5-0.5b with the
JAX weights (``convert.from_jax_packed``), plus lockstep runs against the
JAX engine.

What is held:
  * blast radius: an invalid request (REJECTED), a NaN lane, a corrupt
    readback or a failed page allocation (FAILED) retires only its own
    request; every survivor's greedy tokens equal the port's fault-free
    run in the same mode, and ``audit()`` passes after every retirement;
  * deadlines and cancellation are seen at beats for queued, pending and
    live requests (TIMEOUT / CANCELLED; a live lane keeps its tokens);
  * a wedged device dispatch or a watchdog trip degrades to the
    host-driven loop with the fault-free tokens (DEGRADED);
  * an attached but empty injector, and none, give the same tokens;
  * a lane retired while its next block is in flight leaks none of that
    block's tokens into the slot's next occupant (the JAX engine does:
    ROADMAP section C);
  * on the same schedules the JAX engine (Pallas attention, interpret
    mode) reaches the same statuses and counters, and the same tokens up
    to a flip the port's oracle finds within a near-tie (printed).

On the CPU the device-resident block runs eagerly; on the card it is a
captured CUDA graph (``tests/test_torch_gpu.py``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.models.layers import Ctx
from repro_torch.serving import (AuditError, FaultInjector, Request,
                                 RequestStatus, ServingEngine)
from repro_torch.serving.engine import _Slot, reference_decode

ROBUSTNESS_KEYS = (
    "requests_completed", "requests_rejected", "requests_failed",
    "requests_timed_out", "requests_cancelled", "requests_degraded",
    "degraded_blocks", "faults_injected", "watchdog_trips",
    "sched_fallbacks", "integrity_faults")
LOCKSTEP_KEYS = ("faults_injected", "integrity_faults", "sched_fallbacks",
                 "repromotions", "requests_retried", "retries_total")
NEAR_TIE = 1e-2

_ENG_KW = dict(max_seq=32, batch_slots=2, prefill_chunk=4, decode_block=4)
_PAGED = dict(paged=True, page_size=4, kv_pages=24)
_SHARED = dict(_PAGED, enable_prefix_sharing=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here are tiny: one intra-op thread a process keeps
    parallel test workers from oversubscribing the cores, which slows
    such small ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    j_cfg = j_get_config("qwen1.5-0.5b").reduced()
    cfg = get_config("qwen1.5-0.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    return j_cfg, packed, cfg, ours


def _prompts(cfg, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size,
                         size=int(rng.integers(3, 9))).astype(np.int32)
            for _ in range(n)]


def _reqs(prompts, max_new=6, **kw):
    return [Request(prompt=p, max_new_tokens=max_new, **kw)
            for p in prompts]


def _engine(cfg, ours, **kw):
    merged = dict(_ENG_KW, device="cpu")
    merged.update(kw)
    return ServingEngine(cfg, ours, **merged)


@pytest.fixture(scope="module")
def baselines(served):
    """The port's fault-free outputs per mode for the 3-prompt workload
    (survivors are compared within their own mode, as in JAX)."""
    _, _, cfg, ours = served
    out = {}
    for name, kw in (("contig", {}), ("paged", _PAGED), ("shared", _SHARED)):
        reqs = _reqs(_prompts(cfg))
        _engine(cfg, ours, **kw).run(reqs)
        assert all(r.status == RequestStatus.OK for r in reqs)
        out[name] = [r.output.tolist() for r in reqs]
    return out


# ---------------------------------------------------------------------------
# Stats + fault-free identity
# ---------------------------------------------------------------------------

def test_robustness_stats_keys_always_present(served):
    _, _, cfg, ours = served
    for kw in ({}, dict(device_sched=False), _PAGED):
        eng = _engine(cfg, ours, **kw)
        eng.run(_reqs(_prompts(cfg)))
        for k in ROBUSTNESS_KEYS:
            assert k in eng.stats, k
        assert eng.stats["requests_completed"] == 3
        assert all(eng.stats[k] == 0 for k in ROBUSTNESS_KEYS
                   if k != "requests_completed")


@pytest.mark.parametrize("device_sched", [True, False])
@pytest.mark.parametrize("mode", ["contig", "paged", "shared"])
def test_empty_injector_is_bit_identical(served, baselines, mode,
                                         device_sched):
    """The seams (the NaN-mask select, the hook calls) are exact
    identities when nothing is scheduled, in every mode, greedy and
    sampled: an empty injector, no injector and the host-driven loop give
    the same tokens."""
    _, _, cfg, ours = served
    kw = {"contig": {}, "paged": _PAGED, "shared": _SHARED}[mode]
    for temperature in (0.0, 0.9):
        outs = []
        for extra in (dict(fault_injector=FaultInjector(),
                           audit_on_retire=True), {}):
            reqs = _reqs(_prompts(cfg), temperature=temperature)
            eng = _engine(cfg, ours, device_sched=device_sched, **kw,
                          **extra)
            eng.run(reqs)
            assert eng.stats["faults_injected"] == 0
            outs.append([r.output.tolist() for r in reqs])
        assert outs[0] == outs[1]
        if temperature == 0.0:
            assert outs[0] == baselines[mode]


# ---------------------------------------------------------------------------
# Admission-time isolation: REJECTED
# ---------------------------------------------------------------------------

def test_invalid_requests_rejected_without_blast_radius(served, baselines):
    _, _, cfg, ours = served
    good = _prompts(cfg)
    bads = [
        (Request(prompt=np.arange(40, dtype=np.int32)), "max_seq"),
        (Request(prompt=np.zeros((0,), np.int32)), "at least one"),
        (Request(prompt=np.asarray([1, 2], np.int32), max_new_tokens=0),
         "max_new_tokens"),
        (Request(prompt=np.asarray([1, cfg.vocab_size + 5], np.int32)),
         "token ids"),
    ]
    eng = _engine(cfg, ours)
    reqs = [_reqs([good[0]])[0]] + [b for b, _ in bads] + _reqs(good[1:])
    eng.run(reqs)
    for b, needle in bads:
        assert b.done and b.status == RequestStatus.REJECTED
        assert needle in b.error and len(b.output) == 0
        assert b.ttft_s is None
    survivors = [reqs[0]] + reqs[-2:]
    assert [r.output.tolist() for r in survivors] == baselines["contig"]
    assert eng.stats["requests_rejected"] == len(bads)
    assert eng.stats["requests_completed"] == 3


def test_oversized_paged_request_rejected_mid_queue(served):
    _, _, cfg, ours = served
    eng = _engine(cfg, ours, paged=True, page_size=4, kv_pages=8)
    good = _prompts(cfg)
    big = Request(prompt=np.arange(1, 20, dtype=np.int32),
                  max_new_tokens=12)   # worst case exceeds the 7-page pool
    reqs = [_reqs([good[0]])[0], big] + _reqs(good[1:])
    eng.run(reqs)
    assert big.status == RequestStatus.REJECTED and "KV pages" in big.error
    survivors = [reqs[0]] + reqs[2:]
    ref_reqs = _reqs(good)
    _engine(cfg, ours, paged=True, page_size=4, kv_pages=8).run(ref_reqs)
    assert ([r.output.tolist() for r in survivors]
            == [r.output.tolist() for r in ref_reqs])
    assert eng.audit()["ok"]


# ---------------------------------------------------------------------------
# Mid-flight isolation: NaN lane, corrupt readback, alloc faults
# ---------------------------------------------------------------------------

def test_nan_lane_isolated_paged_sharing(served, baselines):
    """Paged with prefix sharing and a NaN lane: every other request equals
    the fault-free run, audit() passes, and only the prefix cache still
    holds pages."""
    _, _, cfg, ours = served
    fi = FaultInjector().inject_nan(lane=1, block=0)
    eng = _engine(cfg, ours, **_SHARED, fault_injector=fi,
                  audit_on_retire=True)
    reqs = _reqs(_prompts(cfg))
    eng.run(reqs)
    statuses = [r.status for r in reqs]
    assert statuses.count(RequestStatus.FAILED) == 1
    failed = reqs[statuses.index(RequestStatus.FAILED)]
    assert "non-finite" in failed.error
    survivors = [(i, r) for i, r in enumerate(reqs)
                 if r.status == RequestStatus.OK]
    assert len(survivors) == 2
    for i, r in survivors:
        assert r.output.tolist() == baselines["shared"][i]
    # the failed lane kept the tokens it had before the poisoned block
    pre = failed.output.tolist()
    assert pre == baselines["shared"][statuses.index(
        RequestStatus.FAILED)][:len(pre)]
    assert eng.stats["integrity_faults"] == 1
    assert eng.stats["faults_injected"] == 1
    summary = eng.audit()
    assert summary["ok"]
    assert summary["used_pages"] == summary["index_pages"]
    assert (eng._pool.free_pages + summary["used_pages"]
            == eng._pool.usable)


def test_nan_lane_prefix_rollback(served):
    """A poisoned lane's prefix registrations are withdrawn: a later
    request with the same prompt prefills again instead of aliasing the
    faulted KV, and emits the right tokens."""
    _, _, cfg, ours = served
    p = np.asarray([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
    ref_reqs = [Request(prompt=p, max_new_tokens=6)]
    _engine(cfg, ours, **_SHARED).run(ref_reqs)
    want = ref_reqs[0].output.tolist()

    fi = FaultInjector().inject_nan(lane=0, block=0)
    eng = _engine(cfg, ours, batch_slots=1, **_SHARED, fault_injector=fi,
                  audit_on_retire=True)
    reqs = [Request(prompt=p, max_new_tokens=6),
            Request(prompt=p.copy(), max_new_tokens=6)]
    eng.run(reqs)
    assert reqs[0].status == RequestStatus.FAILED
    assert reqs[1].status == RequestStatus.OK
    assert reqs[1].output.tolist() == want
    assert eng.stats["prefix_hits"] == 0
    assert eng.audit()["ok"]


def test_corrupt_readback_flags_offending_lane_only(served, baselines):
    _, _, cfg, ours = served
    fi = FaultInjector().corrupt_readback(0, lane=0)
    eng = _engine(cfg, ours, fault_injector=fi)
    reqs = _reqs(_prompts(cfg))
    eng.run(reqs)
    statuses = [r.status for r in reqs]
    assert statuses.count(RequestStatus.FAILED) == 1
    failed = reqs[statuses.index(RequestStatus.FAILED)]
    assert "out of range" in failed.error
    for i, r in enumerate(reqs):
        if r.status == RequestStatus.OK:
            assert r.output.tolist() == baselines["contig"][i]
    assert eng.stats["integrity_faults"] == 1


@pytest.mark.parametrize("device_sched", [True, False])
def test_alloc_fault_contained_to_admission(served, device_sched):
    """A failed page allocation retires only the admission that needed it
    (device-resident: the up-front grant; host-driven: the chunk growth);
    the pool rolls back refcount-exact either way."""
    _, _, cfg, ours = served
    prompts = _prompts(cfg)
    ref_reqs = _reqs(prompts)
    _engine(cfg, ours, **_PAGED, device_sched=device_sched).run(ref_reqs)
    base = [r.output.tolist() for r in ref_reqs]

    fi = FaultInjector().fail_alloc(0)
    eng = _engine(cfg, ours, **_PAGED, device_sched=device_sched,
                  fault_injector=fi, audit_on_retire=True)
    reqs = _reqs(prompts)
    eng.run(reqs)
    statuses = [r.status for r in reqs]
    assert statuses.count(RequestStatus.FAILED) == 1
    failed = reqs[statuses.index(RequestStatus.FAILED)]
    assert "allocation failed" in failed.error and len(failed.output) == 0
    for i, r in enumerate(reqs):
        if r.status == RequestStatus.OK:
            assert r.output.tolist() == base[i]
    assert eng.stats["faults_injected"] == 1
    assert eng.audit()["ok"]
    assert eng._pool.free_pages == eng._pool.usable


@pytest.mark.parametrize("mode", ["contig", "shared"])
def test_retired_lane_in_flight_block_not_leaked(served, mode):
    """One slot: the first request's lane fails at block 0, and the block
    after it, already in flight on the device, still ran that lane.  The
    next request prefills in one wave into the same slot before that
    block is read back; it must get none of its tokens.  (The JAX engine
    appends them to the next request's output: ROADMAP section C.)"""
    _, _, cfg, ours = served
    kw = {"contig": {}, "shared": _SHARED}[mode]
    short = np.asarray([5, 9, 2], np.int32)
    want = [Request(prompt=short, max_new_tokens=8)]
    _engine(cfg, ours, batch_slots=1, **kw).run(want)
    for device_sched in (True, False):
        fi = FaultInjector().inject_nan(lane=0, block=0)
        eng = _engine(cfg, ours, batch_slots=1, **kw, fault_injector=fi,
                      device_sched=device_sched, audit_on_retire=True)
        reqs = [Request(prompt=np.arange(1, 7, dtype=np.int32),
                        max_new_tokens=12),
                Request(prompt=short, max_new_tokens=8)]
        eng.run(reqs)
        assert reqs[0].status is RequestStatus.FAILED
        assert reqs[1].status is RequestStatus.OK
        assert reqs[1].output.tolist() == want[0].output.tolist()


# ---------------------------------------------------------------------------
# Deadlines + cancellation
# ---------------------------------------------------------------------------

def test_queued_deadline_times_out_without_running(served):
    _, _, cfg, ours = served
    eng = _engine(cfg, ours, batch_slots=1)
    prompts = _prompts(cfg)
    reqs = [Request(prompt=prompts[0], max_new_tokens=6),
            Request(prompt=prompts[1], max_new_tokens=6, deadline_s=1e-9)]
    eng.run(reqs)
    assert reqs[0].status == RequestStatus.OK
    assert reqs[1].status == RequestStatus.TIMEOUT
    assert "queue" in reqs[1].error and len(reqs[1].output) == 0
    assert eng.stats["requests_timed_out"] == 1


def test_mid_flight_deadline_keeps_tokens_so_far(served, baselines):
    """A live lane whose deadline expires retires TIMEOUT with the tokens
    it produced; the other lane is untouched.  A hung dispatch (injected)
    burns the wall clock deterministically."""
    _, _, cfg, ours = served
    fi = FaultInjector().hang_dispatch(1, seconds=0.3)
    fi.armed = False
    eng = _engine(cfg, ours, fault_injector=fi)
    prompts = _prompts(cfg)
    eng.run(_reqs(prompts))   # warm, as the JAX test does for its jits
    fi.armed = True
    reqs = [Request(prompt=prompts[0], max_new_tokens=12, deadline_s=0.15),
            Request(prompt=prompts[1], max_new_tokens=6)]
    eng.run(reqs)
    assert reqs[0].status == RequestStatus.TIMEOUT
    assert "mid-decode" in reqs[0].error
    assert 0 < len(reqs[0].output) < 12
    assert reqs[1].status == RequestStatus.OK
    assert reqs[1].output.tolist() == baselines["contig"][1]


def test_cancel_at_block_boundary(served, baselines):
    _, _, cfg, ours = served
    prompts = _prompts(cfg)
    reqs = [Request(prompt=prompts[0], max_new_tokens=12),
            Request(prompt=prompts[1], max_new_tokens=6)]

    def cancel_at_block_1(engine, block):
        if block == 1:
            engine.cancel(reqs[0])

    eng = _engine(cfg, ours, on_block=cancel_at_block_1)
    eng.run(reqs)
    assert reqs[0].status == RequestStatus.CANCELLED
    assert 0 < len(reqs[0].output) < 12
    assert reqs[1].status == RequestStatus.OK
    assert reqs[1].output.tolist() == baselines["contig"][1]
    assert eng.stats["requests_cancelled"] == 1


def test_cancel_queued_request_never_runs(served):
    _, _, cfg, ours = served
    prompts = _prompts(cfg)
    queued = Request(prompt=prompts[1], max_new_tokens=6)
    queued.cancelled = True
    eng = _engine(cfg, ours, batch_slots=1)
    reqs = [Request(prompt=prompts[0], max_new_tokens=6), queued]
    eng.run(reqs)
    assert queued.status == RequestStatus.CANCELLED
    assert len(queued.output) == 0 and queued.ttft_s is None
    assert reqs[0].status == RequestStatus.OK


# ---------------------------------------------------------------------------
# Graceful degradation to the host-driven scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_wedged_dispatch_degrades_to_host_path(served, paged):
    """A dispatch that keeps failing past its retries degrades the run
    mid-flight; the survivors finish DEGRADED with the fault-free tokens,
    contiguous and paged; the next run starts device-resident again."""
    _, _, cfg, ours = served
    kw = _PAGED if paged else {}
    prompts = _prompts(cfg)
    ref_reqs = _reqs(prompts, max_new=10)
    _engine(cfg, ours, **kw).run(ref_reqs)
    base = [r.output.tolist() for r in ref_reqs]

    fi = FaultInjector().fail_dispatch(1, persistent=3)
    # repromote=False pins degrade-and-stay; re-promotion is in
    # tests/test_torch_recovery.py
    eng = _engine(cfg, ours, dispatch_retries=2, fault_injector=fi,
                  repromote=False, **kw)
    reqs = _reqs(prompts, max_new=10)
    eng.run(reqs)
    assert all(r.status == RequestStatus.DEGRADED for r in reqs)
    assert [r.output.tolist() for r in reqs] == base
    assert eng.stats["sched_fallbacks"] == 1
    assert eng.stats["degraded_blocks"] >= 1
    assert eng.stats["requests_degraded"] == len(reqs)
    if paged:
        assert eng.audit()["ok"]
    fi.armed = False
    reqs2 = _reqs(prompts, max_new=10)
    eng.run(reqs2)
    assert all(r.status == RequestStatus.OK for r in reqs2)
    assert [r.output.tolist() for r in reqs2] == base
    assert eng.stats["sched_fallbacks"] == 0
    assert eng.stats["steady_state_syncs_per_block"] == 0.0


def test_watchdog_trip_degrades_device_path(served):
    """A block past block_deadline_s trips the watchdog (which only
    records) and degrades; the tokens stay the fault-free ones."""
    _, _, cfg, ours = served
    prompts = _prompts(cfg)
    fi = FaultInjector().hang_dispatch(1, seconds=0.8)
    fi.armed = False
    eng = _engine(cfg, ours, fault_injector=fi, repromote=False)
    warm = _reqs(prompts, max_new=10)
    eng.run(warm)
    base = [r.output.tolist() for r in warm]
    eng.block_deadline_s = 0.35
    fi.armed = True
    reqs = _reqs(prompts, max_new=10)
    eng.run(reqs)
    assert eng.stats["watchdog_trips"] >= 1
    assert eng.stats["sched_fallbacks"] == 1
    assert all(r.status == RequestStatus.DEGRADED for r in reqs)
    assert [r.output.tolist() for r in reqs] == base


def test_host_path_dispatch_fault_fails_live_batch(served):
    """Host-driven there is no lower level: a persistently failing
    dispatch retires the live batch FAILED and the queue is served on."""
    _, _, cfg, ours = served
    prompts = _prompts(cfg)
    fi = FaultInjector().fail_dispatch(1, persistent=3)
    eng = _engine(cfg, ours, batch_slots=2, device_sched=False,
                  dispatch_retries=2, fault_injector=fi)
    reqs = _reqs(prompts, max_new=10)
    eng.run(reqs)
    assert [r.status for r in reqs[:2]] == [RequestStatus.FAILED] * 2
    assert reqs[2].status == RequestStatus.OK
    assert eng.stats["requests_failed"] == 2


# ---------------------------------------------------------------------------
# audit() + the parked-write guard
# ---------------------------------------------------------------------------

def test_audit_detects_manufactured_violations(served):
    _, _, cfg, ours = served
    eng = _engine(cfg, ours, **_SHARED)
    eng.run(_reqs(_prompts(cfg)))
    assert eng.audit()["ok"]
    (leaked,) = eng._pool.alloc(1)
    with pytest.raises(AuditError, match="diverged|leak"):
        eng.audit()
    eng._pool.decref(leaked)
    assert eng.audit()["ok"]
    eng._pool._free.append(eng._pool._free[-1])
    with pytest.raises(AuditError, match="duplicate"):
        eng.audit()
    eng._pool._free.pop()
    assert eng.audit()["ok"]
    eng._pool._free.append(0)
    with pytest.raises(AuditError, match="null page"):
        eng.audit()
    eng._pool._free.pop()
    assert eng.audit()["ok"]


def test_drain_clobbered_tail_guard_regression(served, monkeypatch):
    """If retirement were skipped for a lane that filled its row, the
    engine must raise rather than serve tokens from a clobbered tail."""
    _, _, cfg, ours = served
    eng = _engine(cfg, ours)
    eng.run(_reqs(_prompts(cfg)))
    s = _Slot()
    s.request = Request(prompt=np.asarray([1, 2], np.int32),
                        max_new_tokens=100)
    s.tokens = [1]
    s.cache_len = eng.max_seq - 1
    s.last_token = 1
    slots = [s] + [_Slot() for _ in range(eng.slots - 1)]
    blk = np.ones((eng.slots, eng.decode_block), np.int64)
    mask = np.zeros((eng.slots, eng.decode_block), bool)
    mask[0, 0] = True   # one append -> cache_len == max_seq
    bad = np.zeros((eng.slots,), bool)
    monkeypatch.setattr(eng, "_free_slot", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="clobber"):
        eng._process_block(slots, blk, mask, bad, gating=True)


# ---------------------------------------------------------------------------
# Random injected-fault schedules over a warm paged+sharing engine
# ---------------------------------------------------------------------------

def _fault_schedule_run(cfg, base_eng, fault_eng, seed):
    """One round: a seeded random schedule on the warm paged+sharing
    engine; survivors equal the fault-free run, a FAILED lane holds a
    prefix of its fault-free output, audit() passes throughout."""
    rng = np.random.default_rng(seed)
    tmpl = rng.integers(1, cfg.vocab_size, size=8).astype(np.int32)
    prompts = []
    for _ in range(5):
        if rng.random() < 0.5:
            tail = rng.integers(1, cfg.vocab_size,
                                size=int(rng.integers(1, 4)))
            prompts.append(np.concatenate([tmpl, tail]).astype(np.int32))
        else:
            prompts.append(rng.integers(
                1, cfg.vocab_size,
                size=int(rng.integers(3, 9))).astype(np.int32))
    news = [int(rng.integers(3, 9)) for _ in prompts]
    base_reqs = [Request(prompt=p, max_new_tokens=n)
                 for p, n in zip(prompts, news)]
    base_eng.run(base_reqs)
    base = [r.output.tolist() for r in base_reqs]

    fault_eng.fault_injector = FaultInjector.random_schedule(
        int(seed), slots=fault_eng.slots, n_faults=3, max_block=6,
        max_alloc=10)
    reqs = [Request(prompt=p.copy(), max_new_tokens=n)
            for p, n in zip(prompts, news)]
    fault_eng.run(reqs)
    for r, b in zip(reqs, base):
        assert r.done and r.status is not None
        out = r.output.tolist()
        if r.status in (RequestStatus.OK, RequestStatus.DEGRADED):
            assert out == b, f"survivor diverged under seed {seed}"
        elif r.status == RequestStatus.FAILED:
            assert out == b[:len(out)], f"failed-lane tokens diverged " \
                                        f"under seed {seed}"
        else:
            raise AssertionError(f"unexpected status {r.status}")
    summary = fault_eng.audit()
    assert summary["ok"]
    assert summary["used_pages"] == summary["index_pages"]


def test_random_fault_schedules_seeded_sweep(served):
    _, _, cfg, ours = served
    base_eng = _engine(cfg, ours, **_SHARED)
    fault_eng = _engine(cfg, ours, audit_on_retire=True, **_SHARED)
    for seed in range(6):
        _fault_schedule_run(cfg, base_eng, fault_eng, seed)


def test_random_fault_schedules_hypothesis(served):
    """The sweep over drawn seeds.  The JAX counterpart fails (ROADMAP
    section C): a lane retired while its next block is in flight hands
    that block's tokens to the slot's next occupant (seed 7593, run first
    here, is a schedule it fails on).  The port holds its survivors to its
    own fault-free run."""
    from hypothesis import example, given, settings, strategies as st

    _, _, cfg, ours = served
    base_eng = _engine(cfg, ours, **_SHARED)
    fault_eng = _engine(cfg, ours, audit_on_retire=True, **_SHARED)

    @settings(max_examples=5, deadline=None, database=None)
    @given(seed=st.integers(100, 10_000))
    @example(seed=7593)
    def inner(seed):
        _fault_schedule_run(cfg, base_eng, fault_eng, seed)

    inner()


# ---------------------------------------------------------------------------
# Lockstep against the JAX engine
# ---------------------------------------------------------------------------

def lockstep(served, schedule, prompts, max_new, **kw):
    """The same requests and fault schedule through the JAX engine (Pallas
    attention, interpret mode) and the port: equal statuses and counters,
    and equal tokens up to a flip within the port oracle's near-tie."""
    j_cfg, packed, cfg, ours = served
    kw = dict(_ENG_KW, **kw)
    jfi = JFaultInjector()
    schedule(jfi)
    j_eng = JServingEngine(j_cfg, packed, ctx=JCtx(
        mode="packed", group_size=j_cfg.group_size, attn_impl="pallas"),
        fault_injector=jfi, **kw)
    j_reqs = j_eng.run([JRequest(prompt=p, max_new_tokens=max_new)
                        for p in prompts])
    fi = FaultInjector()
    schedule(fi)
    eng = ServingEngine(cfg, ours, device="cpu", fault_injector=fi, **kw)
    reqs = eng.run([Request(prompt=p, max_new_tokens=max_new)
                    for p in prompts])
    assert ([r.status.value for r in reqs]
            == [r.status.value for r in j_reqs])
    assert ({k: eng.stats[k] for k in LOCKSTEP_KEYS}
            == {k: j_eng.stats[k] for k in LOCKSTEP_KEYS})
    for r, jr in zip(reqs, j_reqs):
        got, want = r.output.tolist(), jr.output.tolist()
        if got != want:
            _, gaps = reference_decode(cfg, ours, Ctx(), r.prompt, len(got),
                                       kw["max_seq"], follow=r.output)
            i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            print(f"port vs JAX engine: first flip at emit index {i}, port's "
                  f"oracle gap {gaps[i]:.2e}")
            assert max(gaps) < NEAR_TIE, (got, want, gaps)
        assert len(got) == len(want)
    return eng, reqs


@pytest.mark.parametrize("mode", ["contig", "shared"])
def test_nan_and_corrupt_lockstep_with_jax(served, mode):
    """A NaN lane at block 1 and a corrupt fourth readback, on the
    device-resident engines of both packages: two requests fail."""
    _, _, cfg, _ = served

    def schedule(fi):
        fi.inject_nan(lane=1, block=1).corrupt_readback(3)

    eng, reqs = lockstep(served, schedule, _prompts(cfg, seed=2, n=4), 8,
                         **({} if mode == "contig" else _SHARED))
    assert eng.stats["integrity_faults"] == 2
    assert [r.status for r in reqs].count(RequestStatus.FAILED) == 2
