"""The port's resident ``submit()``/``step()``/``drain()``/``close()``
engine, mirroring every case of ``tests/test_continuous.py`` at its sizes,
on the reduced qwen1.5-0.5b with the JAX weights
(``convert.from_jax_packed``).

What is held:
  * a staggered arrival trace through ``submit()``/``step()`` emits the
    tokens of one batch ``run()`` in every mode, including arrivals that
    land while the engine is degraded or while a request waits out its
    retry backoff (default seeds key on the engine-lifetime arrival
    count);
  * ``on_token`` fires once per token, in emit order, and the streamed
    tokens are the final output, across the one-block-behind readback and
    a retry's replay;
  * ``deadline_s`` and TTFT run from each request's ``submit()``;
  * a pure backoff window costs one beat and one sleep, not a poll loop;
  * ``stats`` is a window and ``lifetime`` sums the windows.
"""

import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.serving import (FaultInjector, Request, RequestStatus,
                                 ServingEngine, StepOutcome)

_ENG_KW = dict(max_seq=32, batch_slots=2, prefill_chunk=4, decode_block=4)
_PAGED = dict(paged=True, page_size=4, kv_pages=24)

MODES = {
    "contig_host": dict(device_sched=False),
    "contig_dev": dict(device_sched=True),
    "paged_dev": dict(_PAGED, device_sched=True),
    "shared_host": dict(_PAGED, enable_prefix_sharing=True,
                        device_sched=False),
    "shared_dev": dict(_PAGED, enable_prefix_sharing=True,
                       device_sched=True),
}


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
    return cfg, ours


def _engine(cfg, ours, **kw):
    merged = dict(_ENG_KW, device="cpu")
    merged.update(kw)
    return ServingEngine(cfg, ours, **merged)


def _prompts(cfg, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size,
                         size=int(rng.integers(3, 9))).astype(np.int32)
            for _ in range(n)]


def _mk_reqs(cfg):
    """Three greedy requests and one sampled one with a default seed (the
    sampled one pins the arrival-count seeds)."""
    prompts = _prompts(cfg)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts[:3]]
    reqs.append(Request(prompt=prompts[3], max_new_tokens=6,
                        temperature=0.9))
    return reqs


def _drive(eng, reqs, arrivals):
    """Submit ``reqs[i]`` once ``arrivals[i]`` beats have run, stepping the
    engine in between: an open-loop client."""
    beats, idx = 0, 0
    while idx < len(reqs) or eng.has_work:
        while idx < len(reqs) and arrivals[idx] <= beats:
            eng.submit(reqs[idx])
            idx += 1
        out = eng.step()
        beats += 1
        if out.idle_until is not None and idx >= len(reqs):
            wait = out.idle_until - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        if not out.worked and idx < len(reqs):
            beats = max(beats, arrivals[idx])
    return eng.drain()


# -- batch/incremental equivalence --------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_staggered_arrivals_match_batch(served, mode):
    cfg, ours = served
    kw = MODES[mode]
    b_reqs = _mk_reqs(cfg)
    _engine(cfg, ours, **kw).run(b_reqs)
    assert all(r.status is RequestStatus.OK for r in b_reqs)

    inc = _engine(cfg, ours, **kw)
    i_reqs = _mk_reqs(cfg)
    st = _drive(inc, i_reqs, arrivals=[0, 0, 2, 4])
    for rb, ri in zip(b_reqs, i_reqs):
        assert ri.status is RequestStatus.OK
        assert ri.seed == rb.seed
        np.testing.assert_array_equal(ri.output, rb.output)
        assert ri.ttft_s is not None and ri.ttft_s > 0
    assert st["admissions"] == len(i_reqs)
    if kw.get("device_sched"):
        assert st["steady_state_syncs_per_block"] == 0.0


def test_submit_mid_degrade(served):
    cfg, ours = served
    prompts = _prompts(cfg, n=3)
    b_reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
    _engine(cfg, ours).run(b_reqs)

    fi = FaultInjector().wedge_device(1)
    eng = _engine(cfg, ours, fault_injector=fi, dispatch_retries=2,
                  probe_cooldown_blocks=1)
    reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    for _ in range(200):
        eng.step()
        if eng.stats["sched_fallbacks"]:
            break
    assert eng.stats["sched_fallbacks"] == 1
    eng.submit(reqs[2])   # arrives while degraded
    st = eng.drain()
    assert all(r.status is RequestStatus.DEGRADED for r in reqs)
    for rb, ri in zip(b_reqs, reqs):
        np.testing.assert_array_equal(ri.output, rb.output)
    assert st["repromotions"] == 0


def test_submit_mid_retry_wait(served):
    cfg, ours = served
    prompts = _prompts(cfg, n=2)
    b_reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
    _engine(cfg, ours, batch_slots=1).run(b_reqs)

    fi = FaultInjector().inject_nan(lane=0, block=1)
    eng = _engine(cfg, ours, batch_slots=1, fault_injector=fi,
                  max_retries=1, retry_backoff_s=0.5)
    reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
    eng.submit(reqs[0])
    for _ in range(200):
        eng.step()
        if eng._retryq:
            break
    assert eng._retryq and not any(s.active for s in eng._lanes)
    eng.submit(reqs[1])   # arrives during the backoff
    st = eng.drain()
    assert reqs[0].status is RequestStatus.OK and reqs[0].retries == 1
    assert reqs[1].status is RequestStatus.OK and reqs[1].retries == 0
    for rb, ri in zip(b_reqs, reqs):
        np.testing.assert_array_equal(ri.output, rb.output)
    assert st["retry_backoff_s"] > 0.0


def test_temperature_identity_split_across_runs(served):
    cfg, ours = served

    def mk():
        return [Request(prompt=np.asarray([2, 7, 1, 8], np.int32) * (i + 1)
                        % cfg.vocab_size, max_new_tokens=6, temperature=0.9)
                for i in range(4)]

    batch = mk()
    _engine(cfg, ours).run(batch)
    split = _engine(cfg, ours)
    first, second = mk()[:2], mk()[2:]
    split.run(first)
    split.run(second)   # the arrival count continues at 2
    for rb, ri in zip(batch, first + second):
        assert ri.seed == rb.seed
        np.testing.assert_array_equal(ri.output, rb.output)


# -- streaming ----------------------------------------------------------------


def test_on_token_streams_in_emit_order_once(served):
    cfg, ours = served
    streamed = {}
    eng = _engine(cfg, ours, on_token=lambda r, t: streamed.setdefault(
        id(r), []).append(t))
    reqs = _mk_reqs(cfg)
    _drive(eng, reqs, arrivals=[0, 0, 3, 3])
    for r in reqs:
        assert r.status is RequestStatus.OK
        assert streamed[id(r)] == r.output.tolist()


def test_on_token_never_replays_carried_tokens(served):
    cfg, ours = served
    streamed = []
    fi = FaultInjector().inject_nan(lane=0, block=2)
    eng = _engine(cfg, ours, batch_slots=1, fault_injector=fi,
                  max_retries=1, retry_backoff_s=0.0,
                  on_token=lambda r, t: streamed.append(t))
    req = Request(prompt=np.arange(1, 7, dtype=np.int32),
                  max_new_tokens=16)
    eng.run([req])
    assert req.status is RequestStatus.OK and req.retries == 1
    assert streamed == req.output.tolist()


# -- clocks -------------------------------------------------------------------


def test_deadline_measured_from_submit_not_window(served):
    cfg, ours = served
    eng = _engine(cfg, ours)
    warm = [Request(prompt=p, max_new_tokens=4) for p in _prompts(cfg, n=2)]
    eng.run(warm)
    time.sleep(0.3)   # the window clock is now stale
    req = eng.submit(Request(prompt=np.asarray([3, 1, 4, 1, 5], np.int32),
                             max_new_tokens=4, deadline_s=1.0))
    eng.drain()
    assert req.status is RequestStatus.OK, req.error
    assert len(req.output) == 4
    assert req.ttft_s is not None and req.ttft_s < 1.0


# -- no busy-spin in retry-backoff windows ------------------------------------


def test_retry_backoff_sleeps_instead_of_spinning(served):
    cfg, ours = served
    fi = FaultInjector().inject_nan(lane=0, block=1)
    eng = _engine(cfg, ours, batch_slots=1, fault_injector=fi,
                  max_retries=1, retry_backoff_s=1.0)
    req = Request(prompt=np.arange(1, 7, dtype=np.int32), max_new_tokens=8)
    eng.run([req])
    st = eng.stats
    assert req.status is RequestStatus.OK and req.retries == 1
    assert st["retry_backoff_s"] >= 0.5
    assert st["idle_sleeps"] == 1
    assert st["idle_wait_s"] >= 0.25
    assert st["scheduler_beats"] <= (st["decode_blocks"]
                                     + st["prefill_chunks"]
                                     + st["idle_sleeps"] + 8)


# -- window vs lifetime stats -------------------------------------------------


def test_two_runs_account_faults_per_window_and_lifetime(served):
    cfg, ours = served
    fi = FaultInjector().inject_nan(lane=0, block=1)
    eng = _engine(cfg, ours, batch_slots=1, fault_injector=fi,
                  max_retries=1, retry_backoff_s=0.0)
    outs = []
    for _ in range(2):
        req = Request(prompt=np.arange(1, 7, dtype=np.int32),
                      max_new_tokens=8)
        eng.run([req])
        assert req.status is RequestStatus.OK and req.retries == 1
        assert eng.stats["faults_injected"] == 1
        assert eng.stats["requests_retried"] == 1
        assert eng.stats["requests_completed"] == 1
        outs.append(req.output.tolist())
    assert outs[0] == outs[1]
    lt = eng.lifetime
    assert lt["windows"] == 2
    assert lt["arrivals"] == 2
    assert lt["faults_injected"] == 2
    assert lt["requests_retried"] == 2
    assert lt["retries_total"] == 2
    assert lt["requests_completed"] == 2
    assert lt["total_new_tokens"] == sum(len(o) for o in outs)


# -- lifecycle edges ----------------------------------------------------------


def test_idle_step_and_close(served):
    cfg, ours = served
    eng = _engine(cfg, ours)
    out = eng.step()
    assert isinstance(out, StepOutcome)
    assert not out.worked and out.remaining == 0 and out.idle_until is None
    eng.drain()
    eng.drain()
    assert eng.lifetime["windows"] == 1
    eng.close()
    with pytest.raises(RuntimeError):
        eng.submit(Request(prompt=np.asarray([1, 2], np.int32),
                           max_new_tokens=2))
    assert not eng.step().worked
