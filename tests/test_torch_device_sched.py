"""The port's device-resident scheduler (``device_sched=True``, the default)
against its host-driven loop and against the JAX engine's device
scheduling, mirroring every case of ``tests/test_device_sched.py`` at its
sizes, on the reduced qwen1.5-0.5b with the JAX weights
(``convert.from_jax_packed``).

What is held:
  * the device-resident engine emits the host-driven engine's tokens
    exactly — contiguous, paged, paged with prefix sharing, an adversarial
    schedule — greedy and sampled (one sampler serves both modes);
  * in steady state the device engine waits on no readback
    (``steady_state_syncs_per_block == 0.0``) and the host-driven one on
    every block (1.0, ``host_block_syncs == decode_blocks``);
  * the JAX engine with ``device_sched=True`` on its Pallas attention emits
    the port's greedy tokens (a difference only where the port's oracle
    finds its token within a near-tie, printed);
  * Gumbel-max sampling draws tokens with the softmax's frequencies.

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
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.models.layers import Ctx
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import gumbel_noise, reference_decode, sample

SYNC_KEYS = ("host_block_syncs", "steady_state_blocks",
             "steady_state_syncs_per_block", "host_syncs_per_block")
NEAR_TIE = 1e-2


@pytest.fixture(scope="module")
def served():
    j_cfg = j_get_config("qwen1.5-0.5b").reduced()
    cfg = get_config("qwen1.5-0.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    return j_cfg, packed, cfg, ours


def _mixed_requests(cfg, seed=0, n=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(3, 10))).astype(np.int32)
               for _ in range(n)]
    news = [int(rng.integers(3, 8)) for _ in range(n)]
    return prompts, news


def _run_pair(cfg, ours, prompts, news, temperature=0.0, **kw):
    """The same requests through host- and device-scheduled engines;
    returns (host_engine, host_reqs, dev_engine, dev_reqs)."""
    def mk():
        return [Request(prompt=p, max_new_tokens=n, temperature=temperature)
                for p, n in zip(prompts, news)]

    host = ServingEngine(cfg, ours, device_sched=False, device="cpu", **kw)
    hr = host.run(mk())
    dev = ServingEngine(cfg, ours, device_sched=True, device="cpu", **kw)
    dr = dev.run(mk())
    return host, hr, dev, dr


def _assert_identical(host_reqs, dev_reqs):
    for rh, rd in zip(host_reqs, dev_reqs):
        assert rh.done and rd.done
        np.testing.assert_array_equal(rh.output, rd.output)


def _assert_sync_contract(host, dev):
    for key in SYNC_KEYS:
        assert key in host.stats and key in dev.stats
    assert host.stats["host_block_syncs"] == host.stats["decode_blocks"]
    assert host.stats["host_syncs_per_block"] == 1.0
    assert dev.stats["steady_state_syncs_per_block"] == 0.0
    assert dev.stats["host_block_syncs"] <= dev.stats["decode_blocks"]


# ---------------------------------------------------------------------------
# Equivalence sweep: contiguous / paged / paged+sharing x page sizes
# ---------------------------------------------------------------------------

def test_device_sched_contiguous_token_identity(served):
    _, _, cfg, ours = served
    prompts, news = _mixed_requests(cfg, seed=0)
    host, hr, dev, dr = _run_pair(cfg, ours, prompts, news, max_seq=32,
                                  batch_slots=2, prefill_chunk=4,
                                  decode_block=4)
    _assert_identical(hr, dr)
    _assert_sync_contract(host, dev)
    if host.stats["steady_state_blocks"]:
        assert host.stats["steady_state_syncs_per_block"] == 1.0


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_device_sched_paged_token_identity(served, page_size):
    _, _, cfg, ours = served
    prompts, news = _mixed_requests(cfg, seed=1)
    host, hr, dev, dr = _run_pair(cfg, ours, prompts, news, max_seq=32,
                                  batch_slots=2, prefill_chunk=4,
                                  decode_block=4, paged=True,
                                  page_size=page_size, kv_pages=32)
    _assert_identical(hr, dr)
    _assert_sync_contract(host, dev)


@pytest.mark.parametrize("page_size", [4, 5, 16])
def test_device_sched_prefix_sharing_token_identity(served, page_size):
    _, _, cfg, ours = served
    rng = np.random.default_rng(2)
    tpl = rng.integers(1, cfg.vocab_size, size=12).astype(np.int32)
    prompts = [np.concatenate([tpl, rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(1, 5))).astype(np.int32)])
        for _ in range(4)]
    news = [5, 4, 6, 3]
    host, hr, dev, dr = _run_pair(cfg, ours, prompts, news, max_seq=48,
                                  batch_slots=2, prefill_chunk=4,
                                  decode_block=4, paged=True,
                                  page_size=page_size, kv_pages=40,
                                  enable_prefix_sharing=True)
    _assert_identical(hr, dr)
    _assert_sync_contract(host, dev)
    assert dev.stats["prefix_hits"] == host.stats["prefix_hits"] > 0


# ---------------------------------------------------------------------------
# Steady state: long decode with all slots busy and nothing retiring
# ---------------------------------------------------------------------------

def test_device_sched_zero_syncs_in_steady_state(served):
    _, _, cfg, ours = served
    prompts = [np.asarray([1, 2, 3], np.int32), np.asarray([4, 5], np.int32)]
    news = [24, 24]   # both lanes decode together for 6 blocks of 4
    host, hr, dev, dr = _run_pair(cfg, ours, prompts, news, max_seq=32,
                                  batch_slots=2, prefill_chunk=4,
                                  decode_block=4)
    _assert_identical(hr, dr)
    assert dev.stats["steady_state_blocks"] >= 4
    assert dev.stats["steady_state_syncs_per_block"] == 0.0
    assert host.stats["steady_state_blocks"] >= 4
    assert host.stats["steady_state_syncs_per_block"] == 1.0
    assert (dev.stats["host_block_syncs"]
            <= dev.stats["decode_blocks"] - dev.stats["steady_state_blocks"])


# ---------------------------------------------------------------------------
# Adversarial schedule: tight page pool (deferral) + mid-flight retire +
# refill + prefix sharing, through the one-block-behind readback
# ---------------------------------------------------------------------------

def test_device_sched_adversarial_schedule(served):
    _, _, cfg, ours = served
    rng = np.random.default_rng(7)
    tpl = rng.integers(1, cfg.vocab_size, size=8).astype(np.int32)
    prompts, news = [], []
    for i in range(7):
        if i % 2 == 0:   # template-sharing requests between cold ones
            tail = rng.integers(1, cfg.vocab_size,
                                size=int(rng.integers(1, 4))).astype(np.int32)
            prompts.append(np.concatenate([tpl, tail]))
        else:
            prompts.append(rng.integers(
                1, cfg.vocab_size,
                size=int(rng.integers(2, 9))).astype(np.int32))
        news.append(int(rng.integers(2, 9)))
    # 12 usable 4-token pages hold two lanes' worst cases (<= 5 pages each)
    # but not always a third: retire-then-refill churn
    host, hr, dev, dr = _run_pair(cfg, ours, prompts, news, max_seq=32,
                                  batch_slots=3, prefill_chunk=4,
                                  decode_block=4, paged=True, page_size=4,
                                  kv_pages=13, enable_prefix_sharing=True)
    _assert_identical(hr, dr)
    _assert_sync_contract(host, dev)
    assert dev.stats["mid_flight_admissions"] >= 1
    assert dev.stats["prefix_hits"] >= 1
    assert (dev.stats["kv_pages_in_use"]
            <= dev.stats["kv_prefix_cached_pages"])


# ---------------------------------------------------------------------------
# Stats plumbing
# ---------------------------------------------------------------------------

def test_sync_counters_present_and_consistent(served):
    _, _, cfg, ours = served
    prompts, news = _mixed_requests(cfg, seed=3, n=3)
    host, hr, dev, dr = _run_pair(cfg, ours, prompts, news, max_seq=32,
                                  batch_slots=2, prefill_chunk=4,
                                  decode_block=4)
    for eng in (host, dev):
        st = eng.stats
        for key in SYNC_KEYS:
            assert key in st, key
        assert st["decode_tokens"] == sum(news) - st["admissions"]
        assert st["host_block_syncs"] >= 0
        assert st["steady_state_blocks"] <= st["decode_blocks"]


# ---------------------------------------------------------------------------
# Against the JAX engine's device scheduling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_device_sched_matches_jax_device_engine(served, paged):
    """The mixed requests through JAX's device-scheduled engine (Pallas
    attention, interpret mode) and the port's: the same greedy tokens, or a
    first difference where the port's oracle finds the port's token within
    a near-tie of its own choice (printed)."""
    j_cfg, packed, cfg, ours = served
    prompts, news = _mixed_requests(cfg, seed=1 if paged else 0)
    kw = dict(max_seq=32, batch_slots=2, prefill_chunk=4, decode_block=4)
    if paged:
        kw.update(paged=True, page_size=5, kv_pages=32)
    j_reqs = [JRequest(prompt=p, max_new_tokens=n)
              for p, n in zip(prompts, news)]
    JServingEngine(j_cfg, packed, ctx=JCtx(mode="packed",
                                           group_size=j_cfg.group_size,
                                           attn_impl="pallas"),
                   device_sched=True, **kw).run(j_reqs)
    reqs = ServingEngine(cfg, ours, device="cpu", **kw).run(
        [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)])
    for r, jr in zip(reqs, j_reqs):
        got, want = r.output.tolist(), jr.output.tolist()
        if got != want:
            _, gaps = reference_decode(cfg, ours, Ctx(), r.prompt, len(got),
                                       kw["max_seq"], follow=r.output)
            i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            print(f"port vs JAX device engine: first flip at emit index {i}, "
                  f"port's oracle gap {gaps[i]:.2e}")
            assert max(gaps) < NEAR_TIE, (got, want, gaps)
        assert len(got) == len(want)


# ---------------------------------------------------------------------------
# Temperature sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_device_sched_sampled_token_identity(served, paged):
    """With temperature the two modes draw the same tokens: the sampler is
    one function of (seed, emit index, logits) in both."""
    _, _, cfg, ours = served
    prompts, news = _mixed_requests(cfg, seed=4, n=5)
    kw = dict(max_seq=32, batch_slots=2, prefill_chunk=4, decode_block=4)
    if paged:
        kw.update(paged=True, page_size=5, kv_pages=12)
    host, hr, dev, dr = _run_pair(cfg, ours, prompts, news, temperature=0.9,
                                  **kw)
    _assert_identical(hr, dr)
    greedy = ServingEngine(cfg, ours, device="cpu", **kw).run(
        [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)])
    assert any(g.output.tolist() != d.output.tolist()
               for g, d in zip(greedy, dr))   # the draws are not argmax


def test_gumbel_max_frequencies_match_softmax():
    """Over 2^14 draws (distinct seeds, then distinct emit indices of one
    seed) the token frequencies are the softmax of logits / t within 0.015
    (4 standard deviations of a frequency near 0.25 at this count is
    0.014).  The noise is a function of (seed, emit index, vocab index)
    alone and lies strictly inside the Gumbel's support."""
    n, t = 1 << 14, 0.7
    logits = torch.tensor([1.0, 0.2, -0.5, 0.9, 0.0, -1.5, 0.4, 0.6])
    want = torch.softmax(logits / t, dim=0)
    idx = torch.arange(n)
    for seeds, emit in ((idx + 12345, torch.zeros(n, dtype=torch.long)),
                        (torch.full((n,), 99), idx)):
        toks = sample(logits.expand(n, -1), seeds, emit,
                      torch.full((n,), t))
        freq = torch.bincount(toks, minlength=len(logits)).float() / n
        assert (freq - want).abs().max() <= 0.015, (freq, want)
    g = gumbel_noise(torch.tensor([3, 3, 4]), torch.tensor([5, 5, 5]), 1000)
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert torch.isfinite(g).all()
    # greedy rows stay the first maximum, bit for bit
    tied = torch.tensor([[0.5, 2.0, 2.0, 1.0]])
    assert sample(tied, [1], [0], [0.0]).tolist() == [1]
