"""Clock-driven decisions of a mesh engine are agreed across ranks.

Every rank of a mesh engine runs the same host scheduler, so a decision
that reads the wall clock (a request's ``deadline_s``, a retry's backoff)
must be taken the same way on every rank, or the ranks issue different
collectives and hang or mix rows.  The engine reads each rank's clock once
a beat, combines the flags by one MAX all-reduce over a gloo group, and
acts on the combined flags; the idle wait before a retry is the least over
ranks.

The tests launch gloo ranks (``tests/torch_mesh_helpers.py``) and skew one
rank's ``time.perf_counter``: from a given beat on, rank 1's clock reads
10^4 s ahead.  A deadline of 10^3 s then expires on rank 1 only, and a
retry backoff of ~10^2 s elapses on rank 1 only.  Every rank must end
with the same tokens and statuses, equal to a single-device engine whose
clock jumps at the same beat (it takes the same decisions at the same
beats).  Each launch has its own wall-clock limit, so a hang fails the
test, not the suite.  The ``block_deadline_s`` watchdog, which fires while
a collective may be stuck, is refused on a world of more than one rank;
MoE is taken there (each rank routes its data shard's rows, as JAX's
``shard_map`` engine does).
"""

from torch_mesh_helpers import launch

_SKEW = """
import time

REAL = time.perf_counter
SKEW = {"eng": None, "beat": None}


def skewed():
    e = SKEW["eng"]
    if (e is not None and SKEW["beat"] is not None
            and e.stats["scheduler_beats"] >= SKEW["beat"]):
        return REAL() + 1e4
    return REAL()


time.perf_counter = skewed


def serve(prompts, news, skew_beat, mesh=None, fault=None, **kw):
    kw.update(max_seq=32, batch_slots=2, prefill_chunk=4, decode_block=2)
    eng = ServingEngine(cfg, packed, device="cpu", mesh=mesh, **kw)
    if fault is not None:
        eng.fault_injector = fault()
    reqs = [Request(prompt=p, max_new_tokens=n, **extra)
            for p, (n, extra) in zip(prompts, news)]
    # the single-device reference skews on the rank that skews
    SKEW["eng"], SKEW["beat"] = (eng, skew_beat) if RANK == 1 else (None,
                                                                     None)
    eng.run(reqs)
    SKEW["eng"] = None
    return ([(r.output.tolist(), r.status.value) for r in reqs],
            dict(eng.stats))


def check(prompts, news, skew_beat, **kw):
    ref, ref_stats = serve(prompts, news, skew_beat, **kw)
    got, stats = serve(prompts, news, skew_beat, mesh=mesh_of((2, 1)), **kw)
    everyone = [None] * WORLD
    dist.all_gather_object(everyone, (got, ref))
    skewed_ref = everyone[1][1]   # the reference whose clock jumped
    for g, _ in everyone:
        assert g == everyone[0][0], everyone      # identical on every rank
        assert g == skewed_ref, (g, skewed_ref)
    assert stats["idle_wait_s"] < 5.0, stats["idle_wait_s"]
    return got, stats
"""


def test_mesh_deadlines_agree_under_a_skewed_clock(tmp_path):
    """Two of four requests carry a 10^3 s deadline; rank 1's clock jumps
    past it at beat 4, while one is live and one queued: both time out at
    that beat on every rank, keeping the tokens they had; the others
    finish OK."""
    body = _SKEW + """
prompts = PROMPTS
news = [(8, {}), (8, {"deadline_s": 1000.0}), (8, {}),
        (8, {"deadline_s": 1000.0})]
got, stats = check(prompts, news, skew_beat=4)
statuses = [s for _, s in got]
assert statuses == ["ok", "timeout", "ok", "timeout"], statuses
assert 0 < len(got[1][0]) < 8, got[1]      # timed out mid-decode
assert stats["requests_timed_out"] == 2
finish("MESH_DEADLINE_CLOCK_OK")
"""
    launch(tmp_path, body, 2, "MESH_DEADLINE_CLOCK_OK", timeout=240.0)


def test_mesh_retry_backoff_agrees_under_a_skewed_clock(tmp_path):
    """A NaN lane fails request 0 at block 1; it retries after a ~10^2 s
    backoff (``retry_backoff_s`` 100), which rank 1's clock passes at beat
    8 while other requests still decode: it re-enters the queue at that
    beat on every rank and completes with its uninterrupted tokens."""
    body = _SKEW + """
from repro_torch.serving import FaultInjector

news = [(8, {}) for _ in PROMPTS]
clean, _ = serve(PROMPTS, news, None)
got, stats = check(
    PROMPTS, news, skew_beat=8, max_retries=1, retry_backoff_s=100.0,
    fault=lambda: FaultInjector().inject_nan(lane=0, block=1))
assert [s for _, s in got] == ["ok"] * 4, got
assert [t for t, _ in got] == [t for t, _ in clean], (got, clean)
assert stats["retries_total"] == 1 and stats["idle_sleeps"] == 0
finish("MESH_RETRY_CLOCK_OK")
"""
    launch(tmp_path, body, 2, "MESH_RETRY_CLOCK_OK", timeout=240.0)


def test_mesh_refuses_watchdog_and_moe(tmp_path):
    """``block_deadline_s`` raises at construction on a world of 2 and an
    MoE config is taken there; without a mesh both are taken (the watchdog
    is the single-controller engine's)."""
    body = """
from repro_torch.configs import get_config as _get

mesh = mesh_of((2, 1))
try:
    ServingEngine(cfg, packed, device="cpu", max_seq=32, mesh=mesh,
                  block_deadline_s=1.0)
    raise AssertionError("block_deadline_s on a world of 2 was accepted")
except ValueError as e:
    assert "block_deadline_s" in str(e), e
moe_cfg = _get("mixtral-8x22b").reduced()
moe = transformer.pack_params(moe_cfg, transformer.init_params(
    moe_cfg, torch.Generator().manual_seed(0)))
# MoE on a world of 2 is taken (tests/test_torch_mesh_moe_engine.py)
eng = ServingEngine(moe_cfg, moe, device="cpu", max_seq=32, mesh=mesh)
assert eng.mesh_shape == (2, 1) and eng.slots_per_device == 2
ServingEngine(moe_cfg, moe, device="cpu", max_seq=32,
              block_deadline_s=1.0)       # no mesh: both taken
finish("MESH_REFUSALS_OK")
"""
    launch(tmp_path, body, 2, "MESH_REFUSALS_OK", timeout=180.0)
