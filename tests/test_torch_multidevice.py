"""Multi-rank serving in the port: ``ServingEngine(mesh=DeviceMesh)`` on
gloo ranks emits the single-device port engine's tokens, the counterpart
of ``tests/test_multidevice.py`` (whose identity sweep is
``tests/test_torch_multidevice_sweep.py``).

The mesh has axes ("data", "model"): each rank holds its data shard's
slots (scheduler state, block table rows, contiguous cache rows) and a
paged pool written only for them, the decode block's outputs are
all-gathered over "data", and ranks of one data index split the split-K
decode attention chunks over "model", all-gathering the partials in rank
order.  Every rank runs the same host scheduler.

The ranks are launched by ``python -m torch.distributed.run`` on the CPU
(``tests/torch_mesh_helpers.py``), one launch a test over its
configurations; a launch takes some 5-15 s.  On one H100 only a world of
one can run (``chip_smoke.py`` phase 4f); a check across cards waits for a
machine with more of them.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import pytest
from torch_mesh_helpers import launch


def test_mesh_nondivisible_slots_and_kv(tmp_path):
    """3 requested slots on a 2-wide data axis pad the slot batch (the
    padded lane is never assigned); max_seq 31 pads the split-K tail.  The
    tokens stay the single-device ones and the engine keeps the requested
    capacity."""
    body = """
prompts = PROMPTS + [np.asarray([5, 5, 5], np.int32)]
base, _ = run_engine(prompts, max_new=8, max_seq=31, batch_slots=3,
                     kv_splits=2)
plain, _ = run_engine(prompts, max_new=8, max_seq=31, batch_slots=3)
assert base == plain, (base, plain)
for mode in (dict(), dict(paged=True, page_size=4)):
    out, eng = run_engine(prompts, max_new=8, max_seq=31, batch_slots=3,
                          mesh=mesh_of((2, 2)), shard_kv=True, **mode)
    assert eng.slots == 4 and eng.requested_slots == 3, eng.slots
    assert eng.slots_per_device == 2 and eng.mesh_shape == (2, 2)
    assert eng.kv_splits == 2 and eng.ctx.kv_group_size == 2
    assert out == base, (mode, out, base)
    # 5 requests on 3 usable slots: refills, never a 4th lane
    assert eng.stats["mid_flight_admissions"] > 0
    assert not eng._lanes[3].gen and eng.audit()["ok"]
finish("NONDIVISIBLE_OK")
"""
    launch(tmp_path, body, 4, "NONDIVISIBLE_OK")


def test_mesh_prefix_sharing_grant_cow_audit(tmp_path):
    """Identical prompt prefixes land on both data shards: the trie's
    per-shard namespaces keep every grant and copy-on-write split inside
    the shard that wrote the pages.  Tokens stay the single-device ones,
    CoW fires, audit() stays clean across a second run."""
    body = """
donor = np.asarray(list(range(1, 18)), np.int32)
prompts = [donor] + [
    np.concatenate([donor[:14], np.asarray([90 + i, 80 + i], np.int32)])
    for i in range(7)]
kw = dict(batch_slots=4, paged=True, page_size=4, kv_pages=64,
          enable_prefix_sharing=True, prefill_chunk=2)
base, beng = run_engine(prompts, max_new=6, temps=False, **kw)
assert beng.stats["kv_cow_splits"] > 0
out, eng = run_engine(prompts, max_new=6, temps=False, mesh=mesh_of((2, 2)),
                      shard_kv=True, **kw)
assert out == base, (out, base)
assert eng.stats["prefix_hits"] > 0 and eng.stats["kv_cow_splits"] > 0
assert eng.audit()["ok"]
# every indexed page is in the namespace of the shard that registered it
stack = [eng._prefix.root]
namespaces = set()
while stack:
    node = stack.pop()
    stack.extend(node.children.values())
    if node.key is not None:
        namespaces.add(node.key[0])
assert namespaces == {0, 1}, namespaces
reqs2 = [Request(prompt=p, max_new_tokens=6) for p in prompts[:4]]
eng.run(reqs2)
assert [r.output.tolist() for r in reqs2] == base[:4]
assert eng.audit()["ok"]
finish("SHARING_COW_OK")
"""
    launch(tmp_path, body, 4, "SHARING_COW_OK")


def test_mesh_splitk_combine_bitwise_real_mesh(tmp_path):
    """``decode_attention_splitk_sharded`` over gloo groups of 2 (the model
    axis of a 2x2 mesh) and 4 (of a 1x4 mesh) equals one
    ``decode_attention_splitk(num_splits=K)`` call bit for bit, at the
    JAX test's lengths, prime and non-divisible ones included."""
    body = """
from repro_torch.kernels.decode_attention import ops as da_ops

groups = {2: mesh_of((2, 2)).get_group("model"),
          4: mesh_of((1, 4)).get_group("model")}
for s in (257, 256, 101, 31):
    g = torch.Generator().manual_seed(s)
    q = torch.randn((1, 4, 1, 32), generator=g)
    k = torch.randn((1, 2, s, 32), generator=g)
    v = torch.randn((1, 2, s, 32), generator=g)
    clen = torch.tensor(s - 3)
    for mm, group in groups.items():
        for K in (mm, 2 * mm):
            ref = da_ops.decode_attention_splitk(q, k, v, clen, num_splits=K)
            out = da_ops.decode_attention_splitk_sharded(
                q, k, v, clen, group=group, num_splits=K)
            assert torch.equal(out, ref), (s, mm, K)
        try:
            da_ops.decode_attention_splitk_sharded(q, k, v, clen, group=group,
                                                   num_splits=mm + 1)
            raise AssertionError("an untileable split count passed")
        except ValueError as e:
            assert "model" in str(e)
finish("SPLITK_MESH_BITWISE_OK")
"""
    launch(tmp_path, body, 4, "SPLITK_MESH_BITWISE_OK")


def test_mesh_smoke_2x2(tmp_path):
    """2x2 mesh, paged with sharing, device-resident: the single-device
    tokens, no gating readback in steady state, audit clean."""
    body = """
kw = dict(paged=True, page_size=4, kv_pages=40, enable_prefix_sharing=True)
base, _ = run_engine(PROMPTS, **kw)
out, eng = run_engine(PROMPTS, mesh=mesh_of((2, 2)), shard_kv=True, **kw)
assert out == base, (out, base)
assert eng.stats["steady_state_syncs_per_block"] == 0.0
assert eng.audit()["ok"]
assert eng.mesh_shape == (2, 2) and eng.slots_per_device == 2
finish("MESH_SMOKE_2X2_OK")
"""
    launch(tmp_path, body, 4, "MESH_SMOKE_2X2_OK")


_HEAL = """
KW = dict(max_seq=32, batch_slots=2, paged=True, page_size=4, kv_pages=24,
          enable_prefix_sharing=True, prefill_chunk=4, decode_block=4)
REC = dict(max_retries=4, retry_backoff_s=0.0, retry_breaker_threshold=99,
           probe_cooldown_blocks=1, audit_on_retire=True)


def prompts(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size,
                         size=int(rng.integers(3, 9))).astype(np.int32)
            for _ in range(n)]


def reqs(ps):
    return [Request(prompt=p, max_new_tokens=10) for p in ps]


beng = ServingEngine(cfg, packed, device="cpu", **KW)
brs = reqs(prompts())
beng.run(brs)
baseline = [r.output.tolist() for r in brs]
eng = ServingEngine(cfg, packed, device="cpu", mesh=mesh_of((2, 2)),
                    shard_kv=True, **KW, **REC)
healed = retried = promoted = 0
for seed in SEEDS:
    eng.fault_injector = FaultInjector.random_schedule(
        seed, slots=2, n_faults=3, max_block=8, max_alloc=12,
        transient=True)
    rs = reqs(prompts())
    eng.run(rs)
    for r, b in zip(rs, baseline):
        assert r.status in (RequestStatus.OK, RequestStatus.DEGRADED), \\
            (seed, r.status, r.error)
        assert r.output.tolist() == b, (seed, r.error)
    assert eng.audit()["ok"]
    healed += 1
    retried += eng.stats["retries_total"]
    promoted += eng.stats["repromotions"]
assert healed == len(SEEDS)
"""


def test_mesh_transient_faults_self_heal(tmp_path):
    """Seeded transient fault schedules on a 2x2 paged-sharing mesh engine
    heal to OK/DEGRADED with the uninterrupted single-device tokens: retry
    replay, degrade and re-promotion cross the host/device seam on every
    shard, with ``audit_on_retire`` at every transition."""
    body = "SEEDS = range(4)\n" + _HEAL + """
assert retried > 0 and promoted > 0, (retried, promoted)
finish("MESH_FAULTS_HEAL_OK")
"""
    launch(tmp_path, body, 4, "MESH_FAULTS_HEAL_OK")


def test_mesh_transient_schedules_recover_property(tmp_path):
    """The self-healing property on the 2x2 mesh engine over drawn pairs of
    seeds (the counterpart of ``tests/test_recovery.py::
    test_mesh_transient_schedules_recover_property``): one launch runs the
    drawn seeds against one resident mesh engine."""
    hyp = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hyp.settings(max_examples=1, deadline=None, database=None,
                  suppress_health_check=list(hyp.HealthCheck))
    @hyp.given(seeds=st.lists(st.integers(min_value=0,
                                          max_value=2 ** 31 - 1),
                              min_size=2, max_size=2, unique=True))
    def prop(seeds):
        body = f"SEEDS = {tuple(seeds)}\n" + _HEAL + """
finish("MESH_HEAL_PROPERTY_OK")
"""
        launch(tmp_path, body, 4, "MESH_HEAL_PROPERTY_OK")

    prop()


def test_mesh_validation_errors(tmp_path):
    """Wrong axis names and bad split counts fail at construction with the
    JAX engine's messages; a (1, 1) mesh engine has the single-device
    engine's semantics and tokens; a gloo mesh may drive the card too
    (ranks sharing one card, each collective staged through host
    memory)."""
    body = """
import pytest
from repro_torch.serving.engine import check_mesh

bad = init_device_mesh("cpu", (1, 1), mesh_dim_names=("x", "model"))
with pytest.raises(ValueError, match="axis_names"):
    ServingEngine(cfg, packed, max_seq=16, device="cpu", mesh=bad)
with pytest.raises(ValueError, match="kv_splits"):
    ServingEngine(cfg, packed, max_seq=16, device="cpu",
                  mesh=mesh_of((1, 1)), kv_splits=0)
with pytest.raises(ValueError, match="kv_splits"):
    ServingEngine(cfg, packed, max_seq=16, device="cpu", kv_splits=0)
assert check_mesh(mesh_of((1, 1)), torch.device("cuda")) == (1, 1)
assert check_mesh(mesh_of((1, 1)), torch.device("cpu")) == (1, 1)
eng = ServingEngine(cfg, packed, max_seq=16, device="cpu",
                    mesh=mesh_of((1, 1)))
assert eng.mesh_shape == (1, 1) and not eng.shard_slots \\
    and not eng.shard_kv and eng.kv_splits == 0
base, _ = run_engine(PROMPTS)
out, _ = run_engine(PROMPTS, mesh=mesh_of((1, 1)))
assert out == base
finish("VALIDATION_OK")
"""
    launch(tmp_path, body, 1, "VALIDATION_OK")


def test_serving_specs_match_jax():
    """``runtime.sharding.serving_specs`` states the JAX layout: the slot
    axis on 'data' for state, block table, outputs and contiguous cache
    rows; paged pools whole on every rank.  A one-rank gloo world in this
    process, torn down after."""
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.runtime import sharding as j_sharding
    from repro_torch.runtime import sharding

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        j_mesh = compat.make_mesh((1, 1), ("data", "model"))
        for paged in (False, True):
            for kv_quant in (False, True):
                for shard in (False, True):
                    kw = dict(slots=4, paged=paged, kv_quant=kv_quant,
                              shard_slots=shard)
                    got = sharding.serving_specs(mesh, **kw)
                    want = j_sharding.serving_specs(j_mesh, **kw)
                    assert got["slot_ax"] == want["slot_ax"]
                    for name in ("state", "bt", "tokens", "blk"):
                        assert P(*got[name]) == want[name], name
                    for plane, spec in got["cache"].items():
                        # P() and an all-None spec state the same layout
                        assert P(*spec) == want["cache"][plane] or (
                            not any(spec) and want["cache"][plane] == P())
        assert sharding.local_shape(mesh, ("data", None), (4, 3)) == (4, 3)
    finally:
        dist.destroy_process_group()
