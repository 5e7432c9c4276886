"""The port's mesh engine against its single-device engine over every
serving mode, the counterpart of
``tests/test_multidevice.py::test_mesh_token_identity_sweep``: contiguous,
paged, and paged with prefix sharing, each device-resident and
host-driven, greedy and sampled requests, on meshes (1, 1), (2, 1),
(1, 2) and (2, 2).  One launch a world size (``tests/torch_mesh_helpers.py``):
a world of 2 runs both of its shapes.

Per configuration: the single-device engine with ``kv_splits=2`` emits its
own tokens without split-K; the mesh engine emits them too; a
device-resident mesh engine waits on no readback in steady state
(``steady_state_syncs_per_block == 0.0``); a paged one audits clean.
"""

import pytest
from torch_mesh_helpers import launch

SHAPES = {1: ((1, 1),), 2: ((2, 1), (1, 2)), 4: ((2, 2),)}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_token_identity_sweep(tmp_path, world):
    body = f"SHAPES = {SHAPES[world]!r}\n" + """
MODES = (dict(),
         dict(paged=True, page_size=4, kv_pages=40),
         dict(paged=True, page_size=4, kv_pages=40,
              enable_prefix_sharing=True))
checked = 0
for mode in MODES:
    for dev in (True, False):
        base, _ = run_engine(PROMPTS, device_sched=dev, **mode)
        base_kv, _ = run_engine(PROMPTS, device_sched=dev, kv_splits=2,
                                **mode)
        assert base == base_kv, (mode, dev, "kv_splits single-device")
        for shape in SHAPES:
            out, eng = run_engine(PROMPTS, device_sched=dev,
                                  mesh=mesh_of(shape),
                                  shard_kv=shape[1] > 1, **mode)
            assert out == base, (mode, dev, shape, out, base)
            if dev:
                assert eng.stats["steady_state_syncs_per_block"] == 0.0, \\
                    (mode, shape, eng.stats)
            if eng.paged:
                assert eng.audit()["ok"]
            checked += 1
assert checked == 6 * len(SHAPES)
finish("IDENTITY_SWEEP_OK")
"""
    launch(tmp_path, body, world, "IDENTITY_SWEEP_OK")
