"""MoE training on a ("data", "model") mesh of gloo ranks against the
single-device step, with the gates and the runner of
``tests/test_torch_sharded_training.py`` (the single-device quantized
values replayed on each rank: an expert buffer row keyed by its (expert,
row), ``sharding.Rows``).

Expert capacity over the global batch: JAX trains under ``jit`` over a
sharded batch, so capacity ``max(int(n * k / E * cf), k)`` and the
exclusive positions count every token of the (micro)batch, not a rank's
own.  Reduced mixtral at its own capacity factor 1.25, on a batch whose
single-device step drops (token, slot) pairs (asserted): ``dpzero1`` on
(2, 1) and (2, 2); a token chunk (``Ctx.moe_token_chunk``) inside each
rank's rows, and one whose chunks straddle two ranks' rows on (4, 1); two
microbatches under ``2d`` on (2, 1), whose rows are JAX's microbatches
(global rows [j b / M, (j + 1) b / M)), not each rank's j-th block.  The
token-chunk cases run with the quantizers free: a rank dispatches its
part of a chunk where one device dispatches the whole chunk, so the
recorded calls do not line up one for one.

Expert-parallel steps on a "model" axis: reduced mixtral at 1.25 and
dbrx (4 experts, top-4) on (1, 2) and (2, 2) ``2d``, FSDP off and on;
mixtral with 3 experts, which "model" does not divide (the banks split
inside each expert, gathered and cut by expert); mixtral under sequence
parallelism.  And two steps of mixtral at 1.25 on (2, 2) against JAX's
jitted single-device step on the same converted weights.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticLMDataset as JData
from repro.models import transformer as j_transformer
from repro.models.layers import Ctx as JCtx
from repro.optim import adamw as j_adamw  # the function
from repro.training import make_train_step as j_make_train_step

from test_torch_sharded_training import (
    _case, _run, check_against_the_single_device_step)
from torch_mesh_helpers import launch

MIX = "mixtral-8x22b"

C8_2 = [
    _case("mixtral 1.25 (2, 1) dpzero1", MIX, [2, 1], "dpzero1"),
    _case("mixtral 1.25 (2, 1) dpzero1 token chunk 32", MIX, [2, 1],
          "dpzero1", ctx=dict(moe_token_chunk=32), pinned=False),
    _case("mixtral 1.25 (2, 1) 2d 2 microbatches", MIX, [2, 1], micro=2),
]
C8_4 = [
    _case("mixtral 1.25 (2, 2) dpzero1", MIX, [2, 2], "dpzero1"),
    # 128 tokens in chunks of 64 over four ranks of 32: a chunk straddles
    _case("mixtral 1.25 (4, 1) dpzero1 token chunk 64", MIX, [4, 1],
          "dpzero1", ctx=dict(moe_token_chunk=64), pinned=False),
]
EP_2 = [
    _case("mixtral 1.25 (1, 2) 2d", MIX, [1, 2]),
    _case("mixtral 1.25 (1, 2) 2d fsdp", MIX, [1, 2], fsdp=True),
    _case("dbrx (1, 2) 2d", "dbrx-132b", [1, 2]),
    _case("dbrx (1, 2) 2d fsdp", "dbrx-132b", [1, 2], fsdp=True),
    # 3 experts on 2 model ranks: each expert's n_out split, gathered
    _case("mixtral 3 experts (1, 2) 2d", MIX, [1, 2],
          cfg=dict(n_experts=3)),
    _case("mixtral 1.25 (1, 2) 2d sp", MIX, [1, 2], sp=True),
]
EP_4 = [
    _case("mixtral 1.25 (2, 2) 2d", MIX, [2, 2]),
    _case("mixtral 1.25 (2, 2) 2d fsdp", MIX, [2, 2], fsdp=True),
    _case("dbrx (2, 2) 2d", "dbrx-132b", [2, 2]),
    _case("dbrx (2, 2) 2d fsdp", "dbrx-132b", [2, 2], fsdp=True),
]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {**_run(tmp_path_factory, C8_2 + EP_2, 2),
            **_run(tmp_path_factory, C8_4 + EP_4, 4)}


@pytest.mark.parametrize("case", [c["name"] for c in C8_2 + C8_4])
def test_moe_capacity_counts_the_global_batch(results, case):
    """The case drops pairs on one device (so a rank counting only its own
    tokens would keep others), and the mesh step is the single-device
    step's."""
    assert results[case]["drops"] >= 1, results[case]
    check_against_the_single_device_step(results[case])


@pytest.mark.parametrize("case", [c["name"] for c in EP_2 + EP_4])
def test_moe_expert_parallel_step_matches_the_single_device_step(results,
                                                                 case):
    check_against_the_single_device_step(results[case])


MIXTRAL_BODY = '''
import numpy as np
from repro_torch import convert
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh
from repro_torch.testing import pinned_quantizers
from repro_torch.training import make_train_step_sharded

cfg = get_config("mixtral-8x22b").reduced(**%(reduced)r)


def nested(path):
    nest = {}
    for k, v in np.load(path).items():
        d = nest
        *parents, leaf = k.split("/")
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return nest


mesh = TrainMesh((2, 2))
ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=8, attn_kv_chunk=8)
data = SyntheticLMDataset(cfg, batch=4, seq_len=32, seed=0, device="cpu")
out = []
for i in range(2):
    full = convert.from_jax_params(cfg, nested(f"params_{i}.npz"),
                                   device="cpu")
    tape = [torch.from_numpy(v) for v in np.load(f"tape_{i}.npz").values()]
    for pin in (False, True):
        opt = adamw(lr=1e-3)
        params = sharding.shard_params(mesh, full, fsdp=False)
        step = make_train_step_sharded(cfg, ctx, opt, mesh, global_batch=4,
                                       loss_chunk=16)
        with (pinned_quantizers(tape, replay=True) if pin
              else contextlib.nullcontext()):
            _, _, m = step(params, opt.init(params), data.batch_at(i))
        out.append(float(m["loss"]))
if RANK == 0:
    print("LOSSES " + " ".join(repr(x) for x in out), flush=True)
finish("MIXTRAL_OK")
'''


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _remat_tape(outs: list, n_blocks: int) -> dict:
    """JAX's quantized values of one unrolled forward, in the order a
    step under per-block remat calls the quantizers: every block, then
    each block again from the last (its recomputation in the backward)."""
    per = len(outs) // n_blocks
    assert per * n_blocks == len(outs)
    blocks = [outs[i * per:(i + 1) * per] for i in range(n_blocks)]
    order = outs + [v for b in reversed(blocks) for v in b]
    return {f"{i:04d}": v for i, v in enumerate(order)}


def test_mixtral_on_a_2x2_mesh_matches_jax_jitted_step(tmp_path):
    """Two jitted JAX steps of reduced mixtral at capacity factor 1.25; the
    port takes each step on a (2, 2) mesh (experts split over "model", the
    batch over "data"), FSDP off, from JAX's masters of that step.  Each
    loss within 2e-5 of JAX's (relative) with the quantizers free, or, as
    ``tests/test_torch_training_archs.py`` holds one device: the gap's
    cause shown on one device (``_explain_gap``: an int8 code moved by one
    from f32 inputs a few ULPs apart, or a token rerouted at a router
    near-tie) and JAX's quantized values replayed on the mesh, each rank
    its block (``pinned_quantizers``), within 2e-5."""
    from test_torch_training_archs import (J_CTX, _explain_gap,
                                           _jax_recorded_forward, _np_tree)
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_params
    reduced = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                   vocab_size=128)
    j_cfg = j_get_config("mixtral-8x22b").reduced(**reduced)
    cfg = get_config("mixtral-8x22b").reduced(**reduced)
    assert j_cfg.capacity_factor == 1.25 and j_cfg.n_experts == 4
    params = j_transformer.init_params(j_cfg, jax.random.PRNGKey(0))
    opt = j_adamw(lr=1e-3)
    state = opt.init(params)
    step = jax.jit(j_make_train_step(j_cfg, J_CTX, opt, loss_chunk=16))
    data = JData(j_cfg, batch=4, seq_len=32, seed=0)
    want, masters = [], []
    for i in range(2):
        b = data.batch_at(i)
        np.savez(tmp_path / f"params_{i}.npz", **_flat(params))
        _, _, outs, _ = _jax_recorded_forward(j_cfg, params,
                                              np.asarray(b["inputs"]))
        np.savez(tmp_path / f"tape_{i}.npz",
                 **_remat_tape(outs, j_cfg.n_layers))
        masters.append((params, np.asarray(b["inputs"])))
        params, state, m = step(params, state, b)
        want.append(float(m["loss"]))
    body = "import contextlib\n" + MIXTRAL_BODY % dict(reduced=reduced)
    out = launch(tmp_path, body, 4, "MIXTRAL_OK", timeout=240)
    line = next(x for x in out.splitlines() if x.startswith("LOSSES "))
    got = [float(x) for x in line.split()[1:]]
    assert all(np.isfinite(got)), got
    for i, w in enumerate(want):
        free, pinned = got[2 * i], got[2 * i + 1]
        if abs(free - w) <= 2e-5 * abs(w):
            continue
        jp, inputs = masters[i]
        why = _explain_gap(j_cfg, jp, cfg,
                           from_jax_params(cfg, _np_tree(jp), "cpu"), inputs)
        print(f"step {i}: free loss {free} vs JAX {w} after {why}; "
              f"replayed {pinned}")
        assert abs(pinned - w) <= 2e-5 * abs(w), (i, free, pinned, w, why)
