"""The port's training step on a ("data", "model") mesh of gloo ranks
(``training.make_train_step_sharded``) against the single-device step.

Each launch runs its cases on every rank (``tests/torch_mesh_helpers.py``);
each rank also runs the single-device step (reduced sizes: a fraction of a
second) and records its quantized values (``testing.pinned_quantizers``),
which the mesh step replays, each rank its block of each value, so the two
differ only in the order of their sums.  Gates, per case:

* the loss within 2e-6 of the single-device loss (relative);
* every gradient leaf, gathered whole, within 2e-5 of its largest;
* the AdamW moments (gathered whole) against the unsharded in-place AdamW
  given the same whole gradients: bit for bit with no clip, within 2e-6 of
  their largest with the clip biting (the global norm sums in another
  order); without a clip the parameters after the step bit for bit too.

Cases: reduced bitnet (2 layers, d_model 64) on (1, 2), (2, 1) and (2, 2),
FSDP on and off, and 2 microbatches (the single-device gradients summed
over the same microbatches); sequence parallelism with ``SP_THRESHOLD`` lowered to the
reduced width; reduced granite with one KV head (K and V gathered), and
with a vocabulary "model" does not divide (the head split on d_model,
gathered); ``dpzero1`` (ZeRO-1 moments) on (2, 1) and (2, 2); reduced
mixtral (drop-free; its expert buffers replayed row by row, keyed by
(expert, row): ``sharding.Rows``), hymba and xLSTM under ``dpzero1`` on
(2, 1).  JAX's ``tests/test_system.py`` case: reduced granite-3-2b on (2,
4), FSDP off, two steps, against JAX's jitted single-device step on the
same converted weights.  And which layouts run tensor-parallel.  MoE at
capacity 1.25 over the global batch, MoE, hymba and xLSTM on a "model"
axis: ``test_torch_sharded_moe.py``, ``test_torch_sharded_recurrent.py``.
"""

import json

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticLMDataset as JData
from repro.models import transformer as j_transformer
from repro.models.layers import Ctx as JCtx
from repro.optim import adamw as j_adamw  # the function
from repro.training import make_train_step as j_make_train_step

from repro_torch.configs import get_config
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import MeshShape

from torch_mesh_helpers import launch

REDUCED = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=128)

BODY = '''
import contextlib, copy, dataclasses, json, sys
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import layers
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh
from repro_torch.testing import leaf_grad_errors, pinned_quantizers
from repro_torch.training import loss_and_grads, make_train_step_sharded

CTX = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
REDUCED = %(reduced)r


def rel(got, ref):
    return {n: ((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-30)
                ).item() for n, r in ref.items()}


@contextlib.contextmanager
def counting_drops(drops):
    """Adds the (token, slot) pairs each routing drops to drops[0]."""
    orig = layers.moe_route

    def route(*a, **kw):
        r = orig(*a, **kw)
        drops[0] += int((~r["keep"]).sum())
        return r
    layers.moe_route = route
    try:
        yield
    finally:
        layers.moe_route = orig


def run_case(c):
    kw = dict(REDUCED, **c.get("cfg", {}))
    cfg = get_config(c["arch"]).reduced(**kw)
    ctx = dataclasses.replace(CTX, **c.get("ctx", {}))
    full = transformer.init_params(cfg, torch.Generator().manual_seed(
        c.get("seed", 0)))
    batch = SyntheticLMDataset(cfg, batch=4, seq_len=32, seed=c.get(
        "seed", 0), device="cpu").batch_at(0)
    pin = c.get("pinned", True)
    micro = c.get("micro", 1)
    tape = []
    rows = 4 // micro
    drops = [0]
    with (pinned_quantizers(tape, replay=False) if pin
          else contextlib.nullcontext()), counting_drops(drops):
        parts = [loss_and_grads(cfg, ctx, copy.deepcopy(full),
                                {k: v[i * rows:(i + 1) * rows]
                                 for k, v in batch.items()}, 16)
                 for i in range(micro)]
    l_ref, g_ref = parts[0]
    for l_i, g_i in parts[1:]:   # make_train_step's accumulation
        l_ref = l_ref + l_i
        g_ref = {n: g_ref[n] + g for n, g in g_i.items()}
    if micro > 1:
        l_ref = l_ref / micro
        g_ref = {n: g / micro for n, g in g_ref.items()}
    sharding.SP_THRESHOLD = 64 if c.get("sp") else 4096
    mesh = TrainMesh(tuple(c["mesh"]))
    out = {"drops": drops[0]}
    for clip in (None, 1.0):
        opt = adamw(lr=1e-3, grad_clip=clip)
        zero1 = c["layout"] == "dpzero1"
        p = sharding.shard_params(mesh, full, fsdp=c.get("fsdp", False),
                                  layout="dp" if zero1 else "2d")
        z = sharding.Zero1(mesh, p) if zero1 else None
        state = opt.init(p, zero1=z)
        step = make_train_step_sharded(cfg, ctx, opt, mesh, global_batch=4,
                                       layout=c["layout"], zero1=z,
                                       microbatches=micro, loss_chunk=16,
                                       return_grads=True)
        with (pinned_quantizers(tape, replay=True) if pin
              else contextlib.nullcontext()):
            p, state, m = step(p, state, batch)
        specs = sharding.tree_specs(p)
        grads = {n: mesh.full_part(g, specs[n])
                 for n, g in m["grads"].items()}
        whole = (z.gather if zero1 else
                 lambda n, t: mesh.full_part(t, specs[n]))
        mom = {f"{k}/{n}": whole(n, t) for k, d in (("m", state.m),
                                                    ("v", state.v))
               for n, t in d.items()}
        new_p = {n: mesh.full_part(t, specs[n])
                 for n, t in p.named_buffers()}
        ref_p = copy.deepcopy(full)
        ref_state = opt.init(ref_p)
        upd, ref_state = opt.update({n: g.clone() for n, g in grads.items()},
                                    ref_state, ref_p)
        ref_new = {n: t + upd[n] for n, t in ref_p.named_buffers()}
        ref_mom = {f"{k}/{n}": t for k, d in (("m", ref_state.m),
                                              ("v", ref_state.v))
                   for n, t in d.items()}
        tag = "noclip" if clip is None else "clip"
        out[tag] = dict(
            loss=float(m["loss"]), loss_ref=float(l_ref),
            grad_err=max(leaf_grad_errors(grads, g_ref).values()),
            mom_exact=all(torch.equal(mom[n], ref_mom[n]) for n in ref_mom),
            mom_err=max(rel(mom, ref_mom).values()),
            params_exact=all(torch.equal(new_p[n], ref_new[n])
                             for n in ref_new))
    return out


results = {}
for c in json.loads(%(cases)r):
    results[c["name"]] = run_case(c)
if RANK == 0:
    print("RESULTS " + json.dumps(results), flush=True)
finish("SHARDED_OK")
'''


def _case(name, arch, mesh, layout="2d", **kw):
    return dict(name=name, arch=arch, mesh=mesh, layout=layout, **kw)


CASES_2 = [
    _case("bitnet (1, 2) 2d", "bitnet-0.73b", [1, 2]),
    _case("bitnet (1, 2) 2d fsdp", "bitnet-0.73b", [1, 2], fsdp=True),
    _case("bitnet (1, 2) 2d sp", "bitnet-0.73b", [1, 2], sp=True),
    _case("bitnet (1, 2) 2d 2 microbatches", "bitnet-0.73b", [1, 2],
          micro=2),
    _case("bitnet (2, 1) 2d", "bitnet-0.73b", [2, 1]),
    _case("bitnet (2, 1) 2d fsdp", "bitnet-0.73b", [2, 1], fsdp=True),
    _case("bitnet (2, 1) dpzero1", "bitnet-0.73b", [2, 1], "dpzero1"),
    _case("mixtral (2, 1) dpzero1", "mixtral-8x22b", [2, 1], "dpzero1",
          cfg=dict(capacity_factor=4.0)),
    _case("hymba (2, 1) dpzero1", "hymba-1.5b", [2, 1], "dpzero1"),
    _case("xlstm (2, 1) dpzero1", "xlstm-350m", [2, 1], "dpzero1"),
    # 4 query heads on 1 KV head: K and V gathered whole
    _case("granite kv 1 (1, 2) 2d", "granite-3-2b", [1, 2]),
]
CASES_4 = [
    _case("bitnet (2, 2) 2d", "bitnet-0.73b", [2, 2]),
    _case("bitnet (2, 2) 2d fsdp", "bitnet-0.73b", [2, 2], fsdp=True),
    _case("bitnet (2, 2) 2d fsdp sp", "bitnet-0.73b", [2, 2], fsdp=True,
          sp=True),
    _case("bitnet (2, 2) dpzero1", "bitnet-0.73b", [2, 2], "dpzero1"),
    _case("qwen1.5 (1, 4) 2d", "qwen1.5-0.5b", [1, 4]),
    # vocabulary 126 on 4 model ranks: the untied head is split on d_model
    # (JAX's spec), gathered whole; the table whole
    _case("granite vocab 126 (1, 4) 2d", "granite-3-2b", [1, 4],
          cfg=dict(vocab_size=126, n_kv_heads=4)),
    _case("granite kv 1 (2, 2) 2d fsdp sp", "granite-3-2b", [2, 2],
          fsdp=True, sp=True),
]


def _run(tmp_path_factory, cases, nproc):
    tmp = tmp_path_factory.mktemp(f"sharded{nproc}")
    body = BODY % dict(reduced=REDUCED, cases=json.dumps(cases))
    out = launch(tmp, body, nproc, "SHARDED_OK", timeout=240)
    line = next(x for x in out.splitlines() if x.startswith("RESULTS "))
    return json.loads(line[len("RESULTS "):])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {**_run(tmp_path_factory, CASES_2, 2),
            **_run(tmp_path_factory, CASES_4, 4)}


def check_against_the_single_device_step(res):
    """The file's gates on one case's results."""
    for tag in ("noclip", "clip"):
        r = res[tag]
        assert abs(r["loss"] - r["loss_ref"]) <= 2e-6 * abs(r["loss_ref"]), (
            tag, r)
        assert r["grad_err"] <= 2e-5, (tag, r)
    noclip, clip = res["noclip"], res["clip"]
    assert noclip["mom_exact"] and noclip["params_exact"], noclip
    assert clip["mom_err"] <= 2e-6, clip


@pytest.mark.parametrize("case", [c["name"] for c in CASES_2 + CASES_4])
def test_sharded_step_matches_the_single_device_step(results, case):
    check_against_the_single_device_step(results[case])


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "hymba-1.5b",
                                  "xlstm-350m"])
def test_moe_hymba_xlstm_tensor_parallel_only_on_a_model_axis(arch):
    """Every kind runs tensor-parallel on a "model" axis of two ranks
    (``test_torch_sharded_moe.py``, ``test_torch_sharded_recurrent.py``
    hold the steps), and on none under (2, 1) ``2d`` or ``dpzero1``, whose
    batch is split; a "model" axis that does not divide the heads is
    refused."""
    cfg = get_config(arch).reduced(**REDUCED)
    assert sharding.make_constrain(MeshShape((1, 2)), cfg, 4).tp
    for shape, layout in (((2, 1), "2d"), ((1, 2), "dpzero1")):
        hook = sharding.make_constrain(MeshShape(shape), cfg, 4, layout)
        assert not hook.tp and hook.n_batch == 2, (shape, layout)
    with pytest.raises(NotImplementedError, match="n_heads"):
        sharding.make_constrain(MeshShape((1, 3)), cfg, 4)


GRANITE_BODY = '''
import numpy as np
from repro_torch import convert
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh
from repro_torch.training import make_train_step_sharded

cfg = get_config("granite-3-2b").reduced(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=128)
tree = dict(np.load("jax_params.npz"))
nest = {}
for k, v in tree.items():
    d = nest
    *parents, leaf = k.split("/")
    for p in parents:
        d = d.setdefault(p, {})
    d[leaf] = v
full = convert.from_jax_params(cfg, nest, device="cpu")
mesh = TrainMesh((2, 4))
ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
opt = adamw(lr=1e-3)
params = sharding.shard_params(mesh, full, fsdp=False)
state = opt.init(params)
step = make_train_step_sharded(cfg, ctx, opt, mesh, global_batch=4,
                               loss_chunk=16)
data = SyntheticLMDataset(cfg, batch=4, seq_len=32, seed=0, device="cpu")
losses = []
for i in range(2):
    params, state, m = step(params, state, data.batch_at(i))
    losses.append(float(m["loss"]))
if RANK == 0:
    print("LOSSES " + " ".join(repr(x) for x in losses), flush=True)
finish("GRANITE_OK")
'''


def test_granite_on_a_2x4_mesh_matches_jax_jitted_step(tmp_path):
    """JAX's ``test_multi_device_sharded_train_executes`` case on eight
    gloo ranks: two steps of reduced granite-3-2b on a (2, 4) mesh, FSDP
    off, the loss finite and within 2e-5 of JAX's jitted single-device
    step on the same weights and batches (both with the quantizers free)."""
    cfg = j_get_config("granite-3-2b").reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=128)
    params = j_transformer.init_params(cfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "jax_params.npz", **flat)
    opt = j_adamw(lr=1e-3)
    state = opt.init(params)
    ctx = JCtx(mode="qat", attn_q_chunk=16, attn_kv_chunk=16)
    step = jax.jit(j_make_train_step(cfg, ctx, opt, loss_chunk=16))
    data = JData(cfg, batch=4, seq_len=32, seed=0)
    want = []
    for i in range(2):
        params, state, m = step(params, state, data.batch_at(i))
        want.append(float(m["loss"]))
    out = launch(tmp_path, GRANITE_BODY, 8, "GRANITE_OK", timeout=240)
    line = next(x for x in out.splitlines() if x.startswith("LOSSES "))
    got = [float(x) for x in line.split()[1:]]
    assert all(np.isfinite(got)) and got[-1] > 0, got
    for g, w in zip(got, want):
        assert abs(g - w) <= 2e-5 * abs(w), (got, want)
