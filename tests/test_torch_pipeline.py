"""``repro_torch.runtime.pipeline`` (GPipe over gloo ranks) and the
checkpoint's elastic restore (``CheckpointManager.restore(...,
shardings=)``), in one launch of four ranks.

* JAX's ``tests/test_pipeline.py`` case: S 4 stages, L 8 layers of
  ``tanh(x @ w) + x`` with D 16, 6 microbatches of 3; the pipeline's
  outputs within 1e-5 of the sequential stack (the port's and JAX's on the
  same weights); the stage layout equals JAX's ``split_layers_into_stages``.
* A QAT block stack (reduced bitnet, 4 layers) in 2 stages on a group of
  two of the four ranks, 4 microbatches, against the 4 blocks in order.
* The elastic restore: the state of a sharded step on (2, 2) with FSDP
  saved (split leaves gathered, rank 0 writing), restored onto (1, 4),
  (4, 1) and one rank: every leaf this rank's block of the saved tree bit
  for bit; a step after the restore on (4, 1) equals a step from the
  saved tree sharded directly onto (4, 1), bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.pipeline import (
    split_layers_into_stages as j_split_layers_into_stages)

from repro_torch.runtime.pipeline import split_layers_into_stages

from torch_mesh_helpers import launch

S, L, D, N_MICRO, MB = 4, 8, 16, 6, 3

BODY = '''
import copy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh
from repro_torch.runtime.pipeline import (pipeline_forward,
                                          split_layers_into_stages)
from repro_torch.training import make_train_step_sharded

out = {}
# -- JAX's case -------------------------------------------------------------
z = np.load("gpipe.npz")
ws, x = torch.from_numpy(z["ws"]), torch.from_numpy(z["x"])


def layer(w, h):
    return torch.tanh(h @ w) + h


def stage_fn(stage_ws, h):
    for w in stage_ws:
        h = layer(w, h)
    return h


stages = split_layers_into_stages(ws, 4)
y = pipeline_forward(stage_fn, None, stages[RANK], x)
seq = torch.stack([stage_fn(ws, x[i]) for i in range(x.shape[0])])
out["gpipe_vs_seq"] = ((y - seq).abs().max()).item()
out["gpipe_vs_jax"] = ((y - torch.from_numpy(z["ref"])).abs().max()).item()

# -- a QAT block stack in 2 stages on ranks 0 and 1 -------------------------
group = dist.new_group([0, 1])
bcfg = get_config("bitnet-0.73b").reduced(n_layers=4, d_model=64, n_heads=4,
                                          d_ff=128, vocab_size=128)
ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
full = transformer.init_params(bcfg, torch.Generator().manual_seed(0))
h = torch.randn((4, 2, 16, 64), generator=torch.Generator().manual_seed(1))
if RANK < 2:
    blocks = split_layers_into_stages(full["layers"], 2)
    with torch.no_grad():
        y = pipeline_forward(
            lambda p, v: transformer.apply_blocks(bcfg, p, v, ctx), group,
            blocks[RANK], h)
        seq = torch.stack([transformer.apply_blocks(bcfg, full["layers"],
                                                    h[i], ctx)
                           for i in range(4)])
    out["qat_stack"] = ((y - seq).abs().max() / seq.abs().max()).item()

# -- the elastic restore ----------------------------------------------------
opt = adamw(lr=1e-3)
data = SyntheticLMDataset(bcfg, batch=4, seq_len=32, seed=0, device="cpu")


def sharded(shape):
    mesh = TrainMesh(shape)
    p = sharding.shard_params(mesh, full, fsdp=True)
    step = make_train_step_sharded(bcfg, ctx, opt, mesh, global_batch=4,
                                   loss_chunk=16)
    return mesh, p, step


def shardings(mesh, p):
    parts = sharding.tree_parts(mesh, sharding.tree_specs(p))
    return (parts, AdamWState(step=None, m=parts, v=parts))


mesh, p, step = sharded((2, 2))
state = opt.init(p)
p, state, _ = step(p, state, data.batch_at(0))
specs = sharding.tree_specs(p)
whole_p = {n: mesh.full_part(t, specs[n]) for n, t in p.named_buffers()}
whole_m = {n: mesh.full_part(t, specs[n]) for n, t in state.m.items()}
whole_v = {n: mesh.full_part(t, specs[n]) for n, t in state.v.items()}
ckpt = CheckpointManager("ckpt")
ckpt.save(1, (p, state), shardings=shardings(mesh, p))
ok = {}
for shape in ((1, 4), (4, 1)):
    mesh, like, step = sharded(shape)
    like_state = opt.init(like)
    rp, rs = ckpt.restore(1, (like, like_state), shardings(mesh, like))
    sp = sharding.tree_specs(rp)
    ok[str(shape)] = (
        all(torch.equal(t, mesh.local_part(whole_p[n], sp[n]))
            for n, t in rp.named_buffers())
        and all(torch.equal(rs.m[n], mesh.local_part(whole_m[n], sp[n]))
                and torch.equal(rs.v[n], mesh.local_part(whole_v[n], sp[n]))
                for n in whole_m)
        and int(rs.step) == 1)
    if shape == (4, 1):   # a step after the restore == a straight step
        direct = sharding.map_buffers(
            like, lambda n, t: mesh.local_part(whole_p[n], sp[n]).clone())
        dstate = AdamWState(
            step=torch.ones((), dtype=torch.int32),
            m={n: mesh.local_part(t, sp[n]).clone()
               for n, t in whole_m.items()},
            v={n: mesh.local_part(t, sp[n]).clone()
               for n, t in whole_v.items()})
        a, a_s, a_m = step(rp, rs, data.batch_at(1))
        b, b_s, b_m = step(direct, dstate, data.batch_at(1))
        ok["step after restore"] = (
            torch.equal(a_m["loss"], b_m["loss"])
            and all(torch.equal(x, y) for x, y in zip(a.buffers(),
                                                      b.buffers()))
            and all(torch.equal(a_s.m[n], b_s.m[n])
                    and torch.equal(a_s.v[n], b_s.v[n]) for n in a_s.m))
if RANK == 0:
    one_p, one_s = ckpt.restore(1, (full, opt.init(full)))
    ok["one rank"] = (
        all(torch.equal(t, whole_p[n]) for n, t in one_p.named_buffers())
        and all(torch.equal(one_s.m[n], whole_m[n])
                and torch.equal(one_s.v[n], whole_v[n]) for n in whole_m))
out["restore"] = ok
oks = [None] * WORLD
dist.all_gather_object(oks, out)
if RANK == 0:
    print("RESULTS " + json.dumps(oks), flush=True)
finish("PIPELINE_OK")
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * (0.5 / D ** 0.5)).astype(
        np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)

    def seq(h):
        def body(h, w):
            return jnp.tanh(h @ w) + h, None
        return jax.lax.scan(body, h, jnp.asarray(ws))[0]

    ref = np.asarray(jax.vmap(seq)(jnp.asarray(x)))
    np.savez(tmp / "gpipe.npz", ws=ws, x=x, ref=ref)
    out = launch(tmp, "import json\n" + BODY, 4, "PIPELINE_OK",
                 timeout=240)
    line = next(x for x in out.splitlines() if x.startswith("RESULTS "))
    import json
    return json.loads(line[len("RESULTS "):])


def test_stage_layout_equals_jax():
    ws = np.arange(L * D * 3, dtype=np.float32).reshape(L, D, 3)
    got = split_layers_into_stages(torch.from_numpy(ws), S)
    want = np.asarray(j_split_layers_into_stages(jnp.asarray(ws), S))
    assert np.array_equal(got.numpy(), want)
    layers = list(range(L))
    assert split_layers_into_stages(layers, S) == [
        [0, 1], [2, 3], [4, 5], [6, 7]]


@pytest.mark.parametrize("rank", range(4))
def test_gpipe_matches_sequential_on_4_ranks(ranks, rank):
    assert ranks[rank]["gpipe_vs_seq"] <= 1e-5, ranks[rank]
    assert ranks[rank]["gpipe_vs_jax"] <= 1e-5, ranks[rank]


@pytest.mark.parametrize("rank", range(2))
def test_gpipe_qat_block_stack_matches_sequential(ranks, rank):
    assert ranks[rank]["qat_stack"] <= 1e-5, ranks[rank]


@pytest.mark.parametrize("target", ["(1, 4)", "(4, 1)", "one rank",
                                    "step after restore"])
def test_elastic_restore_bit_for_bit(ranks, target):
    for r in ranks:
        if target in r["restore"]:
            assert r["restore"][target], (target, r["restore"])
    assert target in ranks[0]["restore"]
