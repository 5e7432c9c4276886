"""Training on a "model" axis that does not divide the head count, on
gloo ranks: the mixer (attention, hymba's SSM beside it, an xLSTM pair's
mLSTM and sLSTM) runs whole on every "model" rank, its weights stored in
JAX's column parts (cut inside a head) and gathered for it; the FFN stays
tensor-parallel (``runtime/sharding.py``, ``Constrain.whole_mixer``).

* Against the single-device step with the quantizers pinned, the gates
  and runner of ``tests/test_torch_sharded_training.py``: reduced bitnet,
  hymba (3 query heads on 1 KV head) and xLSTM with 3 heads on (1, 2),
  also under sequence parallelism (the sequence gathered before the
  mixer, cut after), and FSDP; granite with 6 query heads on 2 KV heads
  on (1, 4) (GQA groups across ranks) and hymba with 5 heads on (2, 2).
* Against JAX: reduced bitnet with 3 heads, two steps on (1, 2) ``2d``
  from the same weights and batches, the loss within 2e-5 of JAX's jitted
  step on a (1, 2) mesh of host devices (a subprocess, as JAX's own mesh
  tests; both with the quantizers free).

The port's two steps run on the 2-rank launch after its cases, and that
launch, the 4-rank one and JAX's subprocess run at once.
"""

import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import transformer as j_transformer

from test_torch_sharded_training import (
    BODY, REDUCED, _case, _run, check_against_the_single_device_step)
from torch_mesh_helpers import ROOT, SRC, launch

BN, HY, XL, GR = "bitnet-0.73b", "hymba-1.5b", "xlstm-350m", "granite-3-2b"
THREE = dict(n_heads=3, d_model=96)

CASES_2 = [
    _case("bitnet 3 heads (1, 2) 2d", BN, [1, 2], cfg=THREE),
    _case("bitnet 3 heads (1, 2) 2d sp", BN, [1, 2], cfg=THREE, sp=True),
    _case("bitnet 3 heads (1, 2) 2d fsdp", BN, [1, 2], cfg=THREE,
          fsdp=True),
    _case("hymba 3 heads (1, 2) 2d", HY, [1, 2], cfg=THREE),
    _case("hymba 3 heads (1, 2) 2d sp", HY, [1, 2], cfg=THREE, sp=True),
    _case("xlstm 3 heads (1, 2) 2d", XL, [1, 2], cfg=THREE),
    _case("xlstm 3 heads (1, 2) 2d sp", XL, [1, 2], cfg=THREE, sp=True),
]
CASES_4 = [
    _case("granite 6 heads kv 2 (1, 4) 2d", GR, [1, 4],
          cfg=dict(n_heads=6, n_kv_heads=2, d_model=96)),
    _case("hymba 5 heads (2, 2) 2d fsdp", HY, [2, 2],
          cfg=dict(n_heads=5, d_model=80, d_ff=128), fsdp=True),
]


REDUCED_3 = dict(n_layers=2, d_model=96, n_heads=3, d_ff=128,
                 vocab_size=128)

JAX_SCRIPT = textwrap.dedent('''
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    from repro.compat import make_mesh
    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLMDataset
    from repro.models import transformer
    from repro.models.layers import Ctx
    from repro.optim import adamw
    from repro.runtime import sharding as shd
    from repro.training import make_train_step

    cfg = get_config("bitnet-0.73b").reduced(**%(reduced)r)
    mesh = make_mesh((1, 2), ("data", "model"))
    ctx = Ctx(mode="qat", attn_q_chunk=16, attn_kv_chunk=16,
              constrain=shd.make_constrain(mesh, cfg, 4))
    opt = adamw(lr=1e-3)
    params = transformer.init_params(cfg, jax.random.PRNGKey(0))
    state = opt.init(params)
    p_sh = shd.shard_params(mesh, params, fsdp=False)
    with mesh:
        params = jax.tree_util.tree_map(jax.device_put, params, p_sh)
        step = jax.jit(make_train_step(cfg, ctx, opt, loss_chunk=16))
        data = SyntheticLMDataset(cfg, batch=4, seq_len=32, seed=0)
        losses = []
        for i in range(2):
            params, state, m = step(params, state, data.batch_at(i))
            losses.append(float(m["loss"]))
    print("LOSSES " + " ".join(repr(x) for x in losses), flush=True)
''')

# run on the 2-rank launch of CASES_2, after them
PORT_BODY = '''
from repro_torch import convert
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh
from repro_torch.training import make_train_step_sharded

cfg = get_config("bitnet-0.73b").reduced(**%(reduced)r)
nest = {}
for k, v in dict(np.load("jax_params.npz")).items():
    d = nest
    *parents, leaf = k.split("/")
    for p in parents:
        d = d.setdefault(p, {})
    d[leaf] = v
full = convert.from_jax_params(cfg, nest, device="cpu")
mesh = TrainMesh((1, 2))
ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
sharding.SP_THRESHOLD = 4096   # the cases may have lowered it
opt = adamw(lr=1e-3)
params = sharding.shard_params(mesh, full, fsdp=False)
state = opt.init(params)
step = make_train_step_sharded(cfg, ctx, opt, mesh, global_batch=4,
                               loss_chunk=16)
assert sharding.make_constrain(mesh, cfg, 4).whole_mixer
data = SyntheticLMDataset(cfg, batch=4, seq_len=32, seed=0, device="cpu")
losses = []
for i in range(2):
    params, state, m = step(params, state, data.batch_at(i))
    losses.append(float(m["loss"]))
if RANK == 0:
    print("LOSSES " + " ".join(repr(x) for x in losses), flush=True)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2-rank launch (CASES_2, then PORT_BODY), the 4-rank launch of
    CASES_4 and JAX's (1, 2) run, all three at once: (the cases' results,
    the port's losses, JAX's run)."""
    tmp = tmp_path_factory.mktemp("heads")
    cfg = j_get_config("bitnet-0.73b").reduced(**REDUCED_3)
    params = j_transformer.init_params(cfg, jax.random.PRNGKey(0))
    np.savez(tmp / "jax_params.npz", **{
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT % dict(reduced=REDUCED_3)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    body = (BODY % dict(reduced=REDUCED, cases=json.dumps(CASES_2))).replace(
        'finish("SHARDED_OK")',
        PORT_BODY % dict(reduced=REDUCED_3) + 'finish("SHARDED_OK")')
    try:
        with ThreadPoolExecutor(1) as pool:
            four = pool.submit(_run, tmp_path_factory, CASES_4, 4)
            out = launch(tmp, body, 2, "SHARDED_OK", timeout=300)
            results = four.result()
        stdout, stderr = jax_run.communicate(timeout=300)
    finally:
        jax_run.kill()
    line = next(x for x in out.splitlines() if x.startswith("RESULTS "))
    results.update(json.loads(line[len("RESULTS "):]))
    losses = [float(x) for x in next(
        x for x in out.splitlines() if x.startswith("LOSSES ")).split()[1:]]
    return results, losses, (jax_run.returncode, stdout, stderr)


@pytest.mark.parametrize("case", [c["name"] for c in CASES_2 + CASES_4])
def test_whole_mixer_step_matches_the_single_device_step(runs, case):
    check_against_the_single_device_step(runs[0][case])


def test_bitnet_3_heads_on_1x2_matches_jax_jitted_mesh_step(runs):
    """Reduced bitnet with 3 heads, whose 96 query columns JAX's spec cuts
    48 a rank (inside head 1): two port steps on (1, 2) gloo ranks against
    JAX's jitted step on a (1, 2) mesh from the same weights."""
    _, got, (rc, stdout, stderr) = runs
    assert rc == 0, stdout[-3000:] + stderr[-6000:]
    want = [float(x) for x in next(
        x for x in stdout.splitlines() if x.startswith("LOSSES ")).split()[1:]]
    assert all(np.isfinite(got)) and got[-1] > 0, got
    for g, w in zip(got, want):
        assert abs(g - w) <= 2e-5 * abs(w), (got, want)
