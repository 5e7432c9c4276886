"""MoE under a serving mesh: the port's ``ServingEngine(mesh=DeviceMesh)``
on gloo ranks emits, token for token, the tokens of JAX's mesh engine
(``ServingEngine(mesh=...)`` on ``--xla_force_host_platform_device_count=4``
CPU devices, run in a subprocess as ``tests/test_multidevice.py`` runs it).

JAX's mesh engine runs its prefill waves and decode blocks under
``shard_map``: each data shard's ``moe_apply`` sees only that shard's rows
(its slots in lane order, idle lanes included), so expert capacity and the
exclusive positions count a shard's rows, and a request's tokens at
capacity factor 1.25 depend on which shard it lands on.  A port rank holds
exactly its shard's rows.  Reduced mixtral (4 experts, top-2) on f32
caches, 4 requests on 4 slots: meshes (2, 1), (1, 2) and (2, 2) (split-K
decode over "model" where it has two ranks, ``shard_kv``), at 1.25 and
drop-free (capacity factor 4), host-driven and device-resident.  At
least one 1.25 mesh case differs from JAX's single-device engine
(asserted), so the gate holds the per-shard capacity and not drop-free
equality alone.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from torch_mesh_helpers import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

SHAPES = [(2, 1), (1, 2), (2, 2)]
CFS = [1.25, 4.0]
ENGINE = dict(max_seq=32, batch_slots=4, prefill_chunk=4, decode_block=4)

JAX_SERVE = '''
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.configs import get_config
from repro.models import transformer
from repro.models.layers import Ctx
from repro.serving import Request, ServingEngine

out_dir = sys.argv[1]
cfg = get_config("mixtral-8x22b").reduced()
packed = transformer.pack_params(
    cfg, transformer.init_params(cfg, jax.random.PRNGKey(1)))
rng = np.random.default_rng(0)
prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
           for n in (3, 9, 5, 7)]
if sys.argv[3] == "save":   # the port's weights and prompts, then serve
    import os
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(packed)[0]}
    np.savez(out_dir + "/packed.npz", **flat)
    np.savez(out_dir + "/prompts_.npz", *prompts)
    os.replace(out_dir + "/prompts_.npz", out_dir + "/prompts.npz")
ctx = Ctx(mode="packed", group_size=cfg.group_size, attn_impl="pallas")
cases = json.loads(sys.argv[2])


def run(c):
    import dataclasses
    mcfg = dataclasses.replace(cfg, capacity_factor=c["cf"])
    mesh = (compat.make_mesh(tuple(c["mesh"]), ("data", "model"))
            if c["mesh"] else None)
    eng = ServingEngine(mcfg, packed, ctx=ctx, cache_dtype=jnp.float32,
                        device_sched=c["dev"], mesh=mesh,
                        shard_kv=bool(c["mesh"]) and c["mesh"][1] > 1,
                        **c["kw"])
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    eng.run(reqs)
    return [r.output.tolist() for r in reqs]


print("TOKENS " + json.dumps({c["name"]: run(c) for c in cases}),
      flush=True)
'''

PORT_BODY = '''
import dataclasses, json
from repro_torch.convert import from_jax_packed

mcfg = get_config("mixtral-8x22b").reduced()
nest = {}
for k, v in np.load("packed.npz").items():
    d = nest
    *parents, leaf = k.split("/")
    for p in parents:
        d = d.setdefault(p, {})
    d[leaf] = v
moe = from_jax_packed(mcfg, nest, device="cpu")
prompts = list(np.load("prompts.npz").values())
out = {}
for c in json.loads(%(cases)r):
    eng = ServingEngine(dataclasses.replace(mcfg, capacity_factor=c["cf"]),
                        moe, device="cpu", cache_dtype=torch.float32,
                        device_sched=c["dev"], mesh=mesh_of(tuple(c["mesh"])),
                        shard_kv=c["mesh"][1] > 1, **c["kw"])
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    out[c["name"]] = [r.output.tolist() for r in reqs]
if RANK == 0:
    print("TOKENS " + json.dumps(out), flush=True)
finish("MOE_MESH_OK")
'''


def _case(cf, shape, dev):
    return dict(name=f"cf {cf} {shape} {'device' if dev else 'host'}",
                cf=cf, mesh=list(shape) if shape else None, dev=dev,
                kw=ENGINE)


MESH_CASES = [_case(cf, s, dev) for cf in CFS for s in SHAPES
              for dev in (False, True)]
SINGLE = [_case(1.25, None, dev) for dev in (False, True)]


def _tokens(out: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith("TOKENS "))
    return json.loads(line[len("TOKENS "):])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # JAX's engines in two processes (one a capacity factor; the first
    # saves the weights and prompts) while the port's ranks serve
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SERVE, str(tmp), json.dumps(
            [c for c in MESH_CASES + SINGLE if c["cf"] == cf]),
         "save" if cf == CFS[0] else "-"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cf in CFS]
    try:
        t0 = time.monotonic()
        while not (tmp / "prompts.npz").exists():
            assert procs[0].poll() is None, procs[0].stderr.read()[-4000:]
            assert time.monotonic() - t0 < 120, "no weights from JAX"
            time.sleep(0.2)
        got = {}
        for world in (2, 4):
            cases = [c for c in MESH_CASES
                     if c["mesh"][0] * c["mesh"][1] == world]
            got.update(_tokens(launch(tmp, PORT_BODY % dict(
                cases=json.dumps(cases)), world, "MOE_MESH_OK",
                timeout=300)))
        want = {}
        for proc in procs:
            out, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-4000:]
            want.update(_tokens(out))
    finally:
        for proc in procs:
            proc.kill()
    return want, got


@pytest.mark.parametrize("case", [c["name"] for c in MESH_CASES])
def test_moe_mesh_engine_emits_jax_mesh_engine_tokens(served, case):
    want, got = served
    assert got[case] == want[case], (got[case], want[case])


def test_moe_capacity_counts_a_shard_on_a_serving_mesh(served):
    """At capacity factor 1.25 some mesh case's tokens differ from the
    single-device engine's in the same mode (JAX's and so the port's):
    the shards' capacities are their own."""
    want, _ = served
    differ = [c["name"] for c in MESH_CASES if c["cf"] == 1.25
              and want[c["name"]] != want[
                  _case(1.25, None, c["dev"])["name"]]]
    assert differ, "no 1.25 mesh case differs from one device"
