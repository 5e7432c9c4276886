"""JAX's partitioned packed serving program in the port, on gloo ranks:
``prefill_step`` and ``decode_step`` under a ("data", "model") mesh with
packed weights laid out by ``sharding.shard_params(fsdp=False)``, a cache
by ``sharding.cache_sharding`` (its sequence split over "model") and the
batch by ``batch_spec`` (``Constrain(max_seq=)``).

* Port against port: each case's sharded run against the single-device
  port on the same packed weights (JAX's, carried across by ``convert``),
  f32 activations and cache, a batch of 4 prompts of 12 tokens and a cache
  of 32 positions (so the second half of a cache split in two holds no
  live position until the fifth decode step): the prefill logits within
  1e-6 of their largest, each rank's cache block within 1e-6 of the same
  block of the single-device cache (after the prefill and after the
  decode steps), 4 teacher-forced ``decode_step`` logits each within
  1e-5, and the sharded run's greedy tokens equal to the single device's
  over the 4 steps.  Reduced bitnet on (1, 2), (2, 1), (2, 2) and, under
  sequence parallelism (``SP_THRESHOLD`` lowered as the training tests
  do), on (1, 2).  On (1, 2) the int32 sums of layer 0's row-parallel
  ``o`` and ``down`` (``bitlinear.packed_rows_acc``) equal the
  single-device accumulator (``torch.equal``); at d_model 64 the second
  rank's block of packed rows is all padding.
* Port against JAX: ``jax.jit`` of JAX's ``prefill_step`` and
  ``decode_step`` on 4 host devices (a subprocess, as JAX's own mesh
  tests), the same mesh, weights and inputs: logits within ``LOGIT_TOL``
  and each rank's cache block within 1e-5 of the same block of JAX's
  array.  Reduced bitnet (2, 2); bitnet with 3 heads (1, 2) (the mixer
  whole on each "model" rank); qwen2-72b cut to 8 query heads on 2 KV
  heads with its (random) QKV biases on (1, 4) (K/V split inside a head);
  musicgen (2, 2) (the embed frontend); bitnet with an int8 cache (2, 2);
  and the port's ``tlmm_lut`` on (2, 2) against the JAX run of bitnet.
* A rank's parameters and cache planes have JAX's ``shard_shape``s; a
  decode read whose shard holds no live key merges to no NaN.

The 2-rank launch, the 4-rank launch and JAX's subprocess run at once.
"""

import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as j_get_config
from repro.models import transformer as j_transformer
from repro.runtime import sharding as j_shd

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.models import transformer
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import MeshShape

from torch_mesh_helpers import ROOT, SRC, launch

B, T, S, STEPS = 4, 12, 32, 4
LOGIT_TOL = 2e-3   # tests/test_torch_archs.py
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=128)
MODELS = {"bitnet": ("bitnet-0.73b", {}),
          "bitnet3": ("bitnet-0.73b", dict(n_heads=3, d_model=96)),
          "qwen2": ("qwen2-72b", dict(n_heads=8, n_kv_heads=2)),
          "musicgen": ("musicgen-medium", {})}


def _case(name, model, mesh, jax=None, **kw):
    return dict(name=name, model=model, mesh=mesh, jax=jax, **kw)


# jax=: the JAX run the case is held to (None: port against port only)
CASES_2 = [
    _case("bitnet (1, 2)", "bitnet", [1, 2], accs=True),
    _case("bitnet (2, 1)", "bitnet", [2, 1]),
    _case("bitnet (1, 2) sp", "bitnet", [1, 2], sp=True),
    _case("bitnet 3 heads (1, 2)", "bitnet3", [1, 2],
          jax="bitnet 3 heads (1, 2)"),
]
CASES_4 = [
    _case("bitnet (2, 2)", "bitnet", [2, 2], jax="bitnet (2, 2)"),
    _case("qwen2 8 heads kv 2 (1, 4)", "qwen2", [1, 4],
          jax="qwen2 8 heads kv 2 (1, 4)"),
    _case("musicgen (2, 2)", "musicgen", [2, 2], jax="musicgen (2, 2)"),
    _case("bitnet kv8 (2, 2)", "bitnet", [2, 2], kv8=True,
          jax="bitnet kv8 (2, 2)"),
    _case("bitnet tlmm_lut (2, 2)", "bitnet", [2, 2], lut=True,
          jax="bitnet (2, 2)"),
]
JAX_CASES = sorted({(c["jax"], c["model"], tuple(c["mesh"]),
                     bool(c.get("kv8"))) for c in CASES_2 + CASES_4
                    if c["jax"]})
PORT_GATED = [c["name"] for c in CASES_2 + CASES_4]


def _cfg(model):
    arch, kw = MODELS[model]
    return j_get_config(arch).reduced(**dict(REDUCED, **kw))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)
    return out


def _write_inputs(tmp):
    """Each model's packed weights (JAX's ``pack_params``, the QKV biases
    drawn at random so that their slices show) and inputs: the prompt and
    the decode steps' tokens (embeddings for an embed model)."""
    for model in MODELS:
        cfg = _cfg(model)
        packed = j_transformer.pack_params(cfg, j_transformer.init_params(
            cfg, jax.random.PRNGKey(3)))
        flat = _flat(packed)
        rng = np.random.default_rng(5)
        for k in flat:
            if k.endswith("/b"):
                flat[k] = (0.1 * rng.standard_normal(flat[k].shape)).astype(
                    flat[k].dtype)
        np.savez(tmp / f"{model}.npz", **flat)
        if cfg.frontend == "token":
            prompt = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
            steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1),
                                 dtype=np.int32)
        else:
            prompt = rng.standard_normal((B, T, cfg.d_model), np.float32)
            steps = rng.standard_normal((STEPS, B, 1, cfg.d_model),
                                        np.float32)
        np.savez(tmp / f"inputs_{model}.npz", prompt=prompt, steps=steps)


COMMON = '''
MODELS = %(models)r
B, T, S, STEPS = %(dims)r
REDUCED = %(reduced)r


def tree_of(path, wrap):
    nest = {}
    for k, v in dict(np.load(path)).items():
        d = nest
        *parents, leaf = k.split("/")
        for p_ in parents:
            d = d.setdefault(p_, {})
        d[leaf] = wrap(v)
    return nest
'''

JAX_SCRIPT = textwrap.dedent('''
    import json
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.compat import make_mesh
    from repro.configs import get_config
    from repro.models import transformer
    from repro.models.layers import Ctx
    from repro.runtime import sharding as shd
    ''') + COMMON + textwrap.dedent('''
    for name, model, shape, kv8 in json.loads(%(cases)r):
        arch, kw = MODELS[model]
        cfg = get_config(arch).reduced(**dict(REDUCED, **kw))
        n = shape[0] * shape[1]
        mesh = make_mesh(tuple(shape), ("data", "model"),
                         devices=jax.devices()[:n])
        packed = tree_of(model + ".npz", jnp.asarray)
        params = jax.device_put(packed, shd.shard_params(mesh, packed,
                                                         fsdp=False))
        cache = transformer.init_cache(cfg, B, S, jnp.float32,
                                       kv_quant=kv8)
        cache = jax.device_put(cache, shd.cache_sharding(mesh, cache, B))
        data = np.load("inputs_" + model + ".npz")

        def batch(x):
            return jax.device_put(jnp.asarray(x), shd.ns(
                mesh, *shd.batch_spec(mesh, B, x.ndim - 1)))

        # an int8 cache's read dequantizes to bf16, where JAX's XLA decode
        # rounds its probabilities to bf16 too: its Pallas attention (in
        # interpret mode) keeps them f32, as the port's reads do
        ctx = Ctx(mode="packed", impl="xla", act_dtype="float32",
                  attn_impl="pallas" if kv8 else "xla",
                  group_size=cfg.group_size, kv_quant=kv8,
                  constrain=shd.make_constrain(mesh, cfg, B))
        prefill = jax.jit(lambda p, x, c: transformer.prefill_step(
            cfg, p, x, ctx, c))
        decode = jax.jit(lambda p, x, c, n: transformer.decode_step(
            cfg, p, x, ctx, c, n))
        out = {}
        with mesh:
            logits, cache = prefill(params, batch(data["prompt"]), cache)
            out["logits0"] = np.asarray(logits)
            out.update({"prefill_" + k: np.asarray(v)
                        for k, v in cache.items()})
            for i in range(STEPS):
                logits, cache = decode(params, batch(data["steps"][i]), cache,
                                       jnp.asarray(T + i, jnp.int32))
                out["logits%%d" %% (i + 1)] = np.asarray(logits)
        out.update({"decode_" + k: np.asarray(v) for k, v in cache.items()})
        np.savez("jax_" + name + ".npz", **out)
    print("JAX_OK", flush=True)
''')

BODY = COMMON + '''
import json

from repro_torch import convert
from repro_torch.core import bitlinear, ternary
from repro_torch.kernels.tlmm import ref as tlmm_ref
from repro_torch.models.layers import Ctx
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh

meshes, results = {}, {}


def err(a, b):
    return float((a - b).abs().max())


def cache_err(mesh, cache, whole, specs):
    return max(err(cache[k], mesh.local_part(whole[k], specs[k]))
               for k in cache)


for case in json.loads(%(cases)r):
    sharding.SP_THRESHOLD = 16 if case.get("sp") else 4096
    arch, kw = MODELS[case["model"]]
    cfg = get_config(arch).reduced(**dict(REDUCED, **kw))
    full = convert.from_jax_packed(cfg, tree_of(case["model"] + ".npz",
                                                lambda a: a), device="cpu")
    data = np.load("inputs_" + case["model"] + ".npz")
    shape = tuple(case["mesh"])
    if shape not in meshes:
        meshes[shape] = TrainMesh(shape)
    mesh = meshes[shape]
    kv8 = bool(case.get("kv8"))
    matmul = "tlmm_lut" if case.get("lut") else "tlmm"
    ctx1 = Ctx(mode="packed", matmul=matmul)
    ctx = Ctx(mode="packed", matmul=matmul, constrain=sharding.make_constrain(
        mesh, cfg, B, max_seq=S))
    assert ctx.constrain.sp == bool(case.get("sp"))
    params = sharding.shard_params(mesh, full, fsdp=False)
    whole = transformer.init_cache(cfg, B, S, torch.float32, "cpu",
                                   kv_quant=kv8)
    specs = sharding.cache_sharding(mesh, whole, B)
    cache = sharding.local_cache(mesh, whole, B)
    prompt = torch.from_numpy(data["prompt"])
    bspec = sharding.batch_spec(mesh, B, prompt.dim() - 1)

    def rows(x):
        return mesh.local_part(x, (bspec[0],) + (None,) * (x.dim() - 1))

    res, saved = {}, {}
    ratios = []   # an int8 cache: each stored row's values / its scale
    q_kv = transformer.q_kv

    def recording_q_kv(x):
        q, scale = q_kv(x)
        ratios.append(x.float() / scale[..., None])
        return q, scale

    transformer.q_kv = recording_q_kv
    with torch.no_grad():
        want, _ = transformer.prefill_step(cfg, full, prompt, ctx1, whole)
        got, _ = transformer.prefill_step(cfg, params, rows(prompt), ctx,
                                          cache)
        res["prefill"] = err(got, rows(want)) / float(want.abs().max())
        res["prefill_cache"] = cache_err(mesh, cache, whole, specs)
        saved["logits0"] = got
        saved.update({"prefill_" + k: v.clone() for k, v in cache.items()})
        res["decode"], res["tokens_equal"] = [], True
        tok = want.argmax(-1)
        for i in range(STEPS):
            if case["jax"]:
                inp = torch.from_numpy(data["steps"][i])
            elif cfg.frontend == "token":
                inp = tok[:, None].to(torch.int32)   # the greedy token
            want, _ = transformer.decode_step(cfg, full, inp, ctx1, whole,
                                              T + i)
            got, _ = transformer.decode_step(cfg, params, rows(inp), ctx,
                                             cache, T + i)
            res["decode"].append(err(got, rows(want)))
            tok = want.argmax(-1)
            res["tokens_equal"] &= bool(torch.equal(got.argmax(-1),
                                                    rows(tok)))
            saved["logits%%d" %% (i + 1)] = got
        res["decode_cache"] = cache_err(mesh, cache, whole, specs)
        transformer.q_kv = q_kv
        if kv8:   # the sharded run's calls: layers x (k, v) a pass
            L = cfg.n_layers
            for j, name in enumerate(("k", "v")):
                plane = torch.full(cache["k"].shape[:2] + (S,)
                                   + cache["k"].shape[3:], float("nan"))
                passes = [ratios[i:i + 2 * L]
                          for i in range(0, len(ratios), 2 * L)]
                # each pass ran twice: single device, then sharded
                for at, calls in zip([0] + [T + i for i in range(STEPS)],
                                     passes[1::2]):
                    for layer in range(L):
                        r = calls[2 * layer + j]
                        plane[layer, :, at:at + r.shape[1]] = rows(r)
                saved["ratio_" + name] = mesh.local(
                    plane, ctx.constrain.kv_axis, 2)
        saved.update({"decode_" + k: v for k, v in cache.items()})
        if case.get("accs"):   # layer 0's row-parallel int32 sums
            res["accs_equal"], res["padding_block"] = True, False
            g = torch.Generator().manual_seed(7)
            for name in ("o", "down"):
                sub = "attn" if name == "o" else "mlp"
                lin = params["layers"][0][sub][name]
                ref = full["layers"][0][sub][name]
                n_in = cfg.q_dim if name == "o" else cfg.d_ff
                xw = torch.randn((B, T, n_in), generator=g)
                acc, _, _ = bitlinear.packed_rows_acc(
                    lin, mesh.local(xw, "model", 2), mesh, "model")
                xq, _ = ternary.absmax_quant(xw.reshape(-1, n_in))
                res["accs_equal"] &= torch.equal(
                    acc, tlmm_ref.tlmm_ref(xq, ref.codes, ref.g, n_in))
                lo = mesh.index("model") * lin.codes.shape[0] * lin.g
                res["padding_block"] |= lo >= n_in
    if case["jax"]:
        np.savez("port_%%s_%%d.npz" %% (case["name"], RANK),
                 **{k: v.numpy() for k, v in saved.items()})
    results[case["name"]] = res
gathered = [None] * WORLD
dist.all_gather_object(gathered, results)
if RANK == 0:
    print("RESULTS " + json.dumps(gathered), flush=True)
finish("SERVING_OK")
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank launch (CASES_2), the 4-rank one (CASES_4) and JAX's
    subprocess, at once: ({case: [each rank's results]}, the directory
    with every rank's and JAX's arrays, JAX's (returncode, stdout,
    stderr))."""
    tmp = tmp_path_factory.mktemp("serving")
    _write_inputs(tmp)
    common = dict(models=MODELS, dims=(B, T, S, STEPS), reduced=REDUCED)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT % dict(
            common, cases=json.dumps(JAX_CASES))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp))

    def ranks(cases, n):
        body = BODY % dict(common, cases=json.dumps(cases))
        out = launch(tmp, body, n, "SERVING_OK", timeout=240)
        line = next(x for x in out.splitlines() if x.startswith("RESULTS "))
        return json.loads(line[len("RESULTS "):])

    try:
        with ThreadPoolExecutor(1) as pool:
            four = pool.submit(ranks, CASES_4, 4)
            two = ranks(CASES_2, 2)
            four = four.result()
        stdout, stderr = jax_run.communicate(timeout=300)
    finally:
        jax_run.kill()
    results = {}
    for per_rank in (two, four):
        for r, res in enumerate(per_rank):
            for name, v in res.items():
                results.setdefault(name, [None] * len(per_rank))[r] = v
    return results, tmp, (jax_run.returncode, stdout, stderr)


@pytest.mark.parametrize("case", PORT_GATED)
def test_partitioned_program_matches_the_single_device_port(runs, case):
    for r, res in enumerate(runs[0][case]):
        assert res["prefill"] <= 1e-6, (r, res)
        assert res["prefill_cache"] <= 1e-6, (r, res)
        assert res["decode_cache"] <= 1e-6, (r, res)
        assert len(res["decode"]) == STEPS and max(res["decode"]) <= 1e-5, (
            r, res)
        assert res["tokens_equal"], (r, res)


def test_row_parallel_int32_sums_equal_the_single_device_accumulator(runs):
    """Layer 0's ``o`` (64 inputs, 13 live code rows padded to 64) and
    ``down`` (128 inputs, 26 rows padded to 64) on (1, 2): rank 1's 32
    rows cover inputs from 160 on, all padding."""
    res = runs[0]["bitnet (1, 2)"]
    assert all(r["accs_equal"] for r in res), res
    assert [r["padding_block"] for r in res] == [False, True], res


def _mesh_of(case):
    return next(c["mesh"] for c in CASES_2 + CASES_4 if c["name"] == case)


@pytest.mark.parametrize("case", [c["name"] for c in CASES_2 + CASES_4
                                  if c["jax"]])
def test_partitioned_program_matches_jax_jitted_program(runs, case):
    results, tmp, (rc, stdout, stderr) = runs
    assert rc == 0 and "JAX_OK" in stdout, stdout[-3000:] + stderr[-6000:]
    spec = next(c for c in CASES_2 + CASES_4 if c["name"] == case)
    want = dict(np.load(tmp / f"jax_{spec['jax']}.npz"))
    shape = tuple(spec["mesh"])
    cfg = get_config(MODELS[spec["model"]][0]).reduced(
        **dict(REDUCED, **MODELS[spec["model"]][1]))
    whole = transformer.init_cache(cfg, B, S, torch.float32, "meta",
                                   kv_quant=bool(spec.get("kv8")))
    for r in range(shape[0] * shape[1]):
        mesh = MeshShape(shape, rank=r)
        specs = sharding.cache_sharding(mesh, whole, B)
        row = sharding.batch_spec(mesh, B, 1)
        got = dict(np.load(tmp / f"port_{case}_{r}.npz"))
        for i in range(STEPS + 1):
            w = mesh.local_part(torch.from_numpy(want[f"logits{i}"]), row)
            assert np.abs(got[f"logits{i}"] - w.numpy()).max() <= LOGIT_TOL, (
                case, r, i)
        for when in ("prefill", "decode"):
            for k, s in specs.items():
                w = mesh.local_part(torch.from_numpy(want[f"{when}_{k}"]), s)
                d = np.abs(got[f"{when}_{k}"].astype(np.float64)
                           - w.numpy().astype(np.float64))
                moved = d > 1e-5
                if k in ("k", "v") and spec.get("kv8") and moved.any():
                    # a moved int8 code: one step, at a rounding tie of
                    # the port's value / scale (1e-7 upstream moves it)
                    ratio = np.abs(got["ratio_" + k][moved])
                    tie = np.abs(ratio - np.floor(ratio) - 0.5)
                    print(f"{case} rank {r} {when} {k}: codes moved at "
                          f"{np.argwhere(moved).tolist()}, value / scale "
                          f"{ratio.tolist()}")
                    assert d[moved].max() == 1 and tie.max() < 1e-3, (
                        case, r, when, k, np.argwhere(moved), ratio)
                    moved[...] = False
                assert not moved.any(), (
                    case, r, when, k, "moved at", np.argwhere(moved)[:8])


@pytest.mark.parametrize("model,shape", [("qwen2", (1, 4)),
                                         ("bitnet3", (1, 2)),
                                         ("musicgen", (2, 2))])
def test_rank_holds_jax_shard_shapes(model, shape):
    """Every packed leaf and cache plane of a rank has the shape of JAX's
    ``NamedSharding.shard_shape`` under ``shard_params(fsdp=False)`` and
    ``cache_sharding`` (a layer leaf: JAX's stacked shape is L of the
    port's)."""
    jcfg = _cfg(model)
    packed = j_transformer.pack_params(jcfg, j_transformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    jcache = jax.eval_shape(lambda: j_transformer.init_cache(
        jcfg, B, S, jnp.float32))
    amesh = AbstractMesh(shape, ("data", "model"))
    want = {}
    for tree, shs in ((packed, j_shd.shard_params(amesh, packed, fsdp=False)),
                      (jcache, j_shd.cache_sharding(amesh, jcache, B))):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        for (path, leaf), sh in zip(leaves, jax.tree_util.tree_leaves(
                shs, is_leaf=lambda x: isinstance(x, NamedSharding))):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            want[key] = tuple(sh.shard_shape(leaf.shape))
    arch, kw = MODELS[model]
    cfg = get_config(arch).reduced(**dict(REDUCED, **kw))
    nest = {}
    for key, v in _flat(packed).items():
        d = nest
        *parents, leaf = key.split("/")
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    full = convert.from_jax_packed(cfg, nest, device="cpu")
    cache = transformer.init_cache(cfg, B, S, torch.float32, "meta")
    for r in range(shape[0] * shape[1]):
        mesh = MeshShape(shape, rank=r)
        got = {}
        for name, t in sharding.shard_params(mesh, full,
                                             fsdp=False).named_buffers():
            got.setdefault(sharding.jax_path(name), []).append(
                tuple(t.shape))
        assert sorted(got) == sorted(k for k in want if k not in jcache)
        for path, shapes in got.items():
            lead = (len(shapes),) if path.startswith("layers/") else ()
            assert len(set(shapes)) == 1, (path, shapes)
            # convert keeps a scalar gamma as (1,)
            assert lead + shapes[0] in (want[path], want[path] + (1,)), (
                path, shapes, want[path])
        for k, t in sharding.local_cache(mesh, cache, B).items():
            assert tuple(t.shape) == want[k], (k, t.shape, want[k])


ATTN_ARCHS = ["bitnet-0.73b", "qwen1.5-0.5b", "granite-3-2b",
              "command-r-35b", "qwen2-72b", "musicgen-medium",
              "internvl2-76b"]


def _norm(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_param_spec_of_every_packed_leaf_equals_jax(arch):
    """Every packed leaf of the 7 attention-block archs at full width
    (2 layers: the rules do not read the depth) on 16 x 16: the port's
    spec (``sharding.param_specs``, a layer leaf without JAX's stacked
    axis) is JAX's ``shard_params(fsdp=False)``."""
    import dataclasses
    from repro_torch.launch import dryrun
    jcfg = dataclasses.replace(j_get_config(arch), n_layers=2)
    packed = jax.eval_shape(lambda: j_transformer.pack_params(
        jcfg, j_transformer.init_params(jcfg, jax.random.PRNGKey(0),
                                        dtype=jnp.bfloat16)))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    shs = j_shd.shard_params(amesh, packed, fsdp=False)
    want = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(packed)[0],
            jax.tree_util.tree_leaves(
                shs, is_leaf=lambda x: isinstance(x, NamedSharding))):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        spec = _norm(sh.spec, leaf.ndim)
        want[key] = spec[1:] if key.startswith("layers/") else spec
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    ours = transformer.pack_params(cfg, dryrun.bf16_params(cfg, "meta"))
    got = {}
    for name, spec in sharding.param_specs(MeshShape((16, 16)), ours,
                                           fsdp=False).items():
        got.setdefault(sharding.jax_path(name), set()).add(spec)
    assert sorted(got) == sorted(want)
    for path, specs in got.items():
        assert specs == {want[path]}, (path, specs, want[path])


def test_a_shard_with_no_live_key_merges_to_no_nan():
    """A decode read over a cache split in two whose second shard holds
    no live key (cache_len below the shard's start): its partials are
    (NEG_INF, 0, 0) and the merge equals the whole read."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 1, 16), generator=g)
    k, v = (torch.randn((2, 2, 32, 16), generator=g) for _ in range(2))
    cl = torch.tensor([5, 16])
    parts = [da_ops.splitk_partials(q, k[:, :, 16 * i:16 * (i + 1)],
                                    v[:, :, 16 * i:16 * (i + 1)], cl,
                                    n_splits=1, chunk=16, split0=i)
             for i in range(2)]
    m, l, acc = (torch.cat([p[j] for p in parts], 2) for j in range(3))
    assert float(l[:, :, 1].abs().max()) == 0.0
    assert torch.equal(m[:, :, 1], torch.full_like(m[:, :, 1],
                                                   da_ops.NEG_INF))
    out = da_ops.splitk_combine(m, l, acc, torch.float32)
    assert torch.isfinite(out).all()
    want = da_ref.decode_attention_ref(q, k, v, cl.to(torch.int32))
    assert float((out - want).abs().max()) <= 1e-6
