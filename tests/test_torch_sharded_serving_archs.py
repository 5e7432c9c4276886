"""JAX's partitioned packed serving program for MoE, hymba and xLSTM in
the port, on gloo ranks: ``prefill_step`` and ``decode_step`` under a
("data", "model") mesh with packed weights laid out by
``sharding.shard_params(fsdp=False)`` (expert banks split on E over
"model" where it divides E, else inside each expert), a cache by
``sharding.cache_sharding`` (K/V split on the batch and the sequence,
recurrent states on their batch alone: whole in their heads on every
"model" rank) and the batch by ``batch_spec`` (``Constrain(max_seq=)``).

* Port against port: each case's sharded run against the single-device
  port on the same packed weights (JAX's, carried across by ``convert``),
  f32 activations and cache, a batch of 4 prompts of 12 tokens and a cache
  of 32 positions, with the gates of ``tests/test_torch_sharded_serving.py``:
  the prefill logits within 1e-6 of their largest, each rank's cache and
  state block within 1e-6 of the same block of the single-device cache
  (after the prefill and after the decode steps), 4 teacher-forced
  ``decode_step`` logits each within 1e-5 and the greedy tokens equal.
  Reduced mixtral (4 experts, top-2) on (1, 2) (expert-parallel), (2, 1)
  (capacity over the global batch), (2, 2) and on (1, 2) under sequence
  parallelism (``SP_THRESHOLD`` lowered as the training tests do); mixtral
  cut to 3 experts on (1, 2) (each bank split inside each expert); dbrx (4
  experts, top-4) on (1, 4) and (2, 2); hymba (4 heads on 2 KV heads) on
  (1, 2) and (2, 2) and with 3 heads (the mixer whole); xLSTM on (1, 2)
  and (2, 2) and with 3 heads.  On mixtral's (1, 2) cases the int32 sums
  of layer 0's three expert banks in the prefill, expert by expert, equal
  the single device's (``torch.equal``): a rank's experts, or every
  expert on a rank's columns.
* Port against JAX: ``jax.jit`` of JAX's ``prefill_step`` and
  ``decode_step`` on 4 host devices (a subprocess), the same mesh, weights
  and inputs: logits within ``LOGIT_TOL`` and each rank's cache and state
  block within 1e-5 of the same block of JAX's array, for mixtral, dbrx,
  hymba and xLSTM on (2, 2) and mixtral with 3 experts, hymba and xLSTM
  with 3 heads on (1, 2).
* A rank's parameters and cache planes have JAX's ``shard_shape``s.

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
from repro_torch.models import transformer
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import MeshShape

from torch_mesh_helpers import SRC, launch

B, T, S, STEPS = 4, 12, 32, 4
LOGIT_TOL = 2e-3   # tests/test_torch_archs.py
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=128)
MODELS = {"mixtral": ("mixtral-8x22b", {}),
          "mixtral3": ("mixtral-8x22b", dict(n_experts=3)),
          "dbrx": ("dbrx-132b", {}),
          "hymba": ("hymba-1.5b", dict(n_kv_heads=2)),
          "hymba3": ("hymba-1.5b", dict(n_heads=3, d_model=96)),
          "xlstm": ("xlstm-350m", dict(d_ff=0)),
          "xlstm3": ("xlstm-350m", dict(n_heads=3, d_model=96, d_ff=0))}


def _case(name, model, mesh, jax=None, **kw):
    return dict(name=name, model=model, mesh=mesh, jax=jax, **kw)


# jax=: the JAX run the case is held to (None: port against port only)
CASES_2 = [
    _case("mixtral (1, 2)", "mixtral", [1, 2], accs=True, pin=True),
    _case("mixtral 3 experts (1, 2)", "mixtral3", [1, 2], accs=True,
          pin=True, jax="mixtral 3 experts (1, 2)"),
    _case("mixtral (1, 2) sp", "mixtral", [1, 2], sp=True),
    _case("mixtral (2, 1)", "mixtral", [2, 1], pin=True),
    _case("hymba (1, 2)", "hymba", [1, 2], pin=True),
    _case("hymba 3 heads (1, 2)", "hymba3", [1, 2],
          jax="hymba 3 heads (1, 2)"),
    _case("xlstm (1, 2)", "xlstm", [1, 2], pin=True),
    _case("xlstm 3 heads (1, 2)", "xlstm3", [1, 2],
          jax="xlstm 3 heads (1, 2)"),
]
CASES_4 = [
    _case("mixtral (2, 2)", "mixtral", [2, 2], jax="mixtral (2, 2)"),
    _case("dbrx (1, 4)", "dbrx", [1, 4]),
    _case("dbrx (2, 2)", "dbrx", [2, 2], pin=True, jax="dbrx (2, 2)"),
    _case("hymba (2, 2)", "hymba", [2, 2], jax="hymba (2, 2)"),
    _case("xlstm (2, 2)", "xlstm", [2, 2], jax="xlstm (2, 2)"),
]
JAX_CASES = sorted({(c["jax"], c["model"], tuple(c["mesh"]))
                    for c in CASES_2 + CASES_4 if c["jax"]})
PORT_GATED = [c["name"] for c in CASES_2 + CASES_4]


def _cfg(model):
    arch, kw = MODELS[model]
    return j_get_config(arch).reduced(**dict(REDUCED, **kw))


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    """The nested dict of a {"a/b": leaf} dict."""
    nest = {}
    for key, v in flat.items():
        d = nest
        *parents, leaf = key.split("/")
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return nest


def _write_inputs(tmp):
    """Each model's packed weights (JAX's ``pack_params``) and inputs: the
    prompt and the decode steps' tokens."""
    for model in MODELS:
        cfg = _cfg(model)
        packed = j_transformer.pack_params(cfg, j_transformer.init_params(
            cfg, jax.random.PRNGKey(3)))
        np.savez(tmp / f"{model}.npz",
                 **{k: np.array(v) for k, v in _flat(packed).items()})
        rng = np.random.default_rng(5)
        prompt = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
        steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1),
                             dtype=np.int32)
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


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out
'''

JAX_SCRIPT = textwrap.dedent('''
    import functools
    import json
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.compat import make_mesh
    from repro.configs import get_config
    from repro.core import bitlinear
    from repro.models import transformer
    from repro.models.layers import Ctx
    from repro.runtime import sharding as shd
    ''') + COMMON + textwrap.dedent('''
    # every packed linear's input, by its place in the traced program (a
    # decode step's linears are traced after the prefill's), as it runs
    inputs, traced = {}, [0]
    apply_packed = bitlinear.apply_packed


    def recording(p, x, **kw):
        tag = traced[0]
        traced[0] += 1
        jax.debug.callback(functools.partial(
            lambda t, v: inputs.setdefault(t, []).append(np.asarray(v)),
            tag), x)
        return apply_packed(p, x, **kw)


    bitlinear.apply_packed = recording
    for name, model, shape in json.loads(%(cases)r):
        inputs.clear()
        traced[0] = 0
        arch, kw = MODELS[model]
        cfg = get_config(arch).reduced(**dict(REDUCED, **kw))
        n = shape[0] * shape[1]
        mesh = make_mesh(tuple(shape), ("data", "model"),
                         devices=jax.devices()[:n])
        packed = tree_of(model + ".npz", jnp.asarray)
        params = jax.device_put(packed, shd.shard_params(mesh, packed,
                                                         fsdp=False))
        cache = transformer.init_cache(cfg, B, S, jnp.float32)
        cache = jax.device_put(cache, shd.cache_sharding(mesh, cache, B))
        data = np.load("inputs_" + model + ".npz")

        def batch(x):
            return jax.device_put(jnp.asarray(x), shd.ns(
                mesh, *shd.batch_spec(mesh, B, x.ndim - 1)))

        ctx = Ctx(mode="packed", impl="xla", act_dtype="float32",
                  group_size=cfg.group_size,
                  constrain=shd.make_constrain(mesh, cfg, B))
        prefill = jax.jit(lambda p, x, c: transformer.prefill_step(
            cfg, p, x, ctx, c))
        decode = jax.jit(lambda p, x, c, n: transformer.decode_step(
            cfg, p, x, ctx, c, n))
        out = {}
        with mesh:
            logits, cache = prefill(params, batch(data["prompt"]), cache)
            n_pre = traced[0]   # the prefill's linears, traced
            out["logits0"] = np.asarray(logits)
            out.update({"prefill_" + k: np.asarray(v)
                        for k, v in flat(cache).items()})
            for i in range(STEPS):
                logits, cache = decode(params, batch(data["steps"][i]), cache,
                                       jnp.asarray(T + i, jnp.int32))
                out["logits%%d" %% (i + 1)] = np.asarray(logits)
        out.update({"decode_" + k: np.asarray(v)
                    for k, v in flat(cache).items()})
        jax.effects_barrier()
        # the linears are traced once in the scan over the layers: the
        # prefill's layer by layer, then each decode step's
        n_scan = len(inputs[0])
        calls = [inputs[t][l] for l in range(n_scan) for t in range(n_pre)]
        calls += [inputs[t][i * n_scan + l] for i in range(STEPS)
                  for l in range(n_scan) for t in range(n_pre, traced[0])]
        out.update({"xin%%d" %% i: v for i, v in enumerate(calls)})
        np.savez("jax_" + name + ".npz", **out)
    print("JAX_OK", flush=True)
''')

BODY = COMMON + '''
import json

from repro_torch import convert
from repro_torch.core import ternary
from repro_torch.kernels.tlmm import ref as tlmm_ref
from repro_torch.models import layers
from repro_torch.models.layers import Ctx
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import TrainMesh
from repro_torch.testing import pinned_int8, pinned_routing

meshes, results = {}, {}


def err(a, b):
    return float((a - b).abs().max())


def cache_err(mesh, cache, whole, specs):
    return max(err(cache[k], mesh.local_part(whole[k], specs[k]))
               for k in cache)


def bank_accs(calls):
    """The int32 sums of recorded ``_expert_matmul_packed`` calls, expert
    by expert: [(E', C, n_out) int32 a call]."""
    out = []
    for codes, gamma, n_in, g, x in calls:
        xq, _ = ternary.absmax_quant(x)
        out.append(torch.stack([tlmm_ref.tlmm_ref(xq[e], codes[e], g, n_in)
                                for e in range(codes.shape[0])]))
    return out


expert_matmul = layers._expert_matmul_packed
calls = []


def init_cache(like):
    """A fresh cache of the planes of ``like``, as init_cache makes them."""
    return {k: (init_cache(v) if isinstance(v, dict) else
                torch.full_like(v, -1e30) if k == "m" else torch.zeros_like(v))
            for k, v in like.items()}


def recording(codes, gamma, n_in, g, x, x_part=None):
    calls.append((codes.clone(), gamma.clone(), n_in, g, x.clone()))
    return expert_matmul(codes, gamma, n_in, g, x, x_part)


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
    ctx1 = Ctx(mode="packed")
    ctx = Ctx(mode="packed", constrain=sharding.make_constrain(
        mesh, cfg, B, max_seq=S))
    assert ctx.constrain.sp == bool(case.get("sp"))
    params = sharding.shard_params(mesh, full, fsdp=False)
    whole = transformer.init_cache(cfg, B, S, torch.float32, "cpu")
    specs = flat(sharding.cache_sharding(mesh, whole, B))
    cache = sharding.local_cache(mesh, whole, B)
    prompt = torch.from_numpy(data["prompt"])
    bspec = sharding.batch_spec(mesh, B, 1)

    def rows(x):
        return mesh.local_part(x, (bspec[0],) + (None,) * (x.dim() - 1))

    res, saved = {}, {}
    layers._expert_matmul_packed = recording
    with torch.no_grad():
        want, _ = transformer.prefill_step(cfg, full, prompt, ctx1, whole)
        one, calls[:] = calls[:3], []
        got, _ = transformer.prefill_step(cfg, params, rows(prompt), ctx,
                                          cache)
        mine, calls[:] = calls[:3], []
        layers._expert_matmul_packed = expert_matmul
        res["prefill"] = err(got, rows(want)) / float(want.abs().max())
        res["prefill_cache"] = cache_err(mesh, flat(cache), flat(whole),
                                         specs)
        saved["logits0"] = got
        saved.update({"prefill_" + k: v.clone()
                      for k, v in flat(cache).items()})
        res["decode"], res["tokens_equal"] = [], True
        tok = want.argmax(-1)
        for i in range(STEPS):
            inp = (torch.from_numpy(data["steps"][i]) if case["jax"]
                   else tok[:, None].to(torch.int32))   # the greedy token
            want, _ = transformer.decode_step(cfg, full, inp, ctx1, whole,
                                              T + i)
            got, _ = transformer.decode_step(cfg, params, rows(inp), ctx,
                                             cache, T + i)
            res["decode"].append(err(got, rows(want)))
            tok = want.argmax(-1)
            res["tokens_equal"] &= bool(torch.equal(got.argmax(-1),
                                                    rows(tok)))
            saved["logits%%d" %% (i + 1)] = got
        res["decode_cache"] = cache_err(mesh, flat(cache), flat(whole),
                                        specs)
        saved.update({"decode_" + k: v for k, v in flat(cache).items()})
        if case.get("pin"):   # one device's int8 values and routings
            # replayed on the ranks: each rank's block of every one
            tape = {"int8": [], "routes": []}
            moved, routed, outs = [], [], []
            cut = (rows if ctx.constrain.n_batch > 1 else None)
            for replay, p_, c_, x_ in (
                    (False, full, init_cache(whole), lambda x: x),
                    (True, params, init_cache(cache), rows)):
                with pinned_int8(tape["int8"], replay, cut, moved), \
                        pinned_routing(tape["routes"], replay, None, routed):
                    got, _ = transformer.prefill_step(
                        cfg, p_, x_(prompt), ctx if replay else ctx1, c_)
                    outs.append([got])
                    for i in range(STEPS):
                        got, _ = transformer.decode_step(
                            cfg, p_, x_(torch.from_numpy(data["steps"][i])),
                            ctx if replay else ctx1, c_, T + i)
                        outs[-1].append(got)
            res["pinned_moved"] = len(moved) + len(routed)
            res["pinned_err"] = max(err(b_, rows(a_))
                                    for a_, b_ in zip(*outs))
        if case.get("accs"):   # layer 0's gate, up and down banks
            split = ctx.constrain.split_banks(params["layers"][0]["moe"])
            lo, hi = ctx.constrain.experts(cfg.n_experts, split)
            res["split"], res["experts"] = split, [lo, hi]
            res["accs_equal"] = len(one) == len(mine) == 3
            for a1, a in zip(bank_accs(one), bank_accs(mine)):
                w = a1[lo:hi]
                if split:   # this rank's columns of every expert
                    w = mesh.local(w, "model", 2)
                res["accs_equal"] &= torch.equal(a, w)
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
    tmp = tmp_path_factory.mktemp("serving_archs")
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


@pytest.mark.parametrize("case", [c["name"] for c in CASES_2 + CASES_4
                                  if c.get("pin")])
def test_a_rank_replays_its_block_of_one_devices_int8_values(runs, case):
    """``testing.pinned_int8`` and ``pinned_routing`` (phase 16 (c) on the
    card): one device's int8 values and routings, recorded in call order,
    replayed on each rank's blocks (its experts' or columns' buffer rows,
    its features of a row-parallel input, its batch rows) equal the codes
    the rank computes itself, codes and experts (none moved: the CPU sums
    in one order; the replay raises on a code or route moved away from a
    tie, or on scales off the recorded ones), and the logits are the
    single device's."""
    for r, res in enumerate(runs[0][case]):
        assert res["pinned_moved"] == 0 and res["pinned_err"] <= 1e-6, (
            r, res)


@pytest.mark.parametrize("case,split", [("mixtral (1, 2)", False),
                                        ("mixtral 3 experts (1, 2)", True)])
def test_expert_bank_int32_sums_equal_the_single_device_accumulator(
        runs, case, split):
    """Layer 0's gate, up and down banks in the prefill: on (1, 2) with 4
    experts each rank's 2 experts' sums are the single device's sums of
    those experts; with 3 experts (banks split inside each expert) each
    rank's sums of every expert are its columns of the single device's."""
    res = runs[0][case]
    assert [r["experts"] for r in res] == (
        [[0, 3], [0, 3]] if split else [[0, 2], [2, 4]]), res
    assert all(r["split"] == split and r["accs_equal"] for r in res), res


def _spec_of(case):
    return next(c for c in CASES_2 + CASES_4 if c["name"] == case)


def _single_device(spec, tmp, jax_inputs=None):
    """The single-device port on a case's weights and inputs (the JAX
    run's teacher-forced steps): (logits of the prefill and each step,
    {when_plane: whole cache}, the moved codes).  With ``jax_inputs``
    (JAX's recorded linear inputs, in call order) each packed linear whose
    int8 codes differ from those of JAX's input (both quantized by the
    port's ``absmax_quant``) takes JAX's input instead, JAX's quantized
    values replayed, and each such code is listed: (call, row, column, the
    port's |x| / scale, JAX's)."""
    from repro_torch.core import bitlinear, ternary
    from repro_torch.models.layers import Ctx
    arch, kw = MODELS[spec["model"]]
    cfg = get_config(arch).reduced(**dict(REDUCED, **kw))
    full = convert.from_jax_packed(
        cfg, _nest(dict(np.load(tmp / f"{spec['model']}.npz"))), device="cpu")
    data = np.load(tmp / f"inputs_{spec['model']}.npz")
    calls, moved, apply_packed = [0], [], bitlinear.apply_packed

    def replaying(p, x, **k):
        theirs = torch.from_numpy(jax_inputs[calls[0]]).reshape(x.shape)
        a = x.reshape(-1, x.shape[-1])
        b = theirs.reshape(a.shape)
        (qa, sa), (qb, sb) = ternary.absmax_quant(a), ternary.absmax_quant(b)
        before = len(moved)
        for r, c in (qa != qb).nonzero().tolist():
            moved.append((calls[0], r, c, float(a[r, c].abs() / sa[r, 0]),
                          float(b[r, c].abs() / sb[r, 0])))
        calls[0] += 1
        return apply_packed(p, theirs if len(moved) > before else x, **k)

    ctx = Ctx(mode="packed")
    cache = transformer.init_cache(cfg, B, S, torch.float32, "cpu")
    if jax_inputs is not None:
        bitlinear.apply_packed = replaying
    try:
        with torch.no_grad():
            logits, _ = transformer.prefill_step(
                cfg, full, torch.from_numpy(data["prompt"]), ctx, cache)
            out = [logits]
            planes = {f"prefill_{k}": v.clone()
                      for k, v in _flat(cache).items()}
            for i in range(STEPS):
                logits, _ = transformer.decode_step(
                    cfg, full, torch.from_numpy(data["steps"][i]), ctx,
                    cache, T + i)
                out.append(logits)
    finally:
        bitlinear.apply_packed = apply_packed
    if jax_inputs is not None:
        assert calls[0] == len(jax_inputs), (calls[0], len(jax_inputs))
    planes.update({f"decode_{k}": v for k, v in _flat(cache).items()})
    return out, planes, moved


def _within_jax(got_logits, got_planes, want, mesh, specs, row) -> list:
    """The (what, how far) of every logit set past LOGIT_TOL and every
    cache or state block past 1e-5 of JAX's, on this rank's block."""
    off = []
    for i in range(STEPS + 1):
        w = mesh.local_part(torch.from_numpy(want[f"logits{i}"]), row)
        d = float(np.abs(got_logits[i] - w.numpy()).max())
        if d > LOGIT_TOL:
            off.append((f"logits{i}", d))
    for when in ("prefill", "decode"):
        for k, s in specs.items():
            w = mesh.local_part(torch.from_numpy(want[f"{when}_{k}"]), s)
            d = float(np.abs(got_planes[f"{when}_{k}"].astype(np.float64)
                             - w.numpy().astype(np.float64)).max())
            if d > 1e-5:
                off.append((f"{when}_{k}", d))
    return off


@pytest.mark.parametrize("case", [c["name"] for c in CASES_2 + CASES_4
                                  if c["jax"]])
def test_partitioned_program_matches_jax_jitted_program(runs, case):
    """Each rank's logits within LOGIT_TOL and cache and state blocks
    within 1e-5 of JAX's.  Past them, the cause must be int8 codes that
    one ULP moved at a rounding tie: the single-device port (which each
    rank equals, the port-against-port gate) differs from JAX's program
    only by codes at ties of their inputs (|x| / scale within 1e-3 of a
    half in both packages, printed), and with JAX's inputs replayed at
    those linears it is within the gates everywhere."""
    results, tmp, (rc, stdout, stderr) = runs
    assert rc == 0 and "JAX_OK" in stdout, stdout[-3000:] + stderr[-6000:]
    spec = _spec_of(case)
    want = dict(np.load(tmp / f"jax_{spec['jax']}.npz"))
    shape = tuple(spec["mesh"])
    arch, kw = MODELS[spec["model"]]
    cfg = get_config(arch).reduced(**dict(REDUCED, **kw))
    whole = transformer.init_cache(cfg, B, S, torch.float32, "meta")
    off_ranks = {}
    for r in range(shape[0] * shape[1]):
        mesh = MeshShape(shape, rank=r)
        specs = _flat(sharding.cache_sharding(mesh, whole, B))
        row = sharding.batch_spec(mesh, B, 1)
        got = dict(np.load(tmp / f"port_{case}_{r}.npz"))
        off = _within_jax([got[f"logits{i}"] for i in range(STEPS + 1)],
                          got, want, mesh, specs, row)
        if off:
            off_ranks[r] = (mesh, specs, row, off)
    if not off_ranks:
        return
    theirs = [want[f"xin{i}"] for i in range(len(
        [k for k in want if k.startswith("xin")]))]
    logits, _, _ = _single_device(spec, tmp)
    replayed, rplanes, moved = _single_device(spec, tmp, theirs)
    print(f"{case}: past JAX's gates on ranks "
          f"{ {r: v[3] for r, v in off_ranks.items()} }; int8 codes moved "
          f"against JAX's, then JAX's input replayed (call, row, column, "
          f"port |x| / scale, JAX's): {moved}")
    assert moved, (case, off_ranks)
    for _, _, _, a, b in moved:   # one ULP across a rounding tie
        assert abs(a - np.floor(a) - 0.5) < 1e-3, moved
        assert abs(b - np.floor(b) - 0.5) < 1e-3, moved
        assert abs(round(a) - round(b)) == 1, moved
    for r, (mesh, specs, row, _) in off_ranks.items():
        got = dict(np.load(tmp / f"port_{case}_{r}.npz"))
        for i in range(STEPS + 1):   # the rank is the single device
            assert np.abs(got[f"logits{i}"] - mesh.local_part(
                logits[i], row).numpy()).max() <= 1e-5, (case, r, i)
        blocks = {k: mesh.local_part(v, specs[k.split("_", 1)[1]]).numpy()
                  for k, v in rplanes.items()}
        assert not _within_jax([mesh.local_part(x, row).numpy()
                                for x in replayed], blocks, want, mesh,
                               specs, row), (case, r)


def _jax_shard_shapes(model, shape):
    """{path: JAX's shard shape} of the packed leaves and cache planes of
    ``model`` on ``shape`` under ``shard_params(fsdp=False)`` and
    ``cache_sharding``, and the packed tree."""
    jcfg = _cfg(model)
    packed = j_transformer.pack_params(jcfg, j_transformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    jcache = jax.eval_shape(lambda: j_transformer.init_cache(
        jcfg, B, S, jnp.float32))
    amesh = AbstractMesh(shape, ("data", "model"))
    want = {}
    for tree, shs, pre in (
            (packed, j_shd.shard_params(amesh, packed, fsdp=False), ""),
            (jcache, j_shd.cache_sharding(amesh, jcache, B), "cache:")):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        for (path, leaf), sh in zip(leaves, jax.tree_util.tree_leaves(
                shs, is_leaf=lambda x: isinstance(x, NamedSharding))):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            want[pre + key] = tuple(sh.shard_shape(leaf.shape))
    return want, packed


@pytest.mark.parametrize("model,shape", [("mixtral", (1, 2)),
                                         ("mixtral3", (1, 2)),
                                         ("dbrx", (2, 2)),
                                         ("hymba", (2, 2)),
                                         ("hymba3", (1, 2)),
                                         ("xlstm", (1, 2))])
def test_rank_holds_jax_shard_shapes(model, shape):
    """Every packed leaf (expert banks, their gammas, the router, the
    SSM's and xLSTM's linears and dense leaves) and every cache plane
    (K/V and the recurrent states) of a rank has the shape of JAX's
    ``NamedSharding.shard_shape`` (a layer leaf: JAX's stacked shape is
    L of the port's; an xLSTM pair's, L / 2)."""
    want, packed = _jax_shard_shapes(model, shape)
    arch, kw = MODELS[model]
    cfg = get_config(arch).reduced(**dict(REDUCED, **kw))
    full = convert.from_jax_packed(
        cfg, _nest({k: np.array(v) for k, v in _flat(packed).items()}),
        device="cpu")
    cache = transformer.init_cache(cfg, B, S, torch.float32, "meta")
    for r in range(shape[0] * shape[1]):
        mesh = MeshShape(shape, rank=r)
        got = {}
        for name, t in sharding.shard_params(mesh, full,
                                             fsdp=False).named_buffers():
            got.setdefault(sharding.jax_path(name), []).append(
                tuple(t.shape))
        assert sorted(got) == sorted(k for k in want
                                     if not k.startswith("cache:"))
        for path, shapes in got.items():
            lead = (len(shapes),) if path.startswith("layers/") else ()
            assert len(set(shapes)) == 1, (path, shapes)
            # convert keeps a scalar gamma as (1,)
            assert lead + shapes[0] in (want[path], want[path] + (1,)), (
                path, shapes, want[path])
        local = _flat(sharding.local_cache(mesh, cache, B))
        assert sorted(local) == sorted(k[6:] for k in want
                                       if k.startswith("cache:"))
        for k, t in local.items():
            assert tuple(t.shape) == want["cache:" + k], (k, t.shape)
