"""The JAX package's configurations in the port: every config equal to
JAX's field for field, the seven attention-kind ones through the model's
three entry points against JAX, and the MoE ones through the serving
engine in lockstep with JAX's.

Models: reduced granite-3-2b, command-r-35b, qwen2-72b (QKV bias),
dbrx-132b and mixtral-8x22b (MoE; mixtral with a 16-token window),
musicgen-medium and internvl2-76b (``frontend="embed"``: no embedding
table, an untied LM head, (b, s, d_model) inputs made from the seed).  The
JAX package packs the weights and ``convert.from_jax_packed`` carries
them across; JAX runs its Pallas attention in interpret mode.  Logits
agree within ``LOGIT_TOL`` at f32 (rsqrt/exp ULPs move int8 codes, as in
``tests/test_torch_model.py``).

Engines: the port's engine emits the JAX engine's tokens, token for token,
on reduced dbrx with 8 experts (top-4) at its own capacity factor 1.25,
contiguous and paged, and on reduced mixtral, in each scheduling mode.  At
1.25 capacity couples lanes: every row of a wave or a decode tick, masked
and idle rows included, counts toward an expert's capacity, so the two
scheduling modes may emit different tokens (an idle lane's row differs);
wherever JAX's two modes differ the port's differ the same way.
Drop-free (``capacity_factor = n_experts``) the port's invariants hold:
device-resident == host-driven; on f32 caches paged == contiguous and the
oracle's tokens equal JAX's oracle (``tests/test_serving.py``); on bf16
caches each storage emits JAX's tokens on that storage.  (A windowed
contiguous bf16 cache is read with the probabilities rounded to bf16, as
JAX's XLA decode reads it; JAX's paged read and its Pallas decode kernel
do not round, so at bf16 paged and contiguous may differ in both
packages.)  The lockstep at capacity factor 1.25 runs on f32 caches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import PAPER_ARCH
from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import from_jax_packed
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import reference_decode

LOGIT_TOL = 2e-3
NEAR_TIE = 1e-2
ATTN_ARCHS = ["granite-3-2b", "command-r-35b", "qwen2-72b", "dbrx-132b",
              "mixtral-8x22b", "musicgen-medium", "internvl2-76b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models under parallel workers run far faster on one intra-op
    thread (as the other engine test modules pin)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _j_ctx(j_cfg):
    return JCtx(mode="packed", group_size=j_cfg.group_size,
                attn_impl="pallas")


def _pair(name, **reduce):
    j_cfg = j_get_config(name).reduced(**reduce)
    cfg = get_config(name).reduced(**reduce)
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    return j_cfg, packed, cfg, from_jax_packed(cfg, _np_tree(packed),
                                               device="cpu")


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_archs_are_jax_archs_and_the_paper_model():
    assert ARCHS == J_ARCHS + [PAPER_ARCH]


@pytest.mark.parametrize("name", ARCHS)
def test_config_equals_jax_field_for_field(name):
    cfg, j_cfg = get_config(name), j_get_config(name)
    names = [f.name for f in dataclasses.fields(j_cfg)]
    assert [f.name for f in dataclasses.fields(cfg)] == names
    for kw in ({}, {"n_experts": 8}, {"d_model": 96, "n_heads": 4,
                                      "vocab_size": 256}):
        a, b = cfg.reduced(**kw), j_cfg.reduced(**kw)
        for c, j in ((cfg, j_cfg), (a, b)):
            for f in names:
                assert getattr(c, f) == getattr(j, f), (name, kw, f)
            for prop in ("hd", "q_dim", "kv_dim", "sub_quadratic"):
                assert getattr(c, prop) == getattr(j, prop), (name, prop)


@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-350m"])
def test_recurrent_kinds_are_refused(name):
    """hymba and xLSTM run through the model and the engine; what JAX
    refuses for them the port refuses: chunked prefill and a paged cache
    in the model (NotImplementedError), a paged cache, int8 KV and a mesh
    in the engine (ValueError), each before the parameters are read."""
    cfg = get_config(name).reduced()
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        transformer.prefill_chunk(cfg, None, torch.zeros((1, 4),
                                                         dtype=torch.long),
                                  Ctx(), None, offsets=[0], admit_mask=[True],
                                  last_index=[3])
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        transformer.init_paged_cache(cfg, 8, 4, device="cpu")
    for kw, what in (({"paged": True}, "paged KV cache"),
                     ({"kv_quant": True}, "kv_quant=True")):
        with pytest.raises(ValueError, match=what):
            ServingEngine(cfg, None, max_seq=16, device="cpu", **kw)
    params = transformer.init_packed_params(cfg,
                                            torch.Generator().manual_seed(0))
    cache = transformer.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    logits, _ = transformer.prefill_step(
        cfg, params, torch.zeros((1, 4), dtype=torch.long), Ctx(), cache)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_engine_refuses_embed_frontend():
    """Requests are token ids: an embed model is served through the model's
    entry points, never the engine."""
    cfg = get_config("musicgen-medium").reduced()
    params = transformer.pack_params(
        cfg, transformer.init_params(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="embeddings"):
        ServingEngine(cfg, params, max_seq=16, device="cpu")


def test_init_packed_params_equals_packing_the_masters():
    """The full-width draw (each linear and bank packed as soon as it is
    drawn) makes exactly what packing the masters makes, MoE, embed and
    the recurrent kinds."""
    for name in ("mixtral-8x22b", "internvl2-76b", "hymba-1.5b",
                 "xlstm-350m"):
        cfg = get_config(name).reduced()
        a = transformer.pack_params(cfg, transformer.init_params(
            cfg, torch.Generator().manual_seed(3)))
        b = transformer.init_packed_params(cfg,
                                           torch.Generator().manual_seed(3))
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
        assert ("embed" in b) == (cfg.frontend == "token")
        assert "lm_head" in b


# ---------------------------------------------------------------------------
# Models: the three entry points against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ATTN_ARCHS)
def models(request):
    return _pair(request.param)


def _inputs(cfg, rng, shape):
    """Token ids, or for an embed model embeddings of the same (b, s)."""
    if cfg.frontend == "token":
        return rng.integers(0, cfg.vocab_size, shape)
    return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)


def test_model_entry_points_match_jax(models):
    """prefill_step (20 tokens, past mixtral's reduced 16-token window),
    then two decode steps, on f32 caches; then a ragged prefill_chunk wave
    over a random cache with a masked row."""
    j_cfg, packed, cfg, ours = models
    j_ctx, ctx = _j_ctx(j_cfg), Ctx()
    rng = np.random.default_rng(1)
    assert ("embed" in ours) == (cfg.frontend == "token")
    prompt = _inputs(cfg, rng, (2, 20))
    want, j_cache = jtf.prefill_step(
        j_cfg, packed, jnp.asarray(prompt), j_ctx,
        jtf.init_cache(j_cfg, 2, 24, jnp.float32))
    cache = transformer.init_cache(cfg, 2, 24, torch.float32, device="cpu")
    got, cache = transformer.prefill_step(cfg, ours, torch.from_numpy(prompt),
                                          ctx, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)
    for step in range(2):
        tok = _inputs(cfg, rng, (2, 1))
        clen = np.asarray([20 + step, 20 + step], np.int32)
        want, j_cache = jtf.decode_step(j_cfg, packed, jnp.asarray(tok),
                                        j_ctx, j_cache, jnp.asarray(clen))
        got, cache = transformer.decode_step(
            cfg, ours, torch.from_numpy(tok), ctx, cache,
            torch.from_numpy(clen))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL)

    toks = _inputs(cfg, rng, (3, 4))
    init = rng.standard_normal((cfg.n_layers, 3, 12, cfg.n_kv_heads,
                                cfg.hd)).astype(np.float32)
    kw = dict(offsets=np.asarray([0, 7, 4], np.int32),
              admit_mask=np.asarray([True, False, True]),
              last_index=np.asarray([3, 0, 2], np.int32))
    want, j_cache = jtf.prefill_chunk(
        j_cfg, packed, jnp.asarray(toks), j_ctx,
        {"k": jnp.asarray(init), "v": jnp.asarray(-init)}, **kw)
    cache = {"k": torch.from_numpy(init.copy()),
             "v": torch.from_numpy(-init)}
    got, cache = transformer.prefill_chunk(
        cfg, ours, torch.from_numpy(toks), ctx, cache,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    for row in (0, 2):
        np.testing.assert_allclose(got[row].numpy(), np.asarray(want)[row],
                                   atol=LOGIT_TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(j_cache["k"]),
                               atol=1e-4)
    np.testing.assert_array_equal(cache["k"][:, 1].numpy(), init[:, 1])


# ---------------------------------------------------------------------------
# Engines: lockstep with JAX's, and the port's invariants
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=4)
PAGED_KW = dict(paged=True, page_size=4, kv_pages=32)


def _requests(cfg, seed=0, n=5):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(3, 14))).astype(np.int32)
               for _ in range(n)]
    news = [int(rng.integers(4, 10)) for _ in range(n)]
    return prompts, news


def _port_tokens(cfg, ours, prompts, news, **kw):
    reqs = ServingEngine(cfg, ours, device="cpu", **kw).run(
        [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)])
    assert all(r.done for r in reqs)
    return [r.output.tolist() for r in reqs]


def _jax_tokens(j_cfg, packed, prompts, news, **kw):
    reqs = [JRequest(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, news)]
    JServingEngine(j_cfg, packed, ctx=_j_ctx(j_cfg), **kw).run(reqs)
    return [r.output.tolist() for r in reqs]


def _j_oracle(j_cfg, packed, prompt, max_new, max_seq):
    """JAX's oracle (``tests/test_serving.py::reference_decode``: greedy
    prefill, then one decode step a token) on an f32 cache and its Pallas
    attention."""
    ctx = _j_ctx(j_cfg)
    cache = jtf.init_cache(j_cfg, 1, max_seq, jnp.float32)
    logits, cache = jtf.prefill_step(
        j_cfg, packed, jnp.asarray(np.asarray(prompt, np.int32)[None]), ctx,
        cache)
    toks = [int(jnp.argmax(logits, -1)[0])]
    for pos in range(len(prompt), len(prompt) + max_new - 1):
        logits, cache = jtf.decode_step(
            j_cfg, packed, jnp.asarray([[toks[-1]]], jnp.int32), ctx, cache,
            jnp.asarray(pos, jnp.int32))
        toks.append(int(jnp.argmax(logits, -1)[0]))
    return toks


@pytest.fixture(scope="module")
def dbrx8():
    """Reduced dbrx with 8 experts, top-4 (its default reduction keeps 4
    experts at top-4, which never drops a token)."""
    return _pair("dbrx-132b", n_experts=8)


@pytest.fixture(scope="module")
def mixtral():
    return _pair("mixtral-8x22b")


@pytest.mark.parametrize("paged", [False, True])
def test_dbrx_engine_lockstep_with_jax(dbrx8, paged):
    """At dbrx's capacity factor 1.25: each scheduling mode of the port's
    engine emits the tokens of the same mode of JAX's."""
    j_cfg, packed, cfg, ours = dbrx8
    assert cfg.n_experts == 8 and cfg.top_k == 4
    assert cfg.capacity_factor == 1.25
    prompts, news = _requests(cfg, seed=2)
    kw = dict(ENGINE_KW, **(PAGED_KW if paged else {}))
    modes = {}
    for dev in (False, True):
        want = _jax_tokens(j_cfg, packed, prompts, news, device_sched=dev,
                           **kw)
        got = _port_tokens(cfg, ours, prompts, news, device_sched=dev, **kw)
        assert got == want, (dev, got, want)
        modes[dev] = got
    print(f"dbrx 8 experts, cf 1.25, paged={paged}: host-driven == "
          f"device-resident: {modes[False] == modes[True]} (in both "
          "packages)")


@pytest.mark.parametrize("paged", [False, True])
def test_mixtral_engine_lockstep_with_jax(mixtral, paged):
    """Reduced mixtral (4 experts, top-2, a 16-token window) at 1.25, in
    each scheduling mode, on f32 caches.  On bf16 caches both engines
    round the same K/V to bf16, but where the two frameworks' f32 values
    differ by an ULP the bf16 values may differ by one of theirs, and on
    this model such a difference flips a router's top-2 choice within the
    first tokens (both engines then leave their own oracle by up to 0.77
    in logits: a routing discontinuity, not a fault of either)."""
    j_cfg, packed, cfg, ours = mixtral
    assert cfg.swa_window == 16
    prompts, news = _requests(cfg, seed=3)
    kw = dict(ENGINE_KW, **(PAGED_KW if paged else {}))
    for dev in (False, True):
        want = _jax_tokens(j_cfg, packed, prompts, news, device_sched=dev,
                           cache_dtype=jnp.float32, **kw)
        got = _port_tokens(cfg, ours, prompts, news, device_sched=dev,
                           cache_dtype=torch.float32, **kw)
        assert got == want, (dev, got, want)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_moe_drop_free_invariants(mixtral, cache_dtype):
    """Drop-free: device-resident == host-driven, token for token, on bf16
    and f32 caches; on bf16 caches each storage's tokens are JAX's engine's
    on that storage, on f32 paged == contiguous; on the f32 cache (where
    chunked admission equals monolithic prefill) every request's tokens are
    the oracle's (judged on the engine's own history; a differing token
    only at a near-tie); the oracle's greedy tokens are JAX's oracle's."""
    j_cfg, packed, cfg, ours = mixtral
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    j_cfg = dataclasses.replace(j_cfg, capacity_factor=float(cfg.n_experts))
    prompts, news = _requests(cfg, seed=4)
    runs = {(paged, dev): _port_tokens(
        cfg, ours, prompts, news, device_sched=dev, cache_dtype=cache_dtype,
        **dict(ENGINE_KW, **(PAGED_KW if paged else {})))
        for paged in (False, True) for dev in (False, True)}
    for paged in (False, True):
        assert runs[(paged, False)] == runs[(paged, True)], paged
    if cache_dtype == torch.bfloat16:
        # JAX reads a windowed contiguous bf16 cache with its probabilities
        # rounded to bf16 (its XLA decode) and a paged one in f32, and the
        # port does the same: each storage is held to JAX's engine on the
        # same storage, and JAX's own two storages differ here
        want = {paged: _jax_tokens(
            j_cfg, packed, prompts, news, device_sched=True,
            cache_dtype=jnp.bfloat16,
            **dict(ENGINE_KW, **(PAGED_KW if paged else {})))
            for paged in (False, True)}
        for paged in (False, True):
            assert runs[(paged, True)] == want[paged], paged
        assert want[False] != want[True]
        return
    assert runs[(True, True)] == runs[(False, True)]
    base = runs[(False, True)]
    for p, n, toks in zip(prompts, news, base):
        _, gaps = reference_decode(cfg, ours, Ctx(), p, n,
                                   ENGINE_KW["max_seq"], torch.float32,
                                   follow=toks)
        assert max(gaps) < NEAR_TIE, (toks, gaps)
    for p, n in zip(prompts[:3], news[:3]):
        toks, margins = reference_decode(cfg, ours, Ctx(), p, n,
                                         ENGINE_KW["max_seq"], torch.float32)
        want = _j_oracle(j_cfg, packed, p, n, ENGINE_KW["max_seq"])
        if toks != want:
            i = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b)
            print(f"oracle vs JAX oracle: first flip at {i}, margin "
                  f"{margins[i]:.2e}")
            assert margins[i] < NEAR_TIE
            assert toks[:i] == want[:i]
