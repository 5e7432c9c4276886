"""Port vs JAX on the same packed weights: BitLinear, and the three model
entry points of reduced qwen1.5-0.5b (QKV bias, untied dense head) and
reduced bitnet-0.73b (tied embeddings).

The JAX package packs the weights (``init_params`` -> ``pack_params``), the
test turns the pytree into numpy arrays, and ``convert.from_jax_packed``
builds the port's parameters from them, so both sides hold the same codes,
gammas, biases, norms and embeddings.

JAX runs its Pallas attention kernels (interpret mode): the port's
attention computes their f32 arithmetic, while JAX's XLA decode path rounds
the softmax probabilities to the cache dtype (bf16).  Its linears run the
XLA packed path, whose integer sums equal ``tlmm``'s.

Integer stages are bit-exact only from identical f32 inputs: ``rsqrt``,
``mean`` and ``exp`` differ by ULPs between the two frameworks, which can
move an int8 activation by one code, so logits are compared with
``LOGIT_TOL`` (absolute, on logits of order 0.1-1) and greedy tokens must
agree except at a near-tie (top-2 margin below ``NEAR_TIE``, printed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import bitlinear as j_bl
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.core import bitlinear, ternary
from repro_torch.core.bitlinear import PackedLinear
from repro_torch.kernels.tlmm import ops as tlmm_ops
from repro_torch.kernels.tlmm import ref as tlmm_ref
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving.engine import reference_decode

LOGIT_TOL = 2e-3
NEAR_TIE = 1e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module", params=["qwen1.5-0.5b", "bitnet-0.73b"])
def models(request):
    name = request.param
    j_cfg = j_get_config(name).reduced()
    cfg = get_config(name).reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, _np_tree(packed), device="cpu")
    j_ctx = JCtx(mode="packed", group_size=j_cfg.group_size,
                 attn_impl="pallas")
    return j_cfg, packed, j_ctx, cfg, ours, Ctx()


@pytest.mark.parametrize("g", [5, 3])
def test_bitlinear_packed_and_predecoded_match_jax(g):
    """The pack group travels with the packed weights: every path decodes
    the codes with the ``g`` they were packed with."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((70, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((5, 70)).astype(np.float32) * 2
    jp = j_bl.pack({"w": jnp.asarray(w), "b": jnp.asarray(b)}, g=g)
    tp = PackedLinear(*(torch.from_numpy(np.array(jp[k]))
                        for k in ("codes", "gamma", "b")), g=g)
    assert bitlinear.pack(bitlinear.Linear(torch.from_numpy(w)), g).g == g
    want = np.asarray(j_bl.apply_packed(jp, jnp.asarray(x), g=g,
                                        out_dtype=jnp.float32))
    xt = torch.from_numpy(x)
    got = bitlinear.apply_packed(tp, xt, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # on the CPU the tlmm wrapper is its plain version
    x_q, _ = ternary.absmax_quant(xt)
    np.testing.assert_array_equal(
        tlmm_ops.tlmm(x_q, tp.codes, g=g).numpy(),
        tlmm_ref.tlmm_ref(x_q, tp.codes, g, 70).numpy())
    dec = bitlinear.predecode(tp)
    np.testing.assert_array_equal(dec.wt.numpy(),
                                  np.asarray(j_bl.predecode(jp, g=g)["wt"]))
    got = bitlinear.apply_predecoded(dec, xt, out_dtype=torch.float32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_bl.apply_predecoded(
            j_bl.predecode(jp, g=g), jnp.asarray(x), out_dtype=jnp.float32)))
    np.testing.assert_array_equal(got.numpy(), want)
    # fused Q|K|V-style matrix == the parts applied one by one
    fused = bitlinear.apply_predecoded(bitlinear.predecode_fused([tp, tp]),
                                       xt, out_dtype=torch.float32)
    np.testing.assert_array_equal(fused.numpy(), np.concatenate([want] * 2, 1))


def test_prefill_step_matches_jax(models):
    j_cfg, packed, j_ctx, cfg, ours, ctx = models
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11))
    want, j_cache = jtf.prefill_step(
        j_cfg, packed, jnp.asarray(prompt), j_ctx,
        jtf.init_cache(j_cfg, 2, 16, jnp.bfloat16))
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    got, cache = transformer.prefill_step(cfg, ours, torch.from_numpy(prompt),
                                          ctx, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)
    np.testing.assert_allclose(cache["k"].float().numpy(),
                               np.asarray(j_cache["k"], np.float32),
                               atol=5e-2, rtol=1e-2)


def test_prefill_chunk_matches_jax_and_monolithic(models):
    """A ragged 3-slot wave: rows 0 and 2 admit chunks at offsets 0 and 4,
    row 1 is masked (its cache row must stay untouched)."""
    j_cfg, packed, j_ctx, cfg, ours, ctx = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 4))
    init = rng.standard_normal((cfg.n_layers, 3, 12, cfg.n_kv_heads,
                                cfg.hd)).astype(np.float32)
    kw = dict(offsets=np.asarray([0, 7, 4], np.int32),
              admit_mask=np.asarray([True, False, True]),
              last_index=np.asarray([3, 0, 2], np.int32))
    j_cache = {"k": jnp.asarray(init), "v": jnp.asarray(-init)}
    want, j_cache = jtf.prefill_chunk(j_cfg, packed, jnp.asarray(toks), j_ctx,
                                      j_cache, **kw)
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

    # chunked in place (f32 cache, no rounding between chunks) == one
    # monolithic prefill of the same prompt, in the port alone
    prompt = rng.integers(0, cfg.vocab_size, 10)
    mono, mono_cache = transformer.prefill_step(
        cfg, ours, torch.from_numpy(prompt)[None], ctx,
        transformer.init_cache(cfg, 1, 16, torch.float32, "cpu"))
    cache = transformer.init_cache(cfg, 3, 16, torch.float32, "cpu")
    for lo in range(0, 10, 4):
        t = np.zeros((3, 4), np.int64)
        seg = prompt[lo:lo + 4]
        t[1, :len(seg)] = seg
        logits, cache = transformer.prefill_chunk(
            cfg, ours, torch.from_numpy(t), ctx, cache,
            offsets=[0, lo, 0], admit_mask=[False, True, False],
            last_index=[0, min(9 - lo, 3), 0])
    torch.testing.assert_close(logits[1], mono[0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["k"][:, 1, :10], mono_cache["k"][:, 0, :10],
                               atol=1e-4, rtol=1e-4)
    assert not cache["k"][:, 0].any() and not cache["k"][:, 2].any()


def test_decode_step_matches_jax(models):
    """Ragged per-row lengths, including a lane parked at max_seq (its write
    clamps to the last row position)."""
    j_cfg, packed, j_ctx, cfg, ours, ctx = models
    rng = np.random.default_rng(3)
    S = 16
    init = rng.standard_normal((cfg.n_layers, 3, S, cfg.n_kv_heads, cfg.hd))
    init = np.asarray(jnp.asarray(init, jnp.float32).astype(jnp.bfloat16),
                      np.float32)
    toks = rng.integers(0, cfg.vocab_size, (3, 1))
    lens = np.asarray([3, 9, S], np.int32)
    j_cache = {n: jnp.asarray(s * init).astype(jnp.bfloat16)
               for n, s in (("k", 1), ("v", -1))}
    want, j_cache = jtf.decode_step(j_cfg, packed, jnp.asarray(toks), j_ctx,
                                    j_cache, jnp.asarray(lens))
    cache = {n: torch.from_numpy(s * init).to(torch.bfloat16)
             for n, s in (("k", 1), ("v", -1))}
    got, cache = transformer.decode_step(cfg, ours, torch.from_numpy(toks),
                                         ctx, cache, torch.from_numpy(lens))
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2],
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(cache["k"].float().numpy(),
                               np.asarray(j_cache["k"], np.float32),
                               atol=5e-2, rtol=1e-2)
    # the parked lane wrote row S - 1 and nothing past it
    assert not torch.equal(cache["k"][:, 2, S - 1].float(),
                           torch.from_numpy(init[:, 2, S - 1]))


def _jax_reference_decode(cfg, packed, ctx, prompt, max_new, max_seq):
    """The JAX oracle of tests/test_serving.py (unbatched greedy), with
    its two entry points jitted."""
    prefill = jax.jit(lambda p, t, c: jtf.prefill_step(cfg, p, t, ctx, c))
    decode = jax.jit(lambda p, t, c, n: jtf.decode_step(cfg, p, t, ctx, c, n))
    cache = jtf.init_cache(cfg, 1, max_seq, jnp.bfloat16)
    logits, cache = prefill(packed, jnp.asarray(np.asarray(prompt)[None]),
                            cache)
    toks = [int(jnp.argmax(logits, -1)[0])]
    for pos in range(len(prompt), len(prompt) + max_new - 1):
        logits, cache = decode(packed, jnp.asarray([[toks[-1]]], jnp.int32),
                               cache, jnp.asarray(pos, jnp.int32))
        toks.append(int(jnp.argmax(logits, -1)[0]))
    return toks


def assert_tokens_agree(got, want, margins):
    """Equal greedy tokens, or a first flip at a printed near-tie."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            print(f"greedy flip at emit index {i}: top-2 margin "
                  f"{margins[i]:.2e}")
            assert margins[i] < NEAR_TIE, (got, want, margins)
            return
    assert len(got) == len(want)


def test_reference_decode_tokens_match_jax(models):
    j_cfg, packed, j_ctx, cfg, ours, ctx = models
    rng = np.random.default_rng(4)
    for plen in (5, 12):
        prompt = rng.integers(0, cfg.vocab_size, plen)
        want = _jax_reference_decode(j_cfg, packed, j_ctx, prompt, 6, 24)
        got, margins = reference_decode(cfg, ours, ctx, prompt, 6, 24)
        assert_tokens_agree(got, want, margins)
