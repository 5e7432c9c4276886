"""The port against JAX at bf16 activations (``Ctx(act_dtype=bfloat16)``,
JAX ``act_dtype="bfloat16"``) on the same packed weights: the three model
entry points of reduced qwen1.5-0.5b and reduced bitnet-0.73b, with
contiguous bf16 and int8 caches and a paged cache (bf16 and int8).  JAX runs
its Pallas attention kernels in interpret mode, as its own tests do.

Tolerance.  bf16 carries an 8-bit mantissa: each rounding moves a value by
up to 2^-9 of it, and the two frameworks round at different places (XLA
fuses elementwise chains and may keep their intermediates in f32, PyTorch
rounds after every operation).  A last-bit difference in a normed
activation can move its int8 code by one (1/127 of the row's absmax), and
the logits themselves are bf16, so one ULP of the largest logit is 2^-7 of
it.  Logits are held within ``BF16_REL`` of the largest |logit| of the
call, 4 bf16 ULPs of it; the f32 tests' 2e-3 does not hold here.  Greedy
tokens must agree except at a near-tie, whose margin is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving.engine import reference_decode

BF16_REL = 2.0 ** -5     # 4 ULPs (2^-7 each) of the largest |logit|
NEAR_TIE = 2.0 ** -5     # of the largest |logit|, as BF16_REL
CTX = Ctx(act_dtype=torch.bfloat16)


@pytest.fixture(scope="module", params=["qwen1.5-0.5b", "bitnet-0.73b"])
def models(request):
    name = request.param
    j_cfg = j_get_config(name).reduced()
    cfg = get_config(name).reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    j_ctx = JCtx(mode="packed", group_size=j_cfg.group_size,
                 attn_impl="pallas", act_dtype="bfloat16")
    return j_cfg, packed, j_ctx, cfg, ours


def assert_logits_close(got, want, rows=None):
    """bf16 logits (b, vocab) of the port against JAX's, within BF16_REL of
    the largest |logit| of the compared rows."""
    assert got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    if rows is not None:
        g, w = g[list(rows)], w[list(rows)]
    lim = BF16_REL * np.abs(w).max()
    err = np.abs(g - w).max()
    print(f"max |port - jax| {err:.4g} (limit {lim:.4g})")
    assert err <= lim


def _cache(cfg, j_cfg, b, S, kv_quant, rng):
    """A filled contiguous cache, the same values on both sides: bf16 K/V
    rows, or int8 rows with their f32 scales."""
    shape = (cfg.n_layers, b, S, cfg.n_kv_heads, cfg.hd)
    if kv_quant:
        vals = {n: rng.integers(-127, 128, shape).astype(np.int8)
                for n in ("k", "v")}
        vals.update({n: (rng.random(shape[:-1]) * 0.05).astype(np.float32)
                     for n in ("k_scale", "v_scale")})
        return ({n: jnp.asarray(x) for n, x in vals.items()},
                {n: torch.from_numpy(x.copy()) for n, x in vals.items()})
    x = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.float32)
                   .astype(jnp.bfloat16), np.float32)
    return ({"k": jnp.asarray(x).astype(jnp.bfloat16),
             "v": jnp.asarray(-x).astype(jnp.bfloat16)},
            {"k": torch.from_numpy(x).to(torch.bfloat16),
             "v": torch.from_numpy(-x).to(torch.bfloat16)})


def test_bf16_prefill_step_matches_jax(models):
    j_cfg, packed, j_ctx, cfg, ours = models
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11))
    want, _ = jtf.prefill_step(j_cfg, packed, jnp.asarray(prompt), j_ctx,
                               jtf.init_cache(j_cfg, 2, 16, jnp.bfloat16))
    got, _ = transformer.prefill_step(
        cfg, ours, torch.from_numpy(prompt), CTX,
        transformer.init_cache(cfg, 2, 16, device="cpu"))
    assert_logits_close(got, want)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_bf16_prefill_chunk_matches_jax(models, kv_quant):
    """A ragged wave against a filled contiguous cache: rows 0 and 2 admit
    chunks at offsets 0 and 4, row 1 is masked."""
    j_cfg, packed, j_ctx, cfg, ours = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 4))
    j_cache, cache = _cache(cfg, j_cfg, 3, 12, kv_quant, rng)
    kw = dict(offsets=np.asarray([0, 7, 4], np.int32),
              admit_mask=np.asarray([True, False, True]),
              last_index=np.asarray([3, 0, 2], np.int32))
    want, _ = jtf.prefill_chunk(j_cfg, packed, jnp.asarray(toks), j_ctx,
                                j_cache, **kw)
    got, _ = transformer.prefill_chunk(
        cfg, ours, torch.from_numpy(toks), CTX, cache,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_logits_close(got, want, rows=(0, 2))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_bf16_decode_step_matches_jax(models, kv_quant):
    """Ragged lengths against a filled contiguous cache."""
    j_cfg, packed, j_ctx, cfg, ours = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 1))
    lens = np.asarray([3, 9, 15], np.int32)
    j_cache, cache = _cache(cfg, j_cfg, 3, 16, kv_quant, rng)
    want, _ = jtf.decode_step(j_cfg, packed, jnp.asarray(toks), j_ctx,
                              j_cache, jnp.asarray(lens))
    got, _ = transformer.decode_step(cfg, ours, torch.from_numpy(toks), CTX,
                                     cache, torch.from_numpy(lens))
    assert_logits_close(got, want)


PS, MAX_SEQ = 5, 16     # 16 is no whole number of 5-token pages
TABLE = np.asarray([[7, 3, 9, 5], [0, 0, 0, 0], [2, 11, 4, 8]], np.int32)


def _schedule(vocab):
    """Two admission waves of 4-token chunks (rows 0 and 2; row 1 idles),
    then one decode step: [(tokens, prefill_chunk kwargs or decode
    lengths)]."""
    rng = np.random.default_rng(6)
    calls = []
    for lo in (0, 4):
        calls.append((rng.integers(0, vocab, (3, 4)), dict(
            offsets=np.asarray([lo, 0, lo], np.int32),
            admit_mask=np.asarray([True, False, True]),
            last_index=np.asarray([3, 0, 3], np.int32))))
    calls.append((rng.integers(0, vocab, (3, 1)),
                  np.asarray([8, 0, 8], np.int32)))
    return calls


def _port_run(cfg, ours, cache, page_table):
    """The schedule through the port -> the logits of each call."""
    tt = torch.from_numpy
    out = []
    for toks, kw in _schedule(cfg.vocab_size):
        if isinstance(kw, dict):
            logits, _ = transformer.prefill_chunk(
                cfg, ours, tt(toks), CTX, cache,
                **{k: tt(v) for k, v in kw.items()}, page_table=page_table)
        else:
            logits, _ = transformer.decode_step(cfg, ours, tt(toks), CTX,
                                                cache, tt(kw),
                                                page_table=page_table)
        out.append(logits)
    return out


@pytest.mark.parametrize("kv_quant", [False, True])
def test_bf16_paged_model_matches_jax(models, kv_quant):
    """The schedule into shuffled 5-token pages, bf16 or int8."""
    j_cfg, packed, j_ctx, cfg, ours = models
    P = 1 + TABLE.size
    got = _port_run(cfg, ours, transformer.init_paged_cache(
        cfg, P, PS, torch.bfloat16, "cpu", kv_quant=kv_quant),
        torch.from_numpy(TABLE))
    j_cache = jtf.init_paged_cache(j_cfg, P, PS, jnp.bfloat16,
                                   kv_quant=kv_quant)
    table = jnp.asarray(TABLE)
    for g, (toks, kw) in zip(got, _schedule(cfg.vocab_size)):
        if isinstance(kw, dict):
            want, j_cache = jtf.prefill_chunk(
                j_cfg, packed, jnp.asarray(toks), j_ctx, j_cache,
                **{k: jnp.asarray(v) for k, v in kw.items()},
                page_table=table)
        else:
            want, j_cache = jtf.decode_step(j_cfg, packed, jnp.asarray(toks),
                                            j_ctx, j_cache, jnp.asarray(kw),
                                            page_table=table)
        assert_logits_close(g, want, rows=(0, 2))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_bf16_paged_model_equals_contiguous(models, kv_quant):
    """The schedule on a contiguous cache and on the page pool: equal
    logits, bit for bit.  With int8 KV both chunk reads dequantize in the
    activation dtype (int8 and scale cast to bf16, then multiplied), as
    JAX's contiguous and paged chunk paths do."""
    _, _, _, cfg, ours = models
    paged = _port_run(cfg, ours, transformer.init_paged_cache(
        cfg, 1 + TABLE.size, PS, torch.bfloat16, "cpu", kv_quant=kv_quant),
        torch.from_numpy(TABLE))
    contig = _port_run(cfg, ours, transformer.init_cache(
        cfg, 3, MAX_SEQ, torch.bfloat16, "cpu", kv_quant=kv_quant), None)
    for p, c in zip(paged, contig):
        assert torch.equal(p[[0, 2]], c[[0, 2]])


def test_bf16_reference_decode_tokens_match_jax(models):
    """The greedy oracle at bf16 activations (bf16 cache) against JAX's:
    equal tokens, or a first flip at a printed near-tie."""
    j_cfg, packed, j_ctx, cfg, ours = models
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 7)
    prefill = jax.jit(lambda p, t, c: jtf.prefill_step(j_cfg, p, t, j_ctx, c))
    decode = jax.jit(lambda p, t, c, n: jtf.decode_step(j_cfg, p, t, j_ctx,
                                                        c, n))
    cache = jtf.init_cache(j_cfg, 1, 24, jnp.bfloat16)
    logits, cache = prefill(packed, jnp.asarray(prompt[None]), cache)
    want = [int(jnp.argmax(logits, -1)[0])]
    for pos in range(len(prompt), len(prompt) + 5):
        logits, cache = decode(packed, jnp.asarray([[want[-1]]], jnp.int32),
                               cache, jnp.asarray(pos, jnp.int32))
        want.append(int(jnp.argmax(logits, -1)[0]))
    got_logits = []
    got, margins = reference_decode(cfg, ours, CTX, prompt, 6, 24,
                                    logits=got_logits)
    scale = max(float(x.float().abs().max()) for x in got_logits)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            print(f"greedy flip at emit index {i}: top-2 margin "
                  f"{margins[i]:.3g} (near-tie limit {NEAR_TIE * scale:.3g})")
            assert margins[i] < NEAR_TIE * scale, (got, want, margins)
            return
    assert len(got) == len(want) == 6
