"""The paper's Fig. 6b attention baselines in the port against the JAX
package's: ``models.attention.attention_skip`` / ``attention_naive`` against
``attention_xla_skip`` / ``attention_xla_naive`` on the same inputs (causal
and windowed, GQA, odd sizes that fall back to one chunk), and
``prefill_step`` under each ``Ctx.attn`` against JAX's ``attn_impl`` on the
same packed weights of reduced qwen1.5-0.5b.

Tolerances: the ops compute the same f32 online softmax tile for tile
(``OP_TOL``, a few f32 ULPs of outputs of order 1 after different
summation orders); the logits go through int8 activation quantizers that
ULP-level differences can move by one code (``LOGIT_TOL``, the port's
model tests' tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.models import attention, transformer
from repro_torch.models.layers import Ctx

OP_TOL = 2e-6
LOGIT_TOL = 2e-3

torch.set_num_threads(1)

# (b, h, kv_h, s, d, q_chunk, kv_chunk, window)
SHAPES = [
    (2, 4, 2, 32, 16, 8, 8, None),     # GQA, 4 x 4 tiles
    (1, 4, 4, 32, 16, 8, 16, 12),      # MHA, unequal tiles, windowed
    (2, 6, 2, 24, 8, 8, 8, 5),         # GQA 3:1, window inside a tile
    (1, 2, 1, 13, 16, 8, 8, None),     # odd length: one chunk each way
    (2, 4, 2, 21, 8, 7, 4, 6),         # kv_chunk does not divide: one kv chunk
]


def _inputs(b, h, kv_h, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kv_h, s, d)).astype(np.float32),
            rng.standard_normal((b, kv_h, s, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_skip_and_naive_match_jax(shape, causal):
    b, h, kv_h, s, d, qc, kc, window = shape
    q, k, v = _inputs(b, h, kv_h, s, d, seed=s + h)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    skip = attention.attention_skip(tq, tk, tv, **kw)
    naive = attention.attention_naive(tq, tk, tv, **kw)
    np.testing.assert_allclose(
        skip.numpy(), np.asarray(j_attn.attention_xla_skip(jq, jk, jv, **kw)),
        atol=OP_TOL, rtol=0)
    np.testing.assert_allclose(
        naive.numpy(),
        np.asarray(j_attn.attention_xla_naive(jq, jk, jv, **kw)),
        atol=OP_TOL, rtol=0)
    # the two schedules compute the same attention (naive's extra tiles
    # are fully masked)
    np.testing.assert_allclose(skip.numpy(), naive.numpy(), atol=OP_TOL,
                               rtol=0)
    assert skip.shape == (b, h, s, d) and skip.dtype == torch.float32


def test_live_tile_pairs_match_jax():
    for args in ((4, 4, 8, 8, True, None), (4, 2, 8, 16, True, 12),
                 (3, 3, 8, 8, False, 5), (1, 1, 13, 13, True, None)):
        assert attention.live_tile_pairs(*args) == j_attn.live_tile_pairs(
            *args)
    # the skip schedule issues the causal half of naive's tiles
    assert len(attention.live_tile_pairs(8, 8, 8, 8, True, None)) == 36


def test_bf16_inputs_return_bf16():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 4, 2, 16, 8, seed=0))
    for fn in (attention.attention_skip, attention.attention_naive):
        out = fn(q, k, v, q_chunk=8, kv_chunk=8)
        ref = fn(q.float(), k.float(), v.float(), q_chunk=8, kv_chunk=8)
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(out, ref.to(torch.bfloat16), atol=0,
                                   rtol=0)


def test_ctx_attn_rejects_unknown():
    with pytest.raises(ValueError, match="Ctx.attn"):
        Ctx(attn="xla")


@pytest.fixture(scope="module")
def served():
    j_cfg = j_get_config("qwen1.5-0.5b").reduced()
    cfg = get_config("qwen1.5-0.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    return j_cfg, packed, cfg, ours


@pytest.mark.parametrize("attn,j_impl", [("kernel", "pallas"),
                                         ("skip", "xla"),
                                         ("naive", "xla_naive")])
def test_prefill_step_under_each_attn_matches_jax(served, attn, j_impl):
    """A 2 x 16 prompt on 8-token tiles (4 of naive's tiles are fully
    masked), and the three port schedules against each other."""
    j_cfg, packed, cfg, ours = served
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    j_ctx = JCtx(mode="packed", group_size=j_cfg.group_size,
                 attn_impl=j_impl, attn_q_chunk=8, attn_kv_chunk=8)
    want, _ = jtf.prefill_step(j_cfg, packed, jnp.asarray(prompt), j_ctx,
                               jtf.init_cache(j_cfg, 2, 16, jnp.bfloat16))
    ctx = Ctx(attn=attn, attn_q_chunk=8, attn_kv_chunk=8)
    got, _ = transformer.prefill_step(
        cfg, ours, torch.from_numpy(prompt), ctx,
        transformer.init_cache(cfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)
    kernel, _ = transformer.prefill_step(
        cfg, ours, torch.from_numpy(prompt), Ctx(),
        transformer.init_cache(cfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(got.numpy(), kernel.numpy(), atol=LOGIT_TOL)
