"""The decode read of a windowed contiguous bf16 cache, as JAX reads it.

JAX's model reads a contiguous cache with a sliding window through its XLA
decode (``repro/models/attention.py::decode_attention_xla``, even under
``attn_impl="pallas"``: its Pallas decode kernel takes no window), which
rounds the softmax probabilities to the cache dtype before P.V and sums
the denominator unrounded.  The port's decode read did not round, so on a
bf16 cache hymba and mixtral decoded other logits than JAX's (by up to
0.04 on reduced hymba, enough to flip greedy tokens).  The port's
contiguous read now rounds whenever a window is set on a bf16 cache (the
decode kernel's RP instantiation on the card,
``ref.decode_attention_rounded_ref`` here).  Paged and split-K reads, and
f32 caches, are JAX's without rounding and stay so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx

LOGIT_TOL = 2e-3


def _qkv(b, h, kv_h, S, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, kv_h, S, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,h,kv_h,S,d,lens,window", [
    (3, 4, 2, 48, 32, [5, 40, 48], 16),
    (2, 8, 1, 100, 64, [100, 1], 33)])
def test_rounded_read_matches_jax_windowed_decode(b, h, kv_h, S, d, lens,
                                                  window):
    """On bf16 K/V with a window: the rounded read equals JAX's within
    1e-6; the unrounded one is off by far more (what was repaired)."""
    q, k, v = _qkv(b, h, kv_h, S, d, S + d)
    kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
    cl = np.asarray(lens, np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), kb, vb, jnp.asarray(cl), window=window,
        impl="pallas"))
    qt = torch.from_numpy(q)
    kt, vt = (torch.from_numpy(x).bfloat16() for x in (k, v))
    clt = torch.from_numpy(cl)
    got = da_ops.decode_attention(qt, kt, vt, clt, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    unrounded = da_ref.decode_attention_ref(qt, kt, vt, clt, window=window)
    assert np.abs(unrounded.numpy() - want).max() > 1e-4


def test_f32_cache_read_is_unrounded():
    """On an f32 cache JAX's windowed read rounds nothing (astype f32), and
    the port's unrounded read agrees with it."""
    q, k, v = _qkv(2, 4, 2, 40, 32, 7)
    cl = np.asarray([40, 9], np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl),
        window=16, impl="pallas"))
    got = da_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(cl),
                                  window=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_hymba_bf16_cache_decode_matches_jax():
    """Reduced hymba: a 12-token prompt, then decode steps on a bf16 cache
    as JAX's engine holds it (the prompt's cache cast to the cache dtype):
    logits within LOGIT_TOL of JAX's at every step (the unrounded read is
    off by 0.035 here)."""
    j_cfg = j_get_config("hymba-1.5b").reduced()
    cfg = get_config("hymba-1.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    j_ctx = JCtx(mode="packed", group_size=j_cfg.group_size,
                 attn_impl="pallas")
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, (1, 12))
    full = jtf.init_cache(j_cfg, 1, 24, jnp.bfloat16)
    _, one = jtf.prefill_step(j_cfg, packed, jnp.asarray(prompt), j_ctx,
                              jtf.init_cache(j_cfg, 1, 12, jnp.bfloat16))
    j_cache = jax.tree_util.tree_map(
        lambda f, n: jax.lax.dynamic_update_slice(
            f, n.astype(f.dtype), (0,) * f.ndim), full, one)
    cache = transformer.init_cache(cfg, 1, 24, torch.bfloat16, device="cpu")
    transformer.prefill_step(cfg, ours, torch.from_numpy(prompt), Ctx(),
                             cache)
    for pos in range(12, 20):
        tok = rng.integers(1, cfg.vocab_size, (1, 1))
        want, j_cache = jtf.decode_step(j_cfg, packed, jnp.asarray(tok),
                                        j_ctx, j_cache,
                                        jnp.asarray([pos], jnp.int32))
        got, cache = transformer.decode_step(
            cfg, ours, torch.from_numpy(tok), Ctx(), cache,
            torch.tensor([pos], dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL)
