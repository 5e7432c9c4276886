"""hymba's SSM heads in the port against the JAX package: the module
(``models/ssm.py``) on the same packed weights and numpy inputs, and the
reduced hymba-1.5b model through ``prefill_step`` and ``decode_step``.

Tolerances: the module's outputs and states within 1e-5 at f32 (the
frameworks' einsums, exp and softplus differ by ULPs); the model's logits
within ``LOGIT_TOL`` (rsqrt/exp ULPs move int8 activation codes, as in
``tests/test_torch_model.py``) and its state planes within 1e-5.

A prompt shorter than ``ssm_conv - 1`` tokens: the port's conv ring is the
zero-padded window the causal conv reads, so prefill(p[:2]) then
decode(p[2]) continues prefill(p[:3]).  JAX slices the ring at a negative
start there and returns fewer rows than its cache holds (ROADMAP C); that
test pins JAX's shape so the difference stays written down.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed, packed_from_jax
from repro_torch.core.bitlinear import Linear
from repro_torch.models import ssm, transformer
from repro_torch.models.layers import Ctx, Params

G = 5
TOL = 1e-5
LOGIT_TOL = 2e-3
B, D, H, HD, N = 2, 16, 2, 8, 16
J_CTX = JCtx(mode="packed", group_size=G, impl="pallas", attn_impl="pallas")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_sub(tree: dict) -> Params:
    """A JAX sub-layer dict (packed linears, dense tensors) -> Params."""
    return Params(**{
        k: (packed_from_jax({a: np.array(b) for a, b in v.items()}, G, "cpu")
            if isinstance(v, dict) else torch.from_numpy(np.array(v)))
        for k, v in tree.items()})


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def module():
    masters = jssm.ssm_init(jax.random.PRNGKey(0), D, H, HD, N)
    packed = jssm.ssm_pack(masters, G)
    return masters, packed, _port_sub(packed)


def _x(s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, s, D)).astype(np.float32)


@pytest.mark.parametrize("s,chunk", [(32, 8), (13, 8), (5, 128)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_forward_matches_jax(module, s, chunk, with_state):
    """Several chunks (32 over 8), one odd-length chunk (13 over 8: the
    chunk does not divide, so one chunk) and a short sequence; with and
    without the returned state."""
    _, packed, ours = module
    x = _x(s)
    kw = dict(n_heads=H, head_dim=HD, state=N, chunk=chunk,
              return_state=with_state)
    want = jssm.ssm_forward(packed, jnp.asarray(x), J_CTX, **kw)
    got = ssm.ssm_forward(ours, torch.from_numpy(x), Ctx(), **kw)
    if not with_state:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
        return
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=TOL)
    np.testing.assert_allclose(got[1]["h"].numpy(), np.asarray(want[1]["h"]),
                               atol=TOL)
    assert got[1]["conv"].shape == want[1]["conv"].shape == (B, 3, H * HD)
    np.testing.assert_allclose(got[1]["conv"].numpy(),
                               np.asarray(want[1]["conv"]), atol=TOL)


def test_ssm_step_matches_jax(module):
    """Three steps from a random state, both packages carrying their own."""
    _, packed, ours = module
    rng = np.random.default_rng(3)
    st = {"h": rng.standard_normal((B, H, N, HD)).astype(np.float32),
          "conv": rng.standard_normal((B, 3, H * HD)).astype(np.float32)}
    j_st = {k: jnp.asarray(v) for k, v in st.items()}
    t_st = {k: torch.from_numpy(v) for k, v in st.items()}
    x = _x(3, seed=4)
    kw = dict(n_heads=H, head_dim=HD, state=N)
    for t in range(3):
        want, j_st = jssm.ssm_step(packed, jnp.asarray(x[:, t:t + 1]), j_st,
                                   J_CTX, **kw)
        got, t_st = ssm.ssm_step(ours, torch.from_numpy(x[:, t:t + 1]), t_st,
                                 Ctx(), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
        for k in st:
            np.testing.assert_allclose(t_st[k].numpy(), np.asarray(j_st[k]),
                                       atol=TOL)


@pytest.mark.parametrize("s,chunk", [(32, 8), (13, 8)])
def test_ssm_chunked_equals_stepwise(module, s, chunk):
    """The port's chunked scan equals its own step loop (JAX's
    ``test_ssm_forward_matches_stepwise``, the tolerances there)."""
    _, _, ours = module
    x = torch.from_numpy(_x(s, seed=1) * 0.5)
    kw = dict(n_heads=H, head_dim=HD, state=N)
    y_par, st_par = ssm.ssm_forward(ours, x, Ctx(), chunk=chunk,
                                    return_state=True, **kw)
    st = ssm.ssm_init_state(B, H, HD, N, 4, H * HD, device="cpu")
    ys = []
    for t in range(s):
        y, st = ssm.ssm_step(ours, x[:, t:t + 1], st, Ctx(), **kw)
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st_par["h"].numpy(), st["h"].numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st_par["conv"].numpy(), st["conv"].numpy(),
                               atol=1e-5)


def test_ssm_pack_equals_jax(module):
    """The port packs JAX's float masters into JAX's codes bit for bit,
    with JAX's absmean gammas within rtol 1e-6 (a mean: the frameworks sum
    in different orders, as ``tests/test_torch_moe.py`` finds), and passes
    the dense tensors through."""
    masters, packed, _ = module
    ours = ssm.ssm_pack(Params(**{
        k: (Linear(_t(v["w"])) if isinstance(v, dict) else _t(v))
        for k, v in masters.items()}), G)
    for name in ssm.LINEARS:
        np.testing.assert_array_equal(ours[name].codes.numpy(),
                                      np.asarray(packed[name]["codes"]))
        np.testing.assert_allclose(ours[name].gamma.numpy(),
                                   np.asarray(packed[name]["gamma"]),
                                   rtol=1e-6)
    for name in ssm.DENSE:
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(packed[name]))


# ---------------------------------------------------------------------------
# The reduced hymba model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hymba():
    j_cfg = j_get_config("hymba-1.5b").reduced()
    cfg = get_config("hymba-1.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    return j_cfg, packed, cfg, ours


def test_hymba_config_reduces_as_expected(hymba):
    _, _, cfg, ours = hymba
    assert cfg.block_kind == "hymba" and cfg.swa_window == 16
    assert cfg.ssm_chunk == 16 and len(ours["layers"]) == cfg.n_layers
    assert set(ours["layers"][0].keys()) == {"ln1", "ln2", "attn", "ssm",
                                              "mlp"}


def _compare_state(cache, j_cache):
    for k in ("h", "conv"):
        np.testing.assert_allclose(cache["ssm"][k].float().numpy(),
                                   np.asarray(j_cache["ssm"][k]), atol=TOL)


def test_hymba_prefill_and_decode_match_jax(hymba):
    """A 20-token prompt (past the reduced 16-token window, two SSM chunks
    of 16 do not divide 20: one chunk), then three decode steps, on f32
    caches: logits within LOGIT_TOL, K/V and state planes within 1e-5."""
    j_cfg, packed, cfg, ours = hymba
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 20))
    want, j_cache = jtf.prefill_step(
        j_cfg, packed, jnp.asarray(prompt), J_CTX,
        jtf.init_cache(j_cfg, 2, 24, jnp.float32))
    cache = transformer.init_cache(cfg, 2, 24, torch.float32, device="cpu")
    got, cache = transformer.prefill_step(cfg, ours, torch.from_numpy(prompt),
                                          Ctx(), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)
    _compare_state(cache, j_cache)
    np.testing.assert_allclose(cache["k"][:, :, :20].numpy(),
                               np.asarray(j_cache["k"])[:, :, :20], atol=TOL)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        clen = np.asarray([20 + step, 20 + step], np.int32)
        want, j_cache = jtf.decode_step(j_cfg, packed, jnp.asarray(tok),
                                        J_CTX, j_cache, jnp.asarray(clen))
        got, cache = transformer.decode_step(
            cfg, ours, torch.from_numpy(tok), Ctx(), cache,
            torch.from_numpy(clen))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL)
        _compare_state(cache, j_cache)


@pytest.mark.parametrize("s", [7, 17])
def test_hymba_decode_continues_prefill(hymba, s):
    """prefill(p[:s]) then decode(p[s]) gives prefill(p[:s + 1])'s logits
    and state, at f32 (17 crosses the reduced window)."""
    _, _, cfg, ours = hymba
    p = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (1, s + 1)))
    c1 = transformer.init_cache(cfg, 1, s + 1, torch.float32, device="cpu")
    transformer.prefill_step(cfg, ours, p[:, :s], Ctx(), c1)
    got, c1 = transformer.decode_step(cfg, ours, p[:, s:], Ctx(), c1, s)
    c2 = transformer.init_cache(cfg, 1, s + 1, torch.float32, device="cpu")
    want, c2 = transformer.prefill_step(cfg, ours, p, Ctx(), c2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_TOL)
    np.testing.assert_allclose(c1["ssm"]["h"].numpy(), c2["ssm"]["h"].numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(c1["ssm"]["conv"].numpy(),
                               c2["ssm"]["conv"].numpy(), atol=TOL)


@pytest.mark.parametrize("plen", [1, 2])
def test_short_prompt_ring_is_zero_padded(hymba, plen):
    """A prompt shorter than the 3-row ring: the ring holds zeros before
    the prompt's rows, the cache keeps its shape, and decoding the next
    token equals prefilling plen + 1 tokens (within LOGIT_TOL at f32)."""
    _, _, cfg, ours = hymba
    p = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 3)))
    cache = transformer.init_cache(cfg, 1, 4, torch.float32, device="cpu")
    cache["ssm"]["conv"].fill_(7.0)     # a previous occupant's ring
    transformer.prefill_step(cfg, ours, p[:, :plen], Ctx(), cache)
    ring = cache["ssm"]["conv"]
    assert ring.shape == (cfg.n_layers, 1, cfg.ssm_conv - 1,
                          cfg.n_heads * cfg.hd)
    assert torch.all(ring[:, :, :cfg.ssm_conv - 1 - plen] == 0)
    got, _ = transformer.decode_step(cfg, ours, p[:, plen:plen + 1], Ctx(),
                                     cache, plen)
    ref = transformer.init_cache(cfg, 1, 4, torch.float32, device="cpu")
    want, _ = transformer.prefill_step(cfg, ours, p[:, :plen + 1], Ctx(), ref)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_TOL)


def test_jax_short_prompt_ring_shape_differs(hymba):
    """JAX's prefill of a 2-token prompt returns a ring of one row where its
    cache holds three (``xin[:, s - (cw - 1):]`` at s = 2 starts at -1):
    the reference behaviour ROADMAP C records, not repaired there."""
    j_cfg, packed, cfg, _ = hymba
    j_cache = jtf.init_cache(j_cfg, 1, 4, jnp.float32)
    _, out = jtf.prefill_step(j_cfg, packed, jnp.asarray([[3, 5]]), J_CTX,
                              j_cache)
    d_inner = cfg.n_heads * cfg.hd
    assert j_cache["ssm"]["conv"].shape == (cfg.n_layers, 1, 3, d_inner)
    assert out["ssm"]["conv"].shape == (cfg.n_layers, 1, 1, d_inner)
