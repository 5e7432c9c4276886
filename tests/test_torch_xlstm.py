"""xLSTM in the port against the JAX package: the mLSTM and sLSTM modules
(``models/xlstm.py``) on the same packed weights and numpy inputs, and the
reduced xlstm-350m model (one pair: an mLSTM and an sLSTM block) through
``prefill_step`` and ``decode_step``.

Tolerances: the modules' outputs and states within 1e-5 at f32; the
model's logits within ``LOGIT_TOL`` (ULPs move int8 activation codes) and
its state planes within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf
from repro.models import xlstm as jx
from repro.models.layers import Ctx as JCtx

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed, packed_from_jax
from repro_torch.core.bitlinear import Linear
from repro_torch.models import transformer, xlstm
from repro_torch.models.layers import Ctx, Params

G = 5
TOL = 1e-5
LOGIT_TOL = 2e-3
B, D, H, HD = 2, 16, 2, 8
J_CTX = JCtx(mode="packed", group_size=G, impl="pallas", attn_impl="pallas")
KINDS = {"mlstm": (jx.mlstm_init, jx.mlstm_pack, xlstm.mlstm_pack,
                   xlstm.MLSTM_LINEARS),
         "slstm": (jx.slstm_init, jx.slstm_pack, xlstm.slstm_pack,
                   xlstm.SLSTM_LINEARS)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_sub(tree: dict) -> Params:
    """A JAX sub-layer dict (packed linears, dense tensors) -> Params."""
    return Params(**{
        k: (packed_from_jax({a: np.array(b) for a, b in v.items()}, G, "cpu")
            if isinstance(v, dict) else _t(v))
        for k, v in tree.items()})


@pytest.fixture(scope="module", params=sorted(KINDS))
def module(request):
    init, pack, _, _ = KINDS[request.param]
    masters = init(jax.random.PRNGKey(0), D, H, HD)
    packed = pack(masters, G)
    return request.param, masters, packed, _port_sub(packed)


def _x(s, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((B, s, D))
            * scale).astype(np.float32)


def _forward(kind, pkg, p, x, ctx, **kw):
    if kind == "mlstm":
        return pkg.mlstm_forward(p, x, ctx, n_heads=H, head_dim=HD, **kw)
    kw.pop("chunk", None)
    return pkg.slstm_forward(p, x, ctx, n_heads=H, head_dim=HD, **kw)


def _step(kind, pkg, p, x, st, ctx):
    fn = pkg.mlstm_step if kind == "mlstm" else pkg.slstm_step
    return fn(p, x, st, ctx, n_heads=H, head_dim=HD)


def _init_state(kind, pkg, **kw):
    fn = pkg.mlstm_init_state if kind == "mlstm" else pkg.slstm_init_state
    return fn(B, H, HD, **kw)


@pytest.mark.parametrize("s,chunk", [(32, 8), (13, 8)])
def test_forward_matches_jax(module, s, chunk):
    """mLSTM over several chunks and over one odd-length chunk (the chunk
    does not divide 13), sLSTM over the same lengths; output and the
    returned state."""
    kind, _, packed, ours = module
    x = _x(s, scale=2.0)
    want, j_st = _forward(kind, jx, packed, jnp.asarray(x), J_CTX,
                          chunk=chunk, return_state=True)
    got, st = _forward(kind, xlstm, ours, torch.from_numpy(x), Ctx(),
                       chunk=chunk, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert st.keys() == j_st.keys()
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(j_st[k]),
                                   atol=TOL, rtol=TOL)
    no_state = _forward(kind, xlstm, ours, torch.from_numpy(x), Ctx(),
                        chunk=chunk)
    assert torch.equal(no_state, got)


def test_step_matches_jax(module):
    """Four steps from the initial state (every ``m`` at -1e30)."""
    kind, _, packed, ours = module
    j_st = _init_state(kind, jx)
    st = _init_state(kind, xlstm, device="cpu")
    x = _x(4, seed=2, scale=2.0)
    for t in range(4):
        want, j_st = _step(kind, jx, packed, jnp.asarray(x[:, t:t + 1]),
                           j_st, J_CTX)
        got, st = _step(kind, xlstm, ours, torch.from_numpy(x[:, t:t + 1]),
                        st, Ctx())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(j_st[k]),
                                       atol=TOL, rtol=TOL)


def test_chunked_equals_stepwise(module):
    """The port's scan equals its own step loop: mLSTM at JAX's
    ``test_mlstm_forward_matches_stepwise`` tolerances, sLSTM (stressed
    inputs, x5) at ``test_slstm_forward_matches_stepwise_and_stable``'s,
    with no NaN."""
    kind, _, _, ours = module
    scale, tol = (0.5, dict(atol=1e-4, rtol=1e-3)) if kind == "mlstm" else (
        5.0, dict(atol=1e-5, rtol=1e-5))
    x = torch.from_numpy(_x(32, seed=1, scale=scale))
    y_par, st_par = _forward(kind, xlstm, ours, x, Ctx(), chunk=8,
                             return_state=True)
    assert not torch.isnan(y_par).any()
    st = _init_state(kind, xlstm, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y, st = _step(kind, xlstm, ours, x[:, t:t + 1], st, Ctx())
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), **tol)
    key = "C" if kind == "mlstm" else "c"
    np.testing.assert_allclose(st_par[key].numpy(), st[key].numpy(), **tol)


def test_pack_equals_jax(module):
    """JAX's float masters packed by the port: JAX's codes bit for bit, its
    gammas within rtol 1e-6 (a mean summed in another order), sLSTM's
    dense ``r`` passed through."""
    kind, masters, packed, _ = module
    _, _, pack, linears = KINDS[kind]
    ours = pack(Params(**{
        k: (Linear(_t(v["w"])) if isinstance(v, dict) else _t(v))
        for k, v in masters.items()}), G)
    for name in linears:
        np.testing.assert_array_equal(ours[name].codes.numpy(),
                                      np.asarray(packed[name]["codes"]))
        np.testing.assert_allclose(ours[name].gamma.numpy(),
                                   np.asarray(packed[name]["gamma"]),
                                   rtol=1e-6)
    if kind == "slstm":
        np.testing.assert_array_equal(ours["r"].numpy(),
                                      np.asarray(packed["r"]))


# ---------------------------------------------------------------------------
# The reduced xlstm-350m model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    j_cfg = j_get_config("xlstm-350m").reduced()
    cfg = get_config("xlstm-350m").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    return j_cfg, packed, cfg, ours


def test_xlstm_tree_has_one_block_a_pair(model):
    _, _, cfg, ours = model
    assert len(ours["layers"]) == cfg.n_layers // 2 == \
        transformer.n_scan_layers(cfg)
    assert set(ours["layers"][0].keys()) == {"ln1", "mlstm", "ln2", "slstm"}
    cache = transformer.init_cache(cfg, 3, 8, device="cpu")
    assert set(cache) == {"mlstm", "slstm"}
    assert cache["mlstm"]["C"].shape == (1, 3, cfg.n_heads, cfg.hd, cfg.hd)
    assert cache["slstm"]["m"].shape == (1, 3, cfg.n_heads, cfg.hd)
    assert all(v.dtype == torch.float32 for c in cache.values()
               for v in c.values())
    assert torch.all(cache["mlstm"]["m"] == -1e30)


def _compare_state(cache, j_cache):
    for sub in ("mlstm", "slstm"):
        for k, v in cache[sub].items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(j_cache[sub][k]),
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [13, 20])
def test_xlstm_prefill_and_decode_match_jax(model, s):
    """A prompt of s tokens, then three decode steps, on both packages'
    f32 caches: logits within LOGIT_TOL, state planes within 1e-5."""
    j_cfg, packed, cfg, ours = model
    rng = np.random.default_rng(s)
    prompt = rng.integers(0, cfg.vocab_size, (2, s))
    want, j_cache = jtf.prefill_step(
        j_cfg, packed, jnp.asarray(prompt), J_CTX,
        jtf.init_cache(j_cfg, 2, s + 4, jnp.float32))
    cache = transformer.init_cache(cfg, 2, s + 4, torch.float32,
                                   device="cpu")
    got, cache = transformer.prefill_step(cfg, ours, torch.from_numpy(prompt),
                                          Ctx(), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)
    _compare_state(cache, j_cache)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        clen = np.asarray([s + step] * 2, np.int32)
        want, j_cache = jtf.decode_step(j_cfg, packed, jnp.asarray(tok),
                                        J_CTX, j_cache, jnp.asarray(clen))
        got, cache = transformer.decode_step(
            cfg, ours, torch.from_numpy(tok), Ctx(), cache,
            torch.from_numpy(clen))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL)
        _compare_state(cache, j_cache)


@pytest.mark.parametrize("s", [1, 9])
def test_xlstm_decode_continues_prefill(model, s):
    """prefill(p[:s]) then decode(p[s]) gives prefill(p[:s + 1])'s logits at
    f32."""
    _, _, cfg, ours = model
    p = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (1, s + 1)))
    c1 = transformer.init_cache(cfg, 1, s + 1, torch.float32, device="cpu")
    transformer.prefill_step(cfg, ours, p[:, :s], Ctx(), c1)
    got, c1 = transformer.decode_step(cfg, ours, p[:, s:], Ctx(), c1, s)
    c2 = transformer.init_cache(cfg, 1, s + 1, torch.float32, device="cpu")
    want, c2 = transformer.prefill_step(cfg, ours, p, Ctx(), c2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_TOL)
