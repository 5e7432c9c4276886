"""The port's table-lookup TLMM (the paper's Method 3) against the JAX
package on the same inputs: the enumeration matrix and the lookup oracle,
the plain ``tlmm_lut`` against JAX's Pallas kernel (interpret mode) at the
JAX test's shapes, ``tlmm_lut == tlmm``, the packed linear under both
matmul choices, and a reduced model on ``Ctx(matmul="tlmm_lut")`` against
JAX's ``impl="pallas_lut"`` and against the port's own ``tlmm`` path.

Integer stages are compared for equality.  Model logits against JAX are
held to 2e-3 (the tolerance of ``tests/test_torch_model.py``: ``rsqrt``,
``mean`` and ``exp`` differ by ULPs between the frameworks); the port's two
matmul choices give the same int32 sums, so its logits are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import bitlinear as j_bl
from repro.core import ternary as jt
from repro.kernels.tlmm_lut import ops as j_lut
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed, packed_from_jax
from repro_torch.core import bitlinear, ternary
from repro_torch.kernels.tlmm import ops as tlmm_ops
from repro_torch.kernels.tlmm_lut import ops as lut_ops
from repro_torch.kernels.tlmm_lut import ref as lut_ref
from repro_torch.models import layers, transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving.engine import reference_decode

LOGIT_TOL = 2e-3


def _operands(m, n, k, g, *, rows=None, row_multiple=1, seed=0):
    """int8 (m, n) activations and base-3 codes packed by JAX from an
    (rows * g or n, k) ternary matrix, as numpy arrays."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, size=(m, n)).astype(np.int8)
    wt = rng.integers(-1, 2, size=(rows * g if rows else n, k)).astype(np.int8)
    codes = np.array(jt.pack_ternary(jnp.asarray(wt), g, row_multiple))
    return a, codes


@pytest.mark.parametrize("g", [1, 2, 3, 5])
def test_enumeration_matrix_and_lut_oracle_match_jax(g):
    np.testing.assert_array_equal(ternary.enumeration_matrix(g).numpy(),
                                  np.asarray(jt.enumeration_matrix(g)))
    assert ternary.num_codes(g) == jt.num_codes(g)
    assert ternary.index_bits(g) == jt.index_bits(g)
    a, codes = _operands(3, 7 * g - 1, 11, g, seed=g)   # n below groups * g
    want = np.asarray(jt.ternary_matmul_lut_ref(jnp.asarray(a),
                                                jnp.asarray(codes), g))
    got = ternary.ternary_matmul_lut_ref(torch.from_numpy(a),
                                         torch.from_numpy(codes), g)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lut_oracle_blocks_do_not_change_the_sums(monkeypatch):
    """The oracle takes groups in blocks to bound its memory; any block
    size gives the same int32 sums."""
    a, codes = _operands(5, 200, 33, 5, seed=7)
    ta, tc = torch.from_numpy(a), torch.from_numpy(codes)
    whole = ternary.ternary_matmul_lut_ref(ta, tc, 5)
    for elems in (1, 5 * 33 * 3, 5 * 33 * 17):
        monkeypatch.setattr(ternary, "_LUT_BLOCK_ELEMS", elems)
        assert torch.equal(ternary.ternary_matmul_lut_ref(ta, tc, 5), whole)


@pytest.mark.parametrize("m,n,k,g,rows,row_multiple", [
    (4, 48, 32, 3, None, 1),
    (2, 45, 17, 3, None, 1),
    (8, 50, 64, 5, None, 1),
    (1, 96, 24, 2, None, 1),
    (3, 70, 40, 5, None, 64),   # codes row-padded: 64 rows x 5 > 70
    (2, 50, 16, 5, 8, 1),       # 8 code rows: activations past 40 unused
])
def test_plain_tlmm_lut_matches_jax(m, n, k, g, rows, row_multiple):
    a, codes = _operands(m, n, k, g, rows=rows, row_multiple=row_multiple,
                         seed=m + n + k)
    want = np.asarray(j_lut.tlmm_lut(jnp.asarray(a), jnp.asarray(codes), g=g,
                                     bm=2, bn=6 * g, bk=8, interpret=True))
    ta, tc = torch.from_numpy(a), torch.from_numpy(codes)
    got = lut_ops.tlmm_lut(ta, tc, g=g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(lut_ref.tlmm_lut_ref(ta, tc, g).numpy(),
                                  want)


@pytest.mark.parametrize("g", [2, 3, 5])
@pytest.mark.parametrize("m,n,k", [(1, 64, 48), (7, 165, 130), (16, 320, 9)])
def test_tlmm_lut_equals_tlmm(m, n, k, g):
    a, codes = _operands(m, n, k, g, row_multiple=8, seed=n * g)
    ta, tc = torch.from_numpy(a), torch.from_numpy(codes)
    assert torch.equal(lut_ops.tlmm_lut(ta, tc, g=g),
                       tlmm_ops.tlmm(ta, tc, g=g))


@pytest.mark.parametrize("g", [5, 3])
def test_apply_packed_under_both_matmuls(g):
    rng = np.random.default_rng(g)
    w = rng.standard_normal((70, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((5, 70)).astype(np.float32) * 2
    jp = j_bl.pack({"w": jnp.asarray(w), "b": jnp.asarray(b)}, g=g)
    p = packed_from_jax(jax.tree_util.tree_map(np.array, jp), g, "cpu")
    xt = torch.from_numpy(x)
    lut = bitlinear.apply_packed(p, xt, matmul="tlmm_lut",
                                 out_dtype=torch.float32)
    assert torch.equal(lut, bitlinear.apply_packed(p, xt,
                                                   out_dtype=torch.float32))
    want = j_bl.apply_packed(jp, jnp.asarray(x), g=g, impl="pallas_lut",
                             out_dtype=jnp.float32)
    np.testing.assert_array_equal(lut.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unknown matmul"):
        bitlinear.apply_packed(p, xt, matmul="lut")


def test_ctx_matmul_choice(monkeypatch):
    """Ctx.matmul takes "tlmm" or "tlmm_lut" and nothing else; packed
    linears follow it, pre-decoded ones (the engine's) ignore it."""
    with pytest.raises(ValueError, match="Ctx.matmul"):
        Ctx(matmul="pallas_lut")
    gen = torch.Generator().manual_seed(0)
    p = bitlinear.pack(bitlinear.init(gen, 40, 24))
    x = torch.randn(3, 40, generator=gen)
    calls = []
    real = lut_ops.tlmm_lut
    monkeypatch.setattr(lut_ops, "tlmm_lut",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ctx = Ctx(matmul="tlmm_lut")
    layers.linear_apply(p, x, ctx)
    assert calls == [1]
    layers.linear_apply(bitlinear.predecode(p), x, ctx)
    assert calls == [1]


@pytest.fixture(scope="module", params=["bitnet-0.73b", "qwen1.5-0.5b"])
def lut_models(request):
    name = request.param
    j_cfg = j_get_config(name).reduced()
    cfg = get_config(name).reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    j_ctx = JCtx(mode="packed", group_size=j_cfg.group_size,
                 impl="pallas_lut", attn_impl="pallas")
    return j_cfg, packed, j_ctx, cfg, ours


def test_lut_model_matches_jax_and_the_tlmm_path(lut_models):
    """prefill_step, then a ragged decode_step with a lane parked at
    max_seq, on Ctx(matmul="tlmm_lut"): within LOGIT_TOL of JAX's
    pallas_lut model, and equal to the port's tlmm path (logits and cache).
    The inputs are those of ``test_torch_model.py``'s prefill and decode
    tests, so the LUT path is held where the tlmm path is: a ULP of
    ``rsqrt`` or ``exp`` between the frameworks can move one int8 code, and
    with it a row's logits by some 4e-3, on both paths alike."""
    j_cfg, packed, j_ctx, cfg, ours = lut_models
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11))
    want, _ = jtf.prefill_step(j_cfg, packed, jnp.asarray(prompt), j_ctx,
                               jtf.init_cache(j_cfg, 2, 16, jnp.bfloat16))
    got = {}
    for matmul in ("tlmm_lut", "tlmm"):
        got[matmul], _ = transformer.prefill_step(
            cfg, ours, torch.from_numpy(prompt), Ctx(matmul=matmul),
            transformer.init_cache(cfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(got["tlmm_lut"].numpy(), np.asarray(want),
                               atol=LOGIT_TOL)
    assert torch.equal(got["tlmm_lut"], got["tlmm"])

    rng = np.random.default_rng(3)
    S = 16
    init = rng.standard_normal((cfg.n_layers, 3, S, cfg.n_kv_heads, cfg.hd))
    init = np.asarray(jnp.asarray(init, jnp.float32).astype(jnp.bfloat16),
                      np.float32)
    toks = rng.integers(0, cfg.vocab_size, (3, 1))
    lens = np.asarray([3, 9, S], np.int32)
    want, _ = jtf.decode_step(
        j_cfg, packed, jnp.asarray(toks), j_ctx,
        {n: jnp.asarray(s * init).astype(jnp.bfloat16)
         for n, s in (("k", 1), ("v", -1))}, jnp.asarray(lens))
    caches = {}
    for matmul in ("tlmm_lut", "tlmm"):
        cache = {n: torch.from_numpy(s * init).to(torch.bfloat16)
                 for n, s in (("k", 1), ("v", -1))}
        got[matmul], caches[matmul] = transformer.decode_step(
            cfg, ours, torch.from_numpy(toks), Ctx(matmul=matmul), cache,
            torch.from_numpy(lens))
    np.testing.assert_allclose(got["tlmm_lut"][:2].numpy(),
                               np.asarray(want)[:2], atol=LOGIT_TOL)
    assert torch.equal(got["tlmm_lut"], got["tlmm"])
    for name in ("k", "v"):
        assert torch.equal(caches["tlmm_lut"][name], caches["tlmm"][name])


def test_lut_oracle_equals_the_tlmm_oracle(lut_models):
    """The oracle on Ctx(matmul="tlmm_lut") gives the tlmm oracle's tokens
    and every step's logits, bit for bit (the on-card check of the smoke
    run, at the reduced size)."""
    _, _, _, cfg, ours = lut_models
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 9)
    runs = {}
    for matmul in ("tlmm_lut", "tlmm"):
        logits = []
        toks, _ = reference_decode(cfg, ours, Ctx(matmul=matmul), prompt, 5,
                                   16, torch.float32, logits=logits)
        runs[matmul] = toks, logits
    (lut_toks, lut_logits), (toks, logits) = runs["tlmm_lut"], runs["tlmm"]
    assert lut_toks == toks and len(lut_logits) == len(logits) == 5
    assert all(torch.equal(a, b) for a, b in zip(lut_logits, logits))
