"""The port's top-k MoE (``models/layers.py``) against the JAX package's on
the same weights.

``moe_pack`` makes the same codes as JAX's from the same float masters,
bit for bit, and the same per-expert gammas within rtol 1e-6, the
tolerance of ``tests/test_torch_ternary.py::test_ternarize_matches_jax``
for one linear (the absmean is a mean over the bank, which the two
frameworks sum in different orders; the model tests carry JAX's gammas
across).  ``moe_apply`` over the packed banks routes the same tokens to the same experts at the same buffer positions (the router's
logits, the top-k indices, the exclusive-cumsum positions in token-major
order and the capacity keep mask) and gives JAX's output within 1e-5 at
f32: at the configs' capacity factor 1.25 (tokens dropped), drop-free
(``capacity_factor = n_experts``), and with the dispatch chunked
(``Ctx.moe_token_chunk``, JAX's scan over token chunks).  On the CPU every
expert's matmul is ``tlmm``'s plain version; on the card the same call
launches the kernel (``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as j_layers
from repro.models.layers import Ctx as JCtx

from repro_torch.core.bitlinear import Linear
from repro_torch.models import layers
from repro_torch.models.layers import MoE, Ctx

MOE_TOL = 1e-5


def _masters(n_experts=4, d=32, f=48, seed=0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return (rng.standard_normal(shape) / np.sqrt(d)).astype(np.float32)
    router = draw(d, n_experts)
    router[:, 0] += np.float32(0.3)   # expert 0 draws most tokens
    return {"router": {"w": router},
            "gate_w": draw(n_experts, d, f), "up_w": draw(n_experts, d, f),
            "down_w": draw(n_experts, f, d)}


def _port_masters(m):
    return MoE(Linear(torch.from_numpy(m["router"]["w"])),
               {k: torch.from_numpy(m[k]) for k in ("gate_w", "up_w",
                                                    "down_w")})


def _both_packed(g=5, **kw):
    m = _masters(**kw)
    jp = j_layers.moe_pack(jax.tree_util.tree_map(jnp.asarray, m), g)
    ours = layers.moe_pack(_port_masters(m), g)
    return jp, ours


def _jax_route(jp, x, top_k, capacity_factor):
    """JAX's routing steps (``layers._moe_apply_dense_or_packed``), which
    its module does not return on their own."""
    n = x.shape[0]
    n_experts = jp["gate_codes"].shape[0]
    logits = jnp.dot(x, jp["router"]["w"])
    gates, idx = jax.lax.top_k(logits.astype(jnp.float32), top_k)
    capacity = max(int(n * top_k / n_experts * capacity_factor), top_k)
    flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return (np.asarray(idx), np.asarray(pos), np.asarray(pos < capacity),
            capacity, np.asarray(jax.nn.softmax(gates, axis=-1)))


@pytest.mark.parametrize("g", [5, 3])
def test_moe_pack_matches_jax(g):
    jp, ours = _both_packed(g=g, n_experts=4, d=40, f=70)
    assert ours.packed and ours.g == g and ours.n_experts == 4
    for name in MoE.BANKS:
        np.testing.assert_array_equal(
            getattr(ours, f"{name}_codes").numpy(),
            np.asarray(jp[f"{name}_codes"]))
        np.testing.assert_allclose(
            getattr(ours, f"{name}_gamma").numpy(),
            np.asarray(jp[f"{name}_gamma"]), rtol=1e-6)
    np.testing.assert_array_equal(ours.router.w.numpy(),
                                  np.asarray(jp["router"]["w"]))


# (top_k, n_experts, capacity_factor, n tokens, token chunk)
CASES = [
    (2, 4, 1.25, 24, 0),     # mixtral-like, drops
    (4, 8, 1.25, 24, 0),     # dbrx-like top-4 of 8, drops
    (2, 4, 4.0, 24, 0),      # drop-free
    (2, 4, 1.25, 24, 8),     # chunked dispatch, capacity a chunk
    (2, 4, 0.5, 10, 0),      # a capacity of top_k: most pairs dropped
    (1, 4, 1.25, 1, 0),      # one token
]


@pytest.mark.parametrize("top_k,n_experts,cf,n,tc", CASES)
def test_moe_apply_matches_jax(top_k, n_experts, cf, n, tc):
    jp, ours = _both_packed(n_experts=n_experts, d=32, f=48, seed=n_experts)
    x = (np.random.default_rng(n + tc).standard_normal((n, 32))
         + 0.5).astype(np.float32)
    xt = torch.from_numpy(x)
    if not tc:
        r = layers.moe_route(ours, xt, top_k=top_k, capacity_factor=cf)
        idx, pos, keep, cap, gates = _jax_route(jp, jnp.asarray(x), top_k, cf)
        np.testing.assert_array_equal(r["idx"].numpy(), idx)
        np.testing.assert_array_equal(r["pos"].numpy(), pos)
        np.testing.assert_array_equal(r["keep"].numpy(), keep)
        assert r["capacity"] == cap
        np.testing.assert_allclose(r["gates"].numpy(), gates, atol=1e-6)
        if cf < n_experts and n > 1:   # one token always fits (top_k)
            assert not keep.all(), "the case was meant to drop tokens"
        else:
            assert keep.all()
    want = j_layers.moe_apply(
        jp, jnp.asarray(x), top_k=top_k, capacity_factor=cf,
        ctx=JCtx(mode="packed", group_size=5, moe_token_chunk=tc))
    got = layers.moe_apply(ours, xt, top_k=top_k, capacity_factor=cf,
                           ctx=Ctx(moe_token_chunk=tc))
    assert got.dtype == torch.float32 and got.shape == (n, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_TOL)


def test_moe_chunked_dispatch_counts_capacity_a_chunk():
    """With a token chunk the capacity is a chunk's: the chunked output is
    the per-chunk output concatenated, and differs from the unchunked one
    where the chunk's capacity drops other tokens."""
    _, ours = _both_packed(n_experts=4, d=32, f=48, seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (24, 32)).astype(np.float32))
    kw = dict(top_k=2, capacity_factor=1.25)
    chunked = layers.moe_apply(ours, x, ctx=Ctx(moe_token_chunk=8), **kw)
    parts = torch.cat([layers.moe_apply(ours, xc, ctx=Ctx(), **kw)
                       for xc in x.split(8)])
    assert torch.equal(chunked, parts)
    # a chunk that does not divide n, or n not above it, is not chunked
    whole = layers.moe_apply(ours, x, ctx=Ctx(), **kw)
    for tc in (7, 24, 48):
        assert torch.equal(
            layers.moe_apply(ours, x, ctx=Ctx(moe_token_chunk=tc), **kw),
            whole)


def test_moe_bf16_activations_match_jax():
    """bf16 activations: the buffers, h and the output in bf16 as in JAX
    (2^-5 of the largest output, 4 bf16 ULPs)."""
    jp, ours = _both_packed(n_experts=4, d=32, f=48, seed=6)
    x = np.random.default_rng(7).standard_normal((12, 32)).astype(np.float32)
    want = np.asarray(j_layers.moe_apply(
        jp, jnp.asarray(x, jnp.bfloat16), top_k=2, capacity_factor=4.0,
        ctx=JCtx(mode="packed", group_size=5)), np.float32)
    got = layers.moe_apply(ours, torch.from_numpy(x).bfloat16(), top_k=2,
                           capacity_factor=4.0, ctx=Ctx())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 ** -5 * np.abs(want).max())
