"""The port's QAT training path against the JAX package's, on the CPU.

JAX draws the float master weights (``init_params``); ``convert.
from_jax_params`` carries them across, so both sides train the same
masters on the same batches.  JAX runs jitted, as its launcher runs the
step: XLA turns the activation quantizer's ``/ 127.0`` into a product by
f32(1/127) (ROADMAP C2), which the port's STE quantizer takes everywhere.

Tolerances, each written where it is used:
- integer stages (int8 codes, ternary codes) are bit for bit from the same
  f32 inputs; the absmean gamma is a mean summed in another order
  (``GAMMA_RTOL``, as ``tests/test_torch_moe.py``);
- float stages (products, softmax, norms) differ by summation order:
  ``OP_TOL`` relative to the largest value;
- a model's logits and gradients pass through int8 activation quantizers,
  where an f32 input a few ULPs off a rounding boundary moves a code by
  one.  ``_explain_gap`` then shows the first moved code on JAX's own
  linear inputs (every earlier linear's codes equal, the moved ones by
  exactly one, their f32 inputs within ``INPUT_ULPS``) instead of
  loosening the model check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import bitlinear as j_bl
from repro.core import ternary as j_tern
from repro.models import attention as j_attn
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.optim import adamw as j_adamw
from repro.training import make_train_step as j_make_train_step

from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_jax, from_jax_packed,
                                 from_jax_params, named_from_jax)
from repro_torch.core import bitlinear, ternary
from repro_torch.models import attention, transformer
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.optim.adamw import apply_updates, jax_rank, trainable
from repro_torch.training import (loss_and_grads, make_train_step,
                                  softmax_xent)

torch.set_num_threads(1)

GAMMA_RTOL = 1e-6
OP_TOL = 2e-6       # relative to the largest |value| of the compared tensor
MODEL_TOL = 2e-5    # logits, losses and gradients with no code moved
INPUT_ULPS = 2e-6   # f32 linear inputs that moved a code: ULPs apart
CODE_GAP_TOL = 0.1  # logits after one-code moves (see _explain_gap)

ARCHS = ["bitnet-0.73b", "qwen1.5-0.5b", "musicgen-medium"]
J_CTX = JCtx(mode="qat", attn_q_chunk=8, attn_kv_chunk=8)
CTX = Ctx(mode="qat", attn="skip", attn_q_chunk=8, attn_kv_chunk=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "token":
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    else:
        inputs = (rng.standard_normal((b, s, cfg.d_model)) * 0.02
                  ).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    j_cfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    jp = jtf.init_params(j_cfg, jax.random.PRNGKey(3))
    return j_cfg, jp, cfg, from_jax_params(cfg, _np_tree(jp), "cpu")


# ---------------------------------------------------------------------------
# Where a code moved: JAX's and the port's inputs of every QAT linear
# ---------------------------------------------------------------------------

def _jax_linear_inputs(j_cfg, jp, inputs):
    """JAX's logits and the input of every QAT linear in call order, from
    one jitted forward with the layers unrolled (the scan's tracers cannot
    leave it; the unrolled logits equal the scanned ones, asserted)."""
    def run(p, x):
        recs, orig = [], j_bl.apply_qat

        def rec(pp, xx, **kw):
            recs.append(xx)
            return orig(pp, xx, **kw)

        j_bl.apply_qat = rec
        try:
            h = jtf._embed_in(j_cfg, p, x, J_CTX)
            pos = jnp.arange(h.shape[1])
            for i in range(j_cfg.n_layers):
                lp = jax.tree_util.tree_map(lambda a: a[i], p["layers"])
                h, _ = jtf._block_apply(j_cfg, J_CTX, h, lp, None, pos,
                                        "full", None, None, None)
            return jtf._lm_head(j_cfg, p, h, J_CTX), recs
        finally:
            j_bl.apply_qat = orig

    logits, recs = jax.jit(run)(jp, jnp.asarray(inputs))
    return np.asarray(logits), [np.asarray(r) for r in recs]


def _port_linear_inputs(cfg, params, inputs):
    recs, orig = [], bitlinear.apply_qat

    def rec(p, x, **kw):
        recs.append(x.detach().clone().numpy())
        return orig(p, x, **kw)

    bitlinear.apply_qat = rec
    try:
        with torch.no_grad():
            transformer.forward(cfg, params, torch.from_numpy(inputs), CTX,
                                remat=False)
    finally:
        bitlinear.apply_qat = orig
    return recs


def _explain_gap(j_cfg, jp, cfg, params, inputs) -> str:
    """Asserts that a model-level gap comes from int8 activation codes
    moved by one: every QAT linear up to the first moved code sees the
    same codes, the first moved codes differ by exactly one, from f32
    inputs within INPUT_ULPS.  Returns the finding for the message."""
    j_logits, j_in = _jax_linear_inputs(j_cfg, jp, inputs)
    scanned = np.asarray(jax.jit(
        lambda p, x: jtf.forward(j_cfg, p, x, J_CTX))(jp, jnp.asarray(inputs)))
    np.testing.assert_array_equal(j_logits, scanned)
    t_in = _port_linear_inputs(cfg, params, inputs)
    assert len(j_in) == len(t_in)
    for i, (a, b) in enumerate(zip(j_in, t_in)):
        qa, _ = ternary.absmax_quant(torch.from_numpy(a), reciprocal=True)
        qb, _ = ternary.absmax_quant(torch.from_numpy(b), reciprocal=True)
        moved = (qa.int() - qb.int()).abs()
        if moved.any():
            gap = float(np.abs(a - b).max())
            assert int(moved.max()) == 1 and gap <= INPUT_ULPS, (
                f"linear {i}: codes moved by {int(moved.max())} from f32 "
                f"inputs {gap} apart")
            return (f"linear {i} of {len(j_in)}: {int((moved > 0).sum())} "
                    f"int8 codes moved by 1 from f32 inputs {gap:.3g} apart")
    raise AssertionError("a model-level gap with no moved int8 code")


# ---------------------------------------------------------------------------
# STE quantizers and the QAT linear
# ---------------------------------------------------------------------------

def test_absmax_quant_ste_matches_jitted_jax_and_passes_gradients():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 96)).astype(np.float32) * 3
    want = np.asarray(jax.jit(j_tern.absmax_quant_ste)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ternary.absmax_quant_ste(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # eager JAX divides by 127 where jitted JAX multiplies: the port
    # follows the jitted step, so somewhere the eager values differ
    eager = np.asarray(j_tern.absmax_quant_ste(jnp.asarray(x)))
    assert not np.array_equal(eager, want)
    r = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    (g,) = torch.autograd.grad((got * r).sum(), xt)
    assert torch.equal(g, r)   # straight through


def test_ternarize_ste_matches_jitted_jax_and_passes_gradients():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    want = np.asarray(jax.jit(j_tern.ternarize_ste)(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = ternary.ternarize_ste(wt)
    j_codes, j_gamma = jax.jit(j_tern.ternarize)(jnp.asarray(w))
    codes, gamma = ternary.ternarize(torch.from_numpy(w))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_allclose(gamma.item(), float(j_gamma), rtol=GAMMA_RTOL)

    # w + (gamma * W_t - w), in f32 with each side's gamma: the STE's
    # expression, kept as it is (not gamma * W_t)
    def expr(g):
        wq = (np.clip(np.round(w / g), -1, 1) * g).astype(np.float32)
        return w + (wq - w)

    np.testing.assert_array_equal(want, expr(np.float32(j_gamma)))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  expr(np.float32(gamma.item())))
    r = torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))
    (g,) = torch.autograd.grad((got * r).sum(), wt)
    assert torch.equal(g, r)


@pytest.mark.parametrize("int8_fwd", [False, True])
def test_apply_qat_forward_and_grads_match_jax(int8_fwd):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 96)).astype(np.float32) * 3
    w = rng.standard_normal((96, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    r = rng.standard_normal((4, 16, 40)).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}

    def j_loss(p, x):
        return jnp.sum(j_bl.apply_qat(p, x, int8_fwd=int8_fwd) * r)

    j_y = np.asarray(jax.jit(lambda p, x: j_bl.apply_qat(
        p, x, int8_fwd=int8_fwd))(jp, jnp.asarray(x)))
    j_gp, j_gx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    lin = bitlinear.Linear(torch.from_numpy(w).requires_grad_(True),
                           torch.from_numpy(b).requires_grad_(True))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bitlinear.apply_qat(lin, xt, int8_fwd=int8_fwd)
    gx, gw, gb = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                     [xt, lin.w, lin.b])
    assert _rel(y.detach(), j_y) < OP_TOL
    for got, want in ((gx, j_gx), (gw, j_gp["w"]), (gb, j_gp["b"])):
        assert _rel(got, want) < OP_TOL
    if int8_fwd:
        # the integer forward is the fake-quant product up to association
        y_fq = bitlinear.apply_qat(lin, xt).detach()
        assert _rel(y.detach(), y_fq) < OP_TOL


def test_int8_forward_asserts_its_exactness_bound():
    lin = bitlinear.Linear(torch.ones(132104, 1))
    with pytest.raises(AssertionError, match="exact"):
        bitlinear.apply_qat(lin, torch.ones(1, 132104), int8_fwd=True)


# ---------------------------------------------------------------------------
# The flash VJP
# ---------------------------------------------------------------------------

# (b, h, kv_h, s, d, q_chunk, kv_chunk, window)
FLASH_SHAPES = [
    (2, 4, 2, 32, 16, 8, 8, None),     # GQA 2:1, 4 x 4 tiles
    (1, 4, 4, 32, 16, 8, 8, 8),        # MHA, window 8
    (2, 6, 2, 24, 8, 8, 8, 8),         # GQA 3:1, window 8
    (1, 2, 1, 13, 16, 8, 8, None),     # odd length: one chunk each way
    (2, 4, 2, 21, 8, 7, 4, 6),         # kv_chunk does not divide
]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_vjp_matches_jax(shape):
    b, h, kv_h, s, d, qc, kc, window = shape
    rng = np.random.default_rng(s * h)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kv_h, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kv_h, s, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=qc, kv_chunk=kc)

    def j_fn(q, k, v):
        return j_attn.attention_xla_skip(q, k, v, **kw)

    j_out, j_vjp = jax.vjp(jax.jit(j_fn), jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
    j_grads = j_vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = attention.attention_skip(tq, tk, tv, **kw)
    grads = torch.autograd.grad(out, [tq, tk, tv], torch.from_numpy(do))
    assert _rel(out.detach(), j_out) < OP_TOL
    for got, want in zip(grads, j_grads):
        assert _rel(got, want) < OP_TOL
    # the custom backward against autograd through the naive schedule
    ref = attention.attention_naive(tq, tk, tv, **kw)
    ref_grads = torch.autograd.grad(ref, [tq, tk, tv], torch.from_numpy(do))
    for got, want in zip(grads, ref_grads):
        assert _rel(got, want) < OP_TOL


def test_flash_forward_saves_no_score_matrix():
    """The forward keeps (q, k, v, out, lse) for the backward, nothing of
    (s x s): what makes long-sequence training fit."""
    b, h, s, d = 1, 2, 64, 8
    tq, tk, tv = (torch.randn(b, h, s, d, requires_grad=True)
                  for _ in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        attention.attention_skip(tq, tk, tv, q_chunk=16, kv_chunk=16)
    assert saved and all(sh[-1] in (d, 1) and s * s not in sh
                         for sh in saved), saved


def test_attention_kernel_refuses_a_gradient():
    cfg = get_config("bitnet-0.73b").reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    for t in trainable(params).values():
        t.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        transformer.forward(cfg, params, torch.zeros(1, 8, dtype=torch.long),
                            Ctx(mode="qat"))


# ---------------------------------------------------------------------------
# Models: forward, chunked loss and gradients
# ---------------------------------------------------------------------------

def test_forward_matches_jax(model):
    j_cfg, jp, cfg, params = model
    batch = _batch(cfg, 2, 16, seed=0)
    want = np.asarray(jax.jit(lambda p, x: jtf.forward(j_cfg, p, x, J_CTX))(
        jp, jnp.asarray(batch["inputs"])))
    with torch.no_grad():
        got = transformer.forward(cfg, params, torch.from_numpy(
            batch["inputs"]), CTX).numpy()
    assert got.shape == (2, 16, cfg.vocab_size)
    gap = float(np.abs(got - want).max())
    if gap > MODEL_TOL * np.abs(want).max():
        why = _explain_gap(j_cfg, jp, cfg, params, batch["inputs"])
        assert gap <= CODE_GAP_TOL, f"{gap} after {why}"


@pytest.mark.parametrize("loss_chunk", [8, 0])
def test_loss_and_grads_match_jax(model, loss_chunk):
    """The chunked loss (two 8-position chunks) and the full-logits loss,
    with every gradient, against JAX's jitted value_and_grad; the chunked
    loss equals the full one."""
    j_cfg, jp, cfg, params = model
    batch = _batch(cfg, 2, 16, seed=1)

    def j_loss(p, batch):
        if loss_chunk:
            x = jtf.forward_features(j_cfg, p, batch["inputs"], J_CTX)
            return jtf.lm_head_loss_chunked(j_cfg, p, x, batch["labels"],
                                            J_CTX, chunk=loss_chunk)
        from repro.training.steps import softmax_xent as j_xent
        return j_xent(jtf.forward(j_cfg, p, batch["inputs"], J_CTX),
                      batch["labels"])

    j_val, j_g = jax.jit(jax.value_and_grad(j_loss))(jp, _j(batch))
    val, grads = loss_and_grads(cfg, CTX, params, _t(batch), loss_chunk)
    j_named = named_from_jax(cfg, _np_tree(j_g), "cpu")
    assert set(grads) == set(j_named)
    worst = max(grads, key=lambda n: _rel(grads[n], j_named[n]))
    gap = _rel(grads[worst], j_named[worst])
    if abs(float(val) - float(j_val)) > MODEL_TOL or gap > MODEL_TOL:
        why = _explain_gap(j_cfg, jp, cfg, params, batch["inputs"])
        assert abs(float(val) - float(j_val)) < 1e-3 and gap < 1e-2, (
            f"loss {float(val)} vs {float(j_val)}, {worst} {gap} after {why}")
    assert not any(t.requires_grad for t in trainable(params).values())
    with torch.no_grad():
        other = transformer.lm_head_loss_chunked(
            cfg, params, transformer.forward_features(
                cfg, params, torch.from_numpy(batch["inputs"]), CTX),
            torch.from_numpy(batch["labels"]), CTX, chunk=16 - loss_chunk)
    assert abs(float(other) - float(val)) < 1e-6


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_policies_change_no_gradient(policy):
    """Recomputing a block (either policy) or keeping it (remat off) gives
    the same gradients bit for bit."""
    cfg = get_config("bitnet-0.73b").reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(4))
    batch = _t(_batch(cfg, 2, 16, seed=2))
    ctx = dataclasses.replace(CTX, remat_policy=policy)
    _, g_remat = loss_and_grads(cfg, ctx, params, batch)
    leaves = trainable(params)
    for t in leaves.values():
        t.requires_grad_(True)
    x = transformer.forward_features(cfg, params, batch["inputs"], ctx,
                                     remat=False)
    loss = transformer.lm_head_loss_chunked(cfg, params, x, batch["labels"],
                                            ctx)
    g_plain = torch.autograd.grad(loss, list(leaves.values()))
    for t in leaves.values():
        t.requires_grad_(False)
    for n, g in zip(leaves, g_plain):
        assert torch.equal(g_remat[n], g), n


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_update_matches_jax_with_stacked_norm_decay(model):
    """One update from a JAX state after one step (non-zero moments, step
    1, warmup), on JAX's gradients.  Weight decay follows JAX's leaf rank:
    the per-layer norms (stacked, 2-D in JAX) decay, ``final_norm`` does
    not."""
    j_cfg, jp, cfg, _ = model
    params = from_jax_params(cfg, _np_tree(jp), "cpu")
    rng = np.random.default_rng(5)
    j_grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
            np.float32)), jp)
    j_opt = j_adamw(lr=1e-2, warmup_steps=3)
    opt = adamw(lr=1e-2, warmup_steps=3)
    j_state = j_opt.init(jp)
    _, j_state = jax.jit(j_opt.update)(j_grads, j_state, jp)
    j_upd, j_state2 = jax.jit(j_opt.update)(j_grads, j_state, jp)
    state = adamw_state_from_jax(cfg, _np_tree(j_state), "cpu")
    grads = named_from_jax(cfg, _np_tree(j_grads), "cpu")
    upd, state2 = opt.update(grads, state, params)
    j_named = named_from_jax(cfg, _np_tree(j_upd), "cpu")
    assert int(state2.step) == int(j_state2.step) == 2
    for n in upd:
        assert _rel(upd[n], j_named[n]) < OP_TOL, n
    for name, m in (("m", state2.m), ("v", state2.v)):
        j_m = named_from_jax(cfg, _np_tree(getattr(j_state2, name)), "cpu")
        for n in m:
            assert _rel(m[n], j_m[n]) < OP_TOL, (name, n)
    # decay pinned on a zero gradient: stacked norms and biases decay
    zero = {n: torch.zeros_like(g) for n, g in grads.items()}
    upd0, _ = adamw(lr=1e-2, weight_decay=0.5, grad_clip=None).update(
        zero, opt.init(params), params)
    assert jax_rank("layers.0.ln1.w", params["layers"][0]["ln1"].w) == 2
    named = trainable(params)
    for n, u in upd0.items():
        decays = n.startswith("layers.") or u.dim() >= 2
        want = -1e-2 * (0.5 * named[n]) if decays else torch.zeros_like(u)
        assert torch.allclose(u, want, rtol=1e-6, atol=0), n
    assert not upd0["final_norm.w"].abs().sum()
    assert upd0["layers.1.ln2.w"].abs().sum() > 0


def test_adamw_descends_quadratic_and_clips():
    opt = adamw(lr=0.1, weight_decay=0.0, grad_clip=None)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        upd, state = opt.update({"w": 2 * params["w"]}, state, params)
        params = apply_updates(params, upd)
    assert params["w"].abs().max() < 1e-2
    clip = adamw(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    p = {"w": torch.zeros(4)}
    upd, _ = clip.update({"w": torch.full((4,), 1e9)}, clip.init(p), p)
    assert torch.isfinite(upd["w"]).all()


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

# AdamW's first update is lr * g / (|g| + eps) an element: about +-lr
# wherever |g| >> eps = 1e-8, but where |g| is near eps the summation noise
# of the two packages' gradients (MODEL_TOL of the largest) moves it by up
# to lr.  A parameter element may differ from JAX's only there.
NEAR_EPS_GRAD = 1e-6


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """One step of reduced bitnet (4 rows) against JAX's jitted step from
    the same masters: the loss, and every updated parameter element equal
    to JAX's within OP_TOL except where JAX's gradient lies within
    NEAR_EPS_GRAD of zero and the two gradients within MODEL_TOL."""
    j_cfg = j_get_config("bitnet-0.73b").reduced()
    cfg = get_config("bitnet-0.73b").reduced()
    jp = jtf.init_params(j_cfg, jax.random.PRNGKey(6))
    params = from_jax_params(cfg, _np_tree(jp), "cpu")
    batch = _batch(cfg, 4, 16, seed=3)
    j_opt, opt = j_adamw(lr=1e-3), adamw(lr=1e-3)
    j_step = jax.jit(j_make_train_step(j_cfg, J_CTX, j_opt,
                                       microbatches=microbatches,
                                       loss_chunk=8))
    step = make_train_step(cfg, CTX, opt, microbatches=microbatches,
                           loss_chunk=8)
    j_p1, j_s1, j_m = j_step(jp, j_opt.init(jp), _j(batch))
    params, state, m = step(params, opt.init(params), _t(batch))
    assert abs(float(m["loss"]) - float(j_m["loss"])) < MODEL_TOL
    j_named = named_from_jax(cfg, _np_tree(j_p1), "cpu")
    j_m1 = named_from_jax(cfg, _np_tree(j_s1.m), "cpu")
    flipped = 0
    for n, t in trainable(params).items():
        off = (t - j_named[n]).abs() > OP_TOL * j_named[n].abs().max()
        # the first moment after one step is (1 - b1) times the clipped
        # gradient, on each side
        j_g, g = j_m1[n] / 0.1, state.m[n] / 0.1
        assert _rel(g, j_g) < MODEL_TOL, n
        assert (j_g[off].abs() < NEAR_EPS_GRAD).all(), n
        assert ((g - j_g)[off].abs() < MODEL_TOL * j_g.abs().max()).all(), n
        flipped += int(off.sum())
    assert flipped < 20, flipped


def test_microbatches_accumulate_the_whole_batch():
    cfg = get_config("bitnet-0.73b").reduced()
    batch = _t(_batch(cfg, 4, 16, seed=4))
    outs = []
    for mb in (1, 2):
        params = transformer.init_params(cfg, torch.Generator().manual_seed(7))
        opt = adamw(lr=1e-3)
        params, _, m = make_train_step(cfg, CTX, opt, microbatches=mb)(
            params, opt.init(params), batch)
        outs.append((float(m["loss"]), trainable(params)))
    assert abs(outs[0][0] - outs[1][0]) < 1e-6
    for n, t in outs[0][1].items():
        assert _rel(outs[1][1][n], t) < 1e-4, n


def test_four_steps_track_jax():
    """Four steps of reduced bitnet on the synthetic stream from the same
    converted init: the loss trajectory against JAX's jitted step."""
    from repro.data.pipeline import SyntheticLMDataset as JData
    from repro_torch.data.pipeline import SyntheticLMDataset

    j_cfg = j_get_config("bitnet-0.73b").reduced()
    cfg = get_config("bitnet-0.73b").reduced()
    jp = jtf.init_params(j_cfg, jax.random.PRNGKey(0))
    params = from_jax_params(cfg, _np_tree(jp), "cpu")
    j_opt, opt = j_adamw(lr=1e-3), adamw(lr=1e-3)
    j_state, state = j_opt.init(jp), opt.init(params)
    j_step = jax.jit(j_make_train_step(j_cfg, J_CTX, j_opt, loss_chunk=8))
    step = make_train_step(cfg, CTX, opt, loss_chunk=8)
    j_data = JData(j_cfg, batch=2, seq_len=16, seed=0)
    data = SyntheticLMDataset(cfg, batch=2, seq_len=16, seed=0, device="cpu")
    j_losses, losses = [], []
    for i in range(4):
        jp, j_state, j_m = j_step(jp, j_state, j_data.batch_at(i))
        params, state, m = step(params, state, data.batch_at(i))
        j_losses.append(float(j_m["loss"]))
        losses.append(float(m["loss"]))
    # the first loss comes from the same masters; later ones from masters
    # that differ at near-eps gradient elements (test_train_step_matches_jax)
    # and, through each tensor's absmean, in ULPs of every gamma
    assert abs(losses[0] - j_losses[0]) < MODEL_TOL
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=5e-4)
    assert losses[-1] < losses[0]


def test_softmax_xent_matches_jax():
    from repro.training.steps import softmax_xent as j_xent
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 4
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    want = float(jax.jit(j_xent)(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels)))
    assert abs(got - want) < 1e-6


# ---------------------------------------------------------------------------
# Ctx.mode: master weights under the default context
# ---------------------------------------------------------------------------

def test_default_ctx_fake_quantizes_master_weights(model):
    """Before ``Ctx.mode``, the port applied a master ``Linear`` as a dense
    product under every context (what ``mode="dense"`` does now) while
    JAX's default ``Ctx(mode="qat")`` fake-quantizes it, so the same
    masters gave different logits.  Under the default contexts the two now
    agree; the LM head stays dense (``ternary_head=False``)."""
    j_cfg, jp, cfg, params = model
    batch = _batch(cfg, 2, 16, seed=6)
    j_cache = jtf.init_cache(j_cfg, 2, 16, jnp.float32)
    j_logits, _ = jax.jit(lambda p, x, c: jtf.prefill_step(
        j_cfg, p, x, JCtx(), c))(jp, jnp.asarray(batch["inputs"]), j_cache)
    j_logits = np.asarray(j_logits)

    def port(ctx):
        cache = transformer.init_cache(cfg, 2, 16, torch.float32, "cpu")
        with torch.no_grad():
            return transformer.prefill_step(
                cfg, params, torch.from_numpy(batch["inputs"]), ctx,
                cache)[0].numpy()

    assert Ctx().mode == "qat"
    dense = port(Ctx(mode="dense"))
    assert np.abs(dense - j_logits).max() > 1e-2   # the divergence
    got = port(Ctx())
    gap = float(np.abs(got - j_logits).max())
    assert gap < 2e-3, gap   # the packed model tests' LOGIT_TOL
    # the head: dense under qat, so ternarizing it would move the logits
    if "lm_head" in params:
        h = torch.randn(3, cfg.d_model)
        from repro_torch.models import layers
        lin = params["lm_head"]
        assert torch.equal(layers.linear_apply(lin, h, Ctx(),
                                               ternary_w=False),
                           h @ lin.w)


def test_packed_params_ignore_ctx_mode():
    cfg = get_config("qwen1.5-0.5b").reduced()
    j_cfg = j_get_config("qwen1.5-0.5b").reduced()
    packed = from_jax_packed(cfg, _np_tree(jtf.pack_params(
        j_cfg, jtf.init_params(j_cfg, jax.random.PRNGKey(1)))), "cpu")
    x = torch.randint(0, cfg.vocab_size, (1, 9))
    outs = []
    for mode in ("qat", "packed", "dense"):
        cache = transformer.init_cache(cfg, 1, 16, torch.float32, "cpu")
        with torch.no_grad():
            outs.append(transformer.prefill_step(cfg, packed, x,
                                                 Ctx(mode=mode), cache)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="mode"):
        Ctx(mode="fp8")
    with pytest.raises(ValueError, match="remat_policy"):
        Ctx(remat_policy="all")


def test_int8_forward_training_tracks_fake_quant():
    """Three steps on the integer forward (``Ctx.qat_int8_fwd``) against
    three on the fake-quant one: the same math up to association, so the
    losses stay within JAX's own bound for this (``tests/test_system.py``,
    5e-3)."""
    from repro_torch.data.pipeline import SyntheticLMDataset
    cfg = get_config("bitnet-0.73b").reduced()
    data = SyntheticLMDataset(cfg, batch=2, seq_len=32, seed=0, device="cpu")
    results = {}
    for int8 in (False, True):
        ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16,
                  qat_int8_fwd=int8)
        opt = adamw(lr=1e-3)
        step = make_train_step(cfg, ctx, opt, loss_chunk=0)
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
        state = opt.init(params)
        for i in range(3):
            params, state, m = step(params, state, data.batch_at(i))
        results[int8] = float(m["loss"])
    assert abs(results[False] - results[True]) < 5e-3, results
