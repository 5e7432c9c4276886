"""QAT training of the MoE, hymba and xLSTM configs through the port,
against the JAX package's jitted training path on the CPU; and the port's
in-place AdamW.

JAX draws the float masters; ``convert.from_jax_params`` carries them
across, so both packages train the same masters on the same batches.
Tolerances, each written where it is used:
- ``MODULE_TOL`` (1e-5 of the largest value): the MoE, SSM, mLSTM and sLSTM
  modules' outputs and gradients, the modules' serving tolerance;
- ``GAMMA_RTOL``: a per-expert absmean is a mean summed in another order;
- ``MODEL_TOL`` (2e-5): a model's logits, loss and gradients when no int8
  code moved.  Where one did, ``_explain_gap`` shows the first moved code
  on JAX's own quantizer inputs (every earlier quantizer's codes equal,
  the moved ones by exactly one, their f32 inputs within ``INPUT_RTOL``),
  or, for MoE, a token routed otherwise at a router near-tie (below
  ``ROUTER_NEAR_TIE``), and then replays JAX's quantized values in the
  port (``_pinned_loss_and_grads``), which must bring the gap within
  ``MODEL_TOL``: nothing is loosened.
- AdamW is bit for bit against JAX's ``adamw`` run op by op (eagerly):
  jitted XLA contracts ``b1 * m + (1 - b1) * g`` into one FMA (shown
  below), and a clip that bites scales by a global norm, a sum the two
  packages take in other orders (held to ``OP_TOL``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import ternary as j_tern
from repro.data.pipeline import SyntheticLMDataset as JData
from repro.models import layers as j_layers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models import xlstm as jxl
from repro.models.layers import Ctx as JCtx
from repro.optim.adamw import adamw as j_adamw
from repro.optim.adamw import apply_updates as j_apply_updates
from repro.training import make_train_step as j_make_train_step

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_jax, from_jax_params,
                                 named_from_jax)
from repro_torch.core import ternary
from repro_torch.core.bitlinear import Linear
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import layers, ssm, transformer, xlstm
from repro_torch.models.layers import Ctx, MoE, Params
from repro_torch.optim import adamw
from repro_torch.optim.adamw import apply_updates, trainable
from repro_torch.testing import pinned_quantizers
from repro_torch.training import loss_and_grads, make_train_step

OP_TOL = 2e-6
MODULE_TOL = 1e-5
GAMMA_RTOL = 1e-6
MODEL_TOL = 2e-5
INPUT_RTOL = 1e-6   # of the input's largest |value|: a few f32 ULPs
CODE_GAP_TOL = 0.1     # logits after one-code moves (test_torch_training)
ROUTER_NEAR_TIE = 1e-3
# AdamW's first update is +-lr wherever |g| >> eps; an element may differ
# from JAX's only where JAX's gradient is within this of zero
NEAR_EPS_GRAD = 1e-6

ARCHS = ["mixtral-8x22b", "dbrx-132b", "hymba-1.5b", "xlstm-350m"]
J_CTX = JCtx(mode="qat", attn_q_chunk=8, attn_kv_chunk=8)
CTX = Ctx(mode="qat", attn="skip", attn_q_chunk=8, attn_kv_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _model(name):
    j_cfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    jp = jtf.init_params(j_cfg, jax.random.PRNGKey(3))
    return j_cfg, jp, cfg, from_jax_params(cfg, _np_tree(jp), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


# ---------------------------------------------------------------------------
# Where a code moved or an expert flipped: both packages' quantizer inputs
# ---------------------------------------------------------------------------

def _near_tie(logits, top_k):
    """Each row's smallest gap between adjacent logits among its top_k + 1
    largest (all of them when top_k is every expert): where two packages'
    top-k indices or their order differ, some such gap is a near-tie."""
    srt = -np.sort(-np.asarray(logits, np.float64), axis=-1)
    srt = srt[:, :min(top_k + 1, srt.shape[-1])]
    return np.diff(-srt, axis=-1).min(-1)


@functools.lru_cache(maxsize=None)
def _jax_recorder(j_cfg):
    """The jitted recording forward of ``_jax_recorded_forward`` and the
    jitted scanned forward, compiled once a config."""
    return (jax.jit(functools.partial(_recording_run, j_cfg)),
            jax.jit(lambda p, x: jtf.forward(j_cfg, p, x, J_CTX)))


def _jax_recorded_forward(j_cfg, jp, inputs):
    """One jitted JAX forward with the blocks unrolled (its logits equal
    the scanned forward's, asserted): the logits, the input of every
    activation quantizer in call order, every quantizer's output (weights
    and activations) in call order, and every MoE layer's routing (its
    input, top-k indices and keep mask)."""
    run, scanned_fn = _jax_recorder(j_cfg)
    logits, ins, outs, routes = run(jp, jnp.asarray(inputs))
    scanned = scanned_fn(jp, jnp.asarray(inputs))
    np.testing.assert_array_equal(np.asarray(logits), np.asarray(scanned))
    return (np.asarray(logits), [np.asarray(r) for r in ins],
            [np.asarray(r) for r in outs],
            [tuple(np.asarray(a) for a in r[:3]) + (r[3],) for r in routes])


def _recording_run(j_cfg, p, x):
    """The unrolled forward with every quantizer and MoE router recorded
    (the quantizers of JAX's ``bitlinear.apply_qat`` and a copy of its
    ``layers._expert_matmul``, whose vmapped bank the recorder cannot
    reach from inside ``jax.vmap``)."""
    ins, outs, routes = [], [], []
    orig = (j_tern.absmax_quant_ste, j_tern.ternarize_ste,
            j_layers.moe_apply, j_layers._expert_matmul)

    def act(xx, *a, **kw):
        ins.append(xx)
        outs.append(orig[0](xx, *a, **kw))
        return outs[-1]

    def wgt(w, *a, **kw):
        outs.append(orig[1](w, *a, **kw))
        return outs[-1]

    def expert(w, xx, ctx):   # JAX's _expert_matmul, recording its bank
        wq = jax.vmap(orig[1])(w)
        outs.append(wq)
        return jnp.einsum("ecd,edf->ecf", act(xx), wq.astype(xx.dtype))

    def moe(pp, xx, *, top_k, capacity_factor, ctx):
        logits = jnp.dot(xx, pp["router"]["w"]).astype(jnp.float32)
        _, idx = jax.lax.top_k(logits, top_k)
        n_e = pp["gate_w"].shape[0]
        cap = max(int(xx.shape[0] * top_k / n_e * capacity_factor), top_k)
        oh = jax.nn.one_hot(idx.reshape(-1), n_e, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
        routes.append((logits, idx, pos < cap, len(ins)))
        return orig[2](pp, xx, top_k=top_k,
                       capacity_factor=capacity_factor, ctx=ctx)

    j_tern.absmax_quant_ste, j_tern.ternarize_ste = act, wgt
    j_layers.moe_apply, j_layers._expert_matmul = moe, expert
    try:
        h = jtf._embed_in(j_cfg, p, x, J_CTX)
        pos = jnp.arange(h.shape[1])
        for i in range(jtf.n_scan_layers(j_cfg)):
            lp = jax.tree_util.tree_map(lambda a: a[i], p["layers"])
            h, _ = jtf._block_apply(j_cfg, J_CTX, h, lp, None, pos,
                                    "full", None, None, None)
        return jtf._lm_head(j_cfg, p, h, J_CTX), ins, outs, routes
    finally:
        (j_tern.absmax_quant_ste, j_tern.ternarize_ste,
         j_layers.moe_apply, j_layers._expert_matmul) = orig


def _port_recorded_forward(cfg, params, inputs):
    """The port's forward (no gradient, no remat): the input of every
    activation quantizer in call order and every MoE layer's top-k indices
    and keep mask."""
    ins, routes = [], []
    orig_q, orig_route = ternary.absmax_quant_ste, layers.moe_route

    def rec(x, *a, **kw):
        ins.append(x.detach().clone().numpy())
        return orig_q(x, *a, **kw)

    def route(p, x, **kw):
        r = orig_route(p, x, **kw)
        routes.append((r["idx"].numpy(), r["keep"].numpy(), len(ins)))
        return r

    ternary.absmax_quant_ste, layers.moe_route = rec, route
    try:
        with torch.no_grad():
            transformer.forward(cfg, params, torch.from_numpy(inputs), CTX,
                                remat=False)
    finally:
        ternary.absmax_quant_ste, layers.moe_route = orig_q, orig_route
    return ins, routes


def _check_routes(j_cfg, j_routes, t_routes, before=None):
    """Every MoE layer routes every token to JAX's experts, in JAX's slot
    order, with JAX's keep mask; where a token's experts or their order
    differ, JAX's router logits hold a near-tie (below ROUTER_NEAR_TIE)
    among that token's top_k + 1.  With ``before``, only the layers
    routed before that many quantizer calls are checked (a moved code
    there moves every later router's logits by more than ULPs).  Returns
    the tokens that differ."""
    assert len(j_routes) == len(t_routes)
    flips = []
    for i, ((logits, j_idx, j_keep, at), (t_idx, t_keep, t_at)) in enumerate(
            zip(j_routes, t_routes)):
        assert at == t_at
        if before is not None and at > before:
            break
        differ = (j_idx != t_idx).any(-1)
        if differ.any():
            ties = _near_tie(logits[differ], j_cfg.top_k)
            assert (ties < ROUTER_NEAR_TIE).all(), (
                f"layer {i}: experts differ at router gaps {ties}")
            flips.append((i, np.flatnonzero(differ).tolist(),
                          float(ties.max())))
        else:
            np.testing.assert_array_equal(j_keep, t_keep)
    return flips


def _explain_gap(j_cfg, jp, cfg, params, inputs) -> str:
    """Shows what moved a model-level gap: an MoE token routed otherwise at
    a router near-tie, or the first moved int8 code (every quantizer before
    it sees the same codes; the moved ones by exactly one, from f32 inputs
    within INPUT_RTOL of their largest value).  Returns the finding."""
    _, j_in, _, j_routes = _jax_recorded_forward(j_cfg, jp, inputs)
    t_in, t_routes = _port_recorded_forward(cfg, params, inputs)
    assert len(j_in) == len(t_in)
    first = next((i for i, (a, b) in enumerate(zip(j_in, t_in))
                  if not torch.equal(*(ternary.absmax_quant(
                      torch.from_numpy(v), reciprocal=True)[0]
                      for v in (a, b)))), len(j_in))
    flips = _check_routes(j_cfg, j_routes, t_routes, before=first)
    if flips:
        return ("experts differ at router near-ties (layer, tokens, gap): "
                f"{flips}")
    for i, (a, b) in enumerate(zip(j_in, t_in)):
        qa, _ = ternary.absmax_quant(torch.from_numpy(a), reciprocal=True)
        qb, _ = ternary.absmax_quant(torch.from_numpy(b), reciprocal=True)
        moved = (qa.int() - qb.int()).abs()
        if moved.any():
            gap = float(np.abs(a - b).max())
            assert (int(moved.max()) == 1
                    and gap <= INPUT_RTOL * np.abs(a).max()), (
                f"quantizer {i}: codes moved by {int(moved.max())} from f32 "
                f"inputs {gap} apart")
            return (f"quantizer {i} of {len(j_in)}: {int((moved > 0).sum())} "
                    f"int8 codes moved by 1 from f32 inputs {gap:.3g} apart")
    raise AssertionError("a model-level gap with no moved int8 code and no "
                         "rerouted token")


def _pinned_loss_and_grads(j_cfg, jp, cfg, params, batch, chunk):
    """The port's chunked loss and gradients with every QAT quantizer's
    forward value replayed from JAX's forward (straight through, as the
    quantizers are): the two then differ only in their sums' order, so any
    gap left past MODEL_TOL is not the quantizers'."""
    _, _, j_out, _ = _jax_recorded_forward(j_cfg, jp, batch["inputs"])
    leaves = trainable(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        with pinned_quantizers([torch.from_numpy(v) for v in j_out],
                               replay=True):
            x = transformer.forward_features(
                cfg, params, torch.from_numpy(batch["inputs"]), CTX,
                remat=False)
            loss = transformer.lm_head_loss_chunked(
                cfg, params, x, torch.from_numpy(batch["labels"]), CTX,
                chunk=chunk)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return loss.detach(), dict(zip(leaves, grads))


# ---------------------------------------------------------------------------
# AdamW in place
# ---------------------------------------------------------------------------

def _grad_trees(jp, n, scale, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
        jp) for _ in range(n)]


@pytest.mark.parametrize("name", ["mixtral-8x22b", "hymba-1.5b",
                                  "xlstm-350m"])
@pytest.mark.parametrize("clip", [None, 1e9])
def test_adamw_in_place_is_jax_bit_for_bit(name, clip):
    """Four updates of a reduced model's tree (warmup, weight decay by
    JAX's stacked rank: hymba's SSM vectors and every per-layer norm
    decay, ``final_norm`` does not) on the same gradients: parameters, m
    and v equal JAX's op-by-op update bit for bit, with no clip and with
    a clip that does not bite (a scale of exactly 1)."""
    j_cfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    jp = jtf.init_params(j_cfg, jax.random.PRNGKey(1))
    j_opt = j_adamw(lr=1e-2, warmup_steps=3, grad_clip=clip)
    opt = adamw(lr=1e-2, warmup_steps=3, grad_clip=clip)
    params = from_jax_params(cfg, _np_tree(jp), "cpu")
    j_state, state = j_opt.init(jp), opt.init(params)
    for g in _grad_trees(jp, 4, 1e-3, seed=2):
        j_upd, j_state = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      j_state, jp)
        jp = j_apply_updates(jp, j_upd)
        upd, state = opt.update(named_from_jax(cfg, g, "cpu"), state, params)
        params = apply_updates(params, upd)
    assert int(state.step) == int(j_state.step) == 4
    for mine, theirs in ((trainable(params), jp), (state.m, j_state.m),
                         (state.v, j_state.v)):
        want = named_from_jax(cfg, _np_tree(theirs), "cpu")
        assert set(mine) == set(want)
        for n, t in mine.items():
            assert torch.equal(t, want[n]), n


def test_jitted_adamw_fuses_the_moment_update():
    """Why the bit-for-bit reference is JAX's update run op by op: jitted,
    XLA computes ``b1 * m + (1 - b1) * g`` as one FMA, ``fma(b1, m,
    f32((1 - b1) * g))``, which the port (and eager JAX) round twice."""
    rng = np.random.default_rng(3)
    p = {"w": jnp.asarray(rng.standard_normal((64, 32)).astype(np.float32))}
    gs = [{"w": jnp.asarray((rng.standard_normal((64, 32)) * 1e-3)
                            .astype(np.float32))} for _ in range(2)]
    j_opt = j_adamw(lr=1e-2, grad_clip=None)
    jit_update = jax.jit(j_opt.update)
    _, s1 = j_opt.update(gs[0], j_opt.init(p), p)
    _, eager = j_opt.update(gs[1], s1, p)
    _, jitted = jit_update(gs[1], s1, p)
    m1, g = np.asarray(s1.m["w"]), np.asarray(gs[1]["w"])
    fma = (np.float64(np.float32(0.9)) * m1.astype(np.float64)
           + (np.float32(0.1) * g).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jitted.m["w"]), fma)
    assert not np.array_equal(np.asarray(eager.m["w"]), fma)
    opt = adamw(lr=1e-2, grad_clip=None)
    pt = {"w": torch.from_numpy(np.array(p["w"]))}
    state = opt.init(pt)
    for g_ in gs:
        _, state = opt.update({"w": torch.from_numpy(np.array(g_["w"]))},
                              state, pt)
    assert torch.equal(state.m["w"], torch.from_numpy(np.array(eager.m["w"])))


def test_adamw_biting_clip_matches_jax():
    """A clip that bites scales every gradient by clip / global norm: the
    norm sums the leaves in other orders (JAX's stacked leaves, the port's
    per-layer tensors), so the scale may differ by an ULP; OP_TOL."""
    j_cfg, cfg = j_get_config("hymba-1.5b").reduced(), get_config(
        "hymba-1.5b").reduced()
    jp = jtf.init_params(j_cfg, jax.random.PRNGKey(4))
    j_opt, opt = j_adamw(lr=1e-2, grad_clip=1.0), adamw(lr=1e-2, grad_clip=1.0)
    params = from_jax_params(cfg, _np_tree(jp), "cpu")
    j_state, state = j_opt.init(jp), opt.init(params)
    for g in _grad_trees(jp, 4, 1.0, seed=5):
        j_upd, j_state = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      j_state, jp)
        jp = j_apply_updates(jp, j_upd)
        upd, state = opt.update(named_from_jax(cfg, g, "cpu"), state, params)
        params = apply_updates(params, upd)
    want = named_from_jax(cfg, _np_tree(jp), "cpu")
    for n, t in trainable(params).items():
        assert _rel(t, want[n]) < OP_TOL, n


def test_adamw_updates_moments_and_gradients_in_place():
    """The moments keep their storage (the returned state holds the same
    tensors), the caller's f32 gradients come back scaled by the clip, and
    a second update continues from the first's moments."""
    params = {"a": torch.randn(8, 4), "b": torch.randn(4)}
    opt = adamw(lr=1e-2, grad_clip=1.0)
    state = opt.init(params)
    ptrs = {n: (state.m[n].data_ptr(), state.v[n].data_ptr()) for n in params}
    grads = {n: torch.full_like(t, 10.0) for n, t in params.items()}
    raw = {n: g.clone() for n, g in grads.items()}
    gnorm = torch.sqrt(sum(g.square().sum() for g in raw.values()))
    _, state2 = opt.update(grads, state, params)
    for n in params:
        assert state2.m[n] is state.m[n] and state2.v[n] is state.v[n]
        assert (state.m[n].data_ptr(), state.v[n].data_ptr()) == ptrs[n]
        assert torch.equal(grads[n], raw[n] * (1.0 / gnorm))
        assert torch.equal(state.m[n], 0.1 * grads[n])
    m1 = {n: t.clone() for n, t in state.m.items()}
    _, state3 = opt.update({n: g.clone() for n, g in raw.items()}, state2,
                           params)
    for n in params:
        assert state3.m[n].data_ptr() == ptrs[n][0]
        assert torch.equal(state3.m[n], 0.9 * m1[n] + 0.1 * grads[n])


def test_async_save_is_a_snapshot_of_the_in_place_state(tmp_path):
    """An async save taken before a step holds the state as it was when
    ``save`` returned, though the step then updates the masters and
    moments in place.  A bf16 leaf on the CPU is pinned too: its host
    copy was once a view of the tensor (a numpy view of the same memory),
    which the step then overwrote."""
    cfg = get_config("hymba-1.5b").reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw(lr=1e-2)
    step = make_train_step(cfg, CTX, opt, loss_chunk=8)
    data = SyntheticLMDataset(cfg, batch=2, seq_len=16, seed=0, device="cpu")
    params, state, _ = step(params, opt.init(params), data.batch_at(0))
    extra = torch.randn(5, 3).bfloat16()
    tree = {"params": params, "opt": state, "extra": extra}
    before = {"p": {n: t.clone() for n, t in trainable(params).items()},
              "m": {n: t.clone() for n, t in state.m.items()},
              "extra": extra.clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)   # async: written in a thread
    params, state, _ = step(params, state, data.batch_at(1))
    extra.add_(1.0)
    mgr.wait()
    got = mgr.restore(1, tree)
    assert torch.equal(got["extra"], before["extra"])
    for n, t in trainable(got["params"]).items():
        assert torch.equal(t, before["p"][n]), n
        assert not torch.equal(t, trainable(params)[n]), n
    for n, t in got["opt"].m.items():
        assert torch.equal(t, before["m"][n]), n
    assert int(got["opt"].step) == 1


# ---------------------------------------------------------------------------
# MoE on float masters
# ---------------------------------------------------------------------------

def _moe_masters(n_experts, d=32, f=48, seed=0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return (rng.standard_normal(shape) / np.sqrt(d)).astype(np.float32)

    router = draw(d, n_experts)
    router[:, 0] += np.float32(0.3)   # expert 0 draws most tokens
    # experts' scales differ, so one gamma for the bank would be wrong
    banks = {k: draw(n_experts, *s) * np.arange(1, n_experts + 1, dtype=
                                                 np.float32)[:, None, None]
             for k, s in (("gate_w", (d, f)), ("up_w", (d, f)),
                          ("down_w", (f, d)))}
    return {"router": {"w": router}, **banks}


def test_bank_fake_quant_is_per_expert():
    """``ternarize_ste`` over dims (1, 2) is JAX's
    ``jax.vmap(ternarize_ste)``: each
    expert with its own absmean gamma (the codes bit for bit, the values
    within GAMMA_RTOL); ternarizing the bank as one tensor gives other
    values, and the gradient passes straight through."""
    w = _moe_masters(4, seed=1)["gate_w"]
    want = np.asarray(jax.jit(jax.vmap(j_tern.ternarize_ste))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = ternary.ternarize_ste(wt, dims=(1, 2))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=GAMMA_RTOL,
                               atol=0)
    for e in range(w.shape[0]):
        codes, gamma = ternary.ternarize(torch.from_numpy(w[e]))
        j_codes, j_gamma = j_tern.ternarize(jnp.asarray(w[e]))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
        assert (abs(gamma.item() - float(j_gamma))
                <= GAMMA_RTOL * float(j_gamma))
        np.testing.assert_allclose(got[e].detach().numpy(),
                                   ternary.ternarize_ste(wt[e]).detach()
                                   .numpy(), rtol=GAMMA_RTOL, atol=0)
    whole = ternary.ternarize_ste(wt).detach().numpy()
    assert np.abs(whole - want).max() > 0.1 * np.abs(want).max()
    r = torch.randn(w.shape)
    (g,) = torch.autograd.grad((got * r).sum(), wt)
    assert torch.equal(g, r)


# (top_k, n_experts, capacity_factor, n tokens, token chunk)
MOE_CASES = [
    (2, 4, 1.25, 24, 0),     # mixtral-like, drops
    (4, 8, 1.25, 24, 0),     # dbrx-like top-4 of 8, drops
    (2, 4, 4.0, 24, 0),      # drop-free: empty capacity slots
    (2, 4, 1.25, 24, 8),     # chunked dispatch, capacity a chunk
]


@pytest.mark.parametrize("top_k,n_experts,cf,n,tc", MOE_CASES)
def test_moe_masters_qat_match_jax(top_k, n_experts, cf, n, tc):
    """JAX's ``moe_apply`` on masters under ``mode="qat"`` (its
    ``_expert_matmul`` branch, jitted) against the port's: the same
    routing, the output and the gradients of x, the router and the three
    banks within MODULE_TOL."""
    m = _moe_masters(n_experts, seed=n_experts + tc)
    x = (np.random.default_rng(n + tc).standard_normal((n, 32)) + 0.5
         ).astype(np.float32)
    r = np.random.default_rng(9).standard_normal((n, 32)).astype(np.float32)
    jm = jax.tree_util.tree_map(jnp.asarray, m)
    j_ctx = JCtx(mode="qat", moe_token_chunk=tc)

    def j_fn(p, x):
        return j_layers.moe_apply(p, x, top_k=top_k, capacity_factor=cf,
                                  ctx=j_ctx)

    j_out = np.asarray(jax.jit(j_fn)(jm, jnp.asarray(x)))
    j_gp, j_gx = jax.jit(jax.grad(lambda p, x: jnp.sum(j_fn(p, x) * r),
                                  argnums=(0, 1)))(jm, jnp.asarray(x))
    moe = MoE(Linear(torch.from_numpy(m["router"]["w"])),
              {k: torch.from_numpy(m[k]) for k in ("gate_w", "up_w",
                                                   "down_w")})
    leaves = [moe.router.w, moe.gate_w, moe.up_w, moe.down_w]
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layers.moe_apply(moe, xt, top_k=top_k, capacity_factor=cf,
                           ctx=Ctx(mode="qat", moe_token_chunk=tc))
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                [xt] + leaves)
    if not tc:   # routing: the same experts, positions and keep mask
        rt = layers.moe_route(moe, xt.detach(), top_k=top_k,
                              capacity_factor=cf)
        logits = jnp.dot(jnp.asarray(x), jm["router"]["w"])
        j_idx = np.asarray(jax.lax.top_k(logits, top_k)[1])
        oh = jax.nn.one_hot(j_idx.reshape(-1), n_experts, dtype=jnp.int32)
        j_pos = np.asarray(jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, -1))
        np.testing.assert_array_equal(rt["idx"].numpy(), j_idx)
        np.testing.assert_array_equal(rt["pos"].numpy(), j_pos)
        np.testing.assert_array_equal(rt["keep"].numpy(),
                                      j_pos < rt["capacity"])
        if cf < n_experts:
            assert not rt["keep"].all(), "the case was meant to drop tokens"
    assert _rel(out.detach(), j_out) < MODULE_TOL
    wants = [j_gx, j_gp["router"]["w"], j_gp["gate_w"], j_gp["up_w"],
             j_gp["down_w"]]
    for name, got, want in zip(("x", "router", "gate", "up", "down"), grads,
                               wants):
        assert np.abs(np.asarray(want)).max() > 0, name
        assert _rel(got, want) < MODULE_TOL, name


def test_moe_dispatch_backward_is_deterministic():
    """The dispatch's backward adds each buffer row's gradient into its
    token's (an accumulating index put; atomics on the card): under
    ``torch.use_deterministic_algorithms`` it gives the same gradient bit
    for bit, twice."""
    m = _moe_masters(4, seed=7)
    moe = MoE(Linear(torch.from_numpy(m["router"]["w"])),
              {k: torch.from_numpy(m[k]) for k in ("gate_w", "up_w",
                                                   "down_w")})
    x = torch.randn(24, 32, generator=torch.Generator().manual_seed(0))

    def grad_x():
        xt = x.clone().requires_grad_(True)
        out = layers.moe_apply(moe, xt, top_k=2, capacity_factor=4.0,
                               ctx=Ctx(mode="qat"))
        return torch.autograd.grad(out.square().sum(), xt)[0]

    free = grad_x()
    torch.use_deterministic_algorithms(True)
    try:
        a, b = grad_x(), grad_x()
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(a, b) and torch.equal(a, free)


# ---------------------------------------------------------------------------
# The scans under autograd
# ---------------------------------------------------------------------------

def _port_params(tree, dense=()):
    """A JAX sub-layer of master linears ({"w"[, "b"]}) and dense tensors
    -> the port's Params."""
    return Params(**{
        k: (Linear(torch.from_numpy(np.array(v["w"])),
                   torch.from_numpy(np.array(v["b"])) if "b" in v else None)
            if isinstance(v, dict) else torch.from_numpy(np.array(v)))
        for k, v in tree.items()})


def _module_grads(j_fn, t_fn, jp, x, seed):
    """jax.grad and torch.autograd of sum(f(p, x) * r) for one module:
    (JAX output, JAX grads by port name, port output, port grads)."""
    j_out = np.asarray(jax.jit(j_fn)(jp, jnp.asarray(x)))
    r = np.random.default_rng(seed).standard_normal(j_out.shape).astype(
        np.float32)
    j_gp, j_gx = jax.jit(jax.grad(lambda p, x: jnp.sum(j_fn(p, x) * r),
                                  argnums=(0, 1)))(jp, jnp.asarray(x))
    p = _port_params(_np_tree(jp))
    named = dict(p.named_buffers())
    for t in named.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_fn(p, xt)
    gs = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                             [xt] + list(named.values()))
    j_named = {}
    for k, v in _np_tree(j_gp).items():
        if isinstance(v, dict):
            j_named.update({f"{k}.{a}": b for a, b in v.items()})
        else:
            j_named[k] = v
    return (j_out, j_gx, j_named, out.detach(), gs[0],
            dict(zip(named, gs[1:])))


def _assert_module(j_out, j_gx, j_named, out, gx, grads):
    assert _rel(out, j_out) < MODULE_TOL
    assert _rel(gx, j_gx) < MODULE_TOL
    assert set(grads) == set(j_named)
    for n, g in grads.items():
        assert torch.isfinite(g).all(), n
        assert _rel(g, j_named[n]) < MODULE_TOL, (n, _rel(g, j_named[n]))


@pytest.mark.parametrize("s,chunk", [(32, 8), (13, 8)])
def test_ssm_forward_grads_match_jax(s, chunk):
    """hymba's SSD scan under QAT: the output and the gradients of x,
    ``A_log``, ``dt_bias``, ``D``, ``conv_w``, ``conv_b`` and the four
    projections against ``jax.grad``; the ``-inf`` masking before ``exp``
    gives zero, finite gradients.  Several chunks (32 over 8) and one odd
    chunk (13)."""
    d, h, hd, n = 16, 2, 8, 16
    jp = jssm.ssm_init(jax.random.PRNGKey(0), d, h, hd, n)
    rng = np.random.default_rng(1)
    for k in ("A_log", "dt_bias", "D", "conv_b"):   # off their flat init
        jp[k] = jnp.asarray(rng.standard_normal(jp[k].shape).astype(
            np.float32) * 0.5)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    kw = dict(n_heads=h, head_dim=hd, state=n, chunk=chunk)
    res = _module_grads(
        lambda p, x: jssm.ssm_forward(p, x, J_CTX, **kw),
        lambda p, x: ssm.ssm_forward(p, x, CTX, **kw), jp, x, seed=2)
    _assert_module(*res)


@pytest.mark.parametrize("s,chunk", [(32, 8), (13, 8)])
def test_mlstm_forward_grads_match_jax(s, chunk):
    """The chunkwise mLSTM under QAT: output and gradients of x and the
    four projections against ``jax.grad``, across carried chunks."""
    d, h, hd = 16, 2, 8
    jp = jxl.mlstm_init(jax.random.PRNGKey(1), d, h, hd)
    x = np.random.default_rng(3).standard_normal((2, s, d)).astype(
        np.float32)
    kw = dict(n_heads=h, head_dim=hd, chunk=chunk)
    res = _module_grads(
        lambda p, x: jxl.mlstm_forward(p, x, J_CTX, **kw),
        lambda p, x: xlstm.mlstm_forward(p, x, CTX, **kw), jp, x, seed=4)
    _assert_module(*res)


def test_slstm_forward_grads_match_jax():
    """The sequential sLSTM under QAT: output and gradients of x, ``wx``,
    the dense recurrent ``r`` and ``out`` against ``jax.grad``."""
    d, h, hd = 16, 2, 8
    jp = jxl.slstm_init(jax.random.PRNGKey(2), d, h, hd)
    x = np.random.default_rng(5).standard_normal((2, 12, d)).astype(
        np.float32)
    kw = dict(n_heads=h, head_dim=hd)
    res = _module_grads(
        lambda p, x: jxl.slstm_forward(p, x, J_CTX, **kw),
        lambda p, x: xlstm.slstm_forward(p, x, CTX, **kw), jp, x, seed=6)
    _assert_module(*res)


def test_stabiliser_ties_split_the_gradient_as_jax():
    """The scans' stabilisers at a tie: ``torch.maximum`` (the mLSTM's and
    sLSTM's running maxima, the -1e30 floor of the mLSTM's rows, the
    denominators' floors) and ``amax`` (a row's largest log weight) split
    the gradient equally among the tied inputs, as JAX's ``maximum`` and
    ``max`` do; ``clamp_min`` would not (it gives the tie to its input)."""
    a = np.array([1.0, 2.0, 3.0, -1e30, -1e30], np.float32)
    b = np.array([1.0, 1.0, 4.0, -1e30, -5.0], np.float32)
    ja, jb = jax.grad(lambda a, b: jnp.sum(jnp.maximum(a, b)),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (a, b))
    ga, gb = torch.autograd.grad(torch.maximum(ta, tb).sum(), [ta, tb])
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))
    assert ga[0] == 0.5 and gb[0] == 0.5
    # the floor, as the mLSTM takes it
    jf = jax.grad(lambda a: jnp.sum(jnp.maximum(a, -1e30)))(jnp.asarray(a))
    (tf,) = torch.autograd.grad(
        torch.maximum(ta, torch.full_like(ta, -1e30)).sum(), [ta])
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf[3] == 0.5
    (tc,) = torch.autograd.grad(ta.clamp_min(-1e30).sum(), [ta])
    assert tc[3] == 1.0   # what the floor would be with clamp_min
    rows = np.array([[1.0, 3.0, 3.0, -np.inf], [2.0, 0.0, 2.0, 2.0]],
                    np.float32)
    jr = jax.grad(lambda r: jnp.sum(jnp.max(r, axis=1) * jnp.asarray(
        [1.0, 3.0])))(jnp.asarray(rows))
    tr = torch.from_numpy(rows).requires_grad_(True)
    (gr,) = torch.autograd.grad((tr.amax(dim=1) * torch.tensor(
        [1.0, 3.0])).sum(), [tr])
    np.testing.assert_array_equal(gr.numpy(), np.asarray(jr))
    assert gr[0, 1] == 0.5 and gr[1, 0] == 1.0


# ---------------------------------------------------------------------------
# Reduced models: conversion, forward, loss and gradients, the step
# ---------------------------------------------------------------------------

def test_from_jax_params_converts_every_kind(model):
    """The port's masters from JAX's tree: the buffers, in
    ``init_params``'s order and shapes, hold JAX's values, and an AdamW
    state of the tree carries across."""
    j_cfg, jp, cfg, params = model
    drawn = trainable(transformer.init_params(cfg,
                                              torch.Generator().manual_seed(0)))
    got = trainable(params)
    assert [(n, t.shape) for n, t in got.items()] == [
        (n, t.shape) for n, t in drawn.items()]
    want = named_from_jax(cfg, _np_tree(jp), "cpu")
    assert set(got) == set(want)
    for n, t in got.items():
        assert torch.equal(t, want[n]), n
    kinds = {"hymba": "ssm", "xlstm_pair": "slstm"}
    if cfg.block_kind in kinds:
        assert any(f".{kinds[cfg.block_kind]}." in n for n in got)
    if cfg.n_experts:
        assert isinstance(params["layers"][0]["moe"], MoE)
        assert not params["layers"][0]["moe"].packed
    j_opt = j_adamw()
    j_state = j_opt.init(jp)
    state = adamw_state_from_jax(cfg, _np_tree(j_state), "cpu")
    assert set(state.m) == set(got) == set(state.v)


def test_forward_matches_jax(model):
    """Logits against JAX's jitted forward; for MoE, every layer's routing
    (the same top-k indices in the same order and the same keep mask, or a
    router near-tie shown where they differ)."""
    j_cfg, jp, cfg, params = model
    batch = _batch(cfg, 2, 32, seed=0)
    want = np.asarray(jax.jit(lambda p, x: jtf.forward(j_cfg, p, x, J_CTX))(
        jp, jnp.asarray(batch["inputs"])))
    with torch.no_grad():
        got = transformer.forward(cfg, params, torch.from_numpy(
            batch["inputs"]), CTX).numpy()
    assert got.shape == (2, 32, cfg.vocab_size)
    if cfg.n_experts:
        _, _, _, j_routes = _jax_recorded_forward(j_cfg, jp, batch["inputs"])
        _, t_routes = _port_recorded_forward(cfg, params, batch["inputs"])
        flips = _check_routes(j_cfg, j_routes, t_routes)
        print(f"{cfg.name}: tokens routed otherwise (layer, tokens, gap): "
              f"{flips}")
        if cfg.top_k < cfg.n_experts:   # else every token fits every expert
            assert any(not k.all() for _, k, _ in t_routes), "no token dropped"
    gap = float(np.abs(got - want).max())
    if gap > MODEL_TOL * np.abs(want).max():
        why = _explain_gap(j_cfg, jp, cfg, params, batch["inputs"])
        assert gap <= CODE_GAP_TOL, f"{gap} after {why}"


def _hold_loss_and_grads(j_cfg, jp, cfg, params, batch, val, grads, j_val,
                         j_g):
    """The loss and every gradient within MODEL_TOL of JAX's; past it, the
    cause shown (``_explain_gap``) and JAX's quantized values replayed in
    the port, which must bring both within MODEL_TOL."""
    j_named = named_from_jax(cfg, _np_tree(j_g), "cpu")
    assert set(grads) == set(j_named)
    assert all(torch.isfinite(g).all() for g in grads.values())
    worst = max(grads, key=lambda n: _rel(grads[n], j_named[n]))
    gap = _rel(grads[worst], j_named[worst])
    if abs(float(val) - float(j_val)) <= MODEL_TOL and gap <= MODEL_TOL:
        return "within MODEL_TOL"
    why = _explain_gap(j_cfg, jp, cfg, params, batch["inputs"])
    p_val, p_grads = _pinned_loss_and_grads(j_cfg, jp, cfg, params, batch, 8)
    p_worst = max(p_grads, key=lambda n: _rel(p_grads[n], j_named[n]))
    p_gap = _rel(p_grads[p_worst], j_named[p_worst])
    assert abs(float(p_val) - float(j_val)) <= MODEL_TOL and (
        p_gap <= MODEL_TOL), (
        f"free: loss {float(val)} vs {float(j_val)}, {worst} {gap} after "
        f"{why}; JAX's quantized values replayed: loss {float(p_val)}, "
        f"{p_worst} {p_gap}")
    return (f"free: loss gap {abs(float(val) - float(j_val)):.3g}, {worst} "
            f"{gap:.3g} after {why}; replayed: {p_gap:.3g}")


def test_loss_and_grads_match_jax(model):
    """The chunked loss (four 8-position chunks) and every gradient against
    JAX's jitted value_and_grad."""
    j_cfg, jp, cfg, params = model
    batch = _batch(cfg, 2, 32, seed=1)

    def j_loss(p, batch):
        x = jtf.forward_features(j_cfg, p, batch["inputs"], J_CTX)
        return jtf.lm_head_loss_chunked(j_cfg, p, x, batch["labels"], J_CTX,
                                        chunk=8)

    j_val, j_g = jax.jit(jax.value_and_grad(j_loss))(jp, _j(batch))
    val, grads = loss_and_grads(cfg, CTX, params, _t(batch), 8)
    print(cfg.name, _hold_loss_and_grads(j_cfg, jp, cfg, params, batch, val,
                                         grads, j_val, j_g))
    assert not any(t.requires_grad for t in trainable(params).values())


def test_train_steps_track_jax_in_lockstep(model):
    """Four jitted JAX steps on the synthetic stream, each taken by the port
    too from JAX's masters and AdamW state of that step.  The loss and both
    moments within MODEL_TOL (a leaf's largest), else the gap explained and
    JAX's quantized values replayed (``_hold_loss_and_grads``).  After the
    first step every parameter element lies within OP_TOL of JAX's but
    where JAX's gradient is within NEAR_EPS_GRAD of zero (the first update
    is g / (|g| + eps)); after later ones within 2 lr (AdamW's step bound).
    Then the port runs the four steps free from the same masters: its first
    loss is JAX's and every loss is finite (later ones drift with the
    near-eps elements, which MoE routing amplifies)."""
    j_cfg, jp0, cfg, _ = model
    lr = 1e-3
    j_opt, opt = j_adamw(lr=lr), adamw(lr=lr)
    j_step = jax.jit(j_make_train_step(j_cfg, J_CTX, j_opt, loss_chunk=8))
    j_value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, bb: jtf.lm_head_loss_chunked(
            j_cfg, p, jtf.forward_features(j_cfg, p, bb["inputs"], J_CTX),
            bb["labels"], J_CTX, chunk=8)))
    step = make_train_step(cfg, CTX, opt, loss_chunk=8)
    j_data = JData(j_cfg, batch=2, seq_len=16, seed=0)
    data = SyntheticLMDataset(cfg, batch=2, seq_len=16, seed=0, device="cpu")
    jp, j_state = jp0, j_opt.init(jp0)
    j_losses, flipped = [], 0
    for i in range(4):
        params = from_jax_params(cfg, _np_tree(jp), "cpu")
        state = (opt.init(params) if i == 0 else
                 adamw_state_from_jax(cfg, _np_tree(j_state), "cpu"))
        b = {k: np.asarray(v) for k, v in j_data.batch_at(i).items()}
        j_p1, j_s1, j_m = j_step(jp, j_state, _j(b))
        params, state, m = step(params, state, data.batch_at(i))
        assert int(state.step) == int(j_s1.step) == i + 1
        j_m1 = named_from_jax(cfg, _np_tree(j_s1.m), "cpu")
        j_v1 = named_from_jax(cfg, _np_tree(j_s1.v), "cpu")
        if abs(float(m["loss"]) - float(j_m["loss"])) > MODEL_TOL or any(
                _rel(state.m[n], j_m1[n]) > MODEL_TOL
                or _rel(state.v[n], j_v1[n]) > MODEL_TOL for n in j_m1):
            params_in = from_jax_params(cfg, _np_tree(jp), "cpu")
            j_val, j_g = j_value_and_grad(jp, _j(b))
            val, grads = loss_and_grads(cfg, CTX, params_in, _t(b), 8)
            print(f"{cfg.name} step {i}:", _hold_loss_and_grads(
                j_cfg, jp, cfg, params_in, b, val, grads, j_val, j_g))
        else:
            j_named = named_from_jax(cfg, _np_tree(j_p1), "cpu")
            for n, t in trainable(params).items():
                d = (t - j_named[n]).abs()
                off = d > OP_TOL * j_named[n].abs().max()
                if i == 0:   # m = (1 - b1) g
                    assert (j_m1[n][off].abs() < 0.1 * NEAR_EPS_GRAD).all(), n
                assert (d <= 2 * lr).all(), (i, n)
                flipped += int(off.sum())
        jp, j_state = j_p1, j_s1
        j_losses.append(float(j_m["loss"]))
    print(f"{cfg.name}: parameter elements past OP_TOL over the 4 steps: "
          f"{flipped}")
    params = from_jax_params(cfg, _np_tree(jp0), "cpu")
    state = opt.init(params)
    free = []
    for i in range(4):
        params, state, m = step(params, state, data.batch_at(i))
        free.append(float(m["loss"]))
    print(f"{cfg.name}: JAX losses {j_losses}, the port's free run {free}")
    assert np.isfinite(free).all()
    assert abs(free[0] - j_losses[0]) <= MODEL_TOL


def test_remat_changes_no_gradient(model):
    """Each block under ``torch.utils.checkpoint`` (the MoE's dispatch, the
    SSD chunks and the sLSTM loop recomputed in the backward) gives the
    gradients of the forward kept whole, bit for bit."""
    _, _, cfg, params = model
    batch = _t(_batch(cfg, 2, 16, seed=2))
    _, g_remat = loss_and_grads(cfg, CTX, params, batch, 8)
    leaves = trainable(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        x = transformer.forward_features(cfg, params, batch["inputs"], CTX,
                                         remat=False)
        loss = transformer.lm_head_loss_chunked(cfg, params, x,
                                                batch["labels"], CTX, chunk=8)
        g_plain = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    for n, g in zip(leaves, g_plain):
        assert torch.equal(g_remat[n], g), n


# ---------------------------------------------------------------------------
# The launcher: resume == straight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_launcher_resume_equals_straight(name, tmp_path):
    """``launch.train.train`` on the reduced config, on the CPU: 2 steps,
    a checkpoint, then a resumed run to 4, against 4 straight steps; the
    losses and the final masters equal bit for bit."""
    from repro_torch.launch.train import train
    kw = dict(batch=2, seq_len=16, ckpt_every=2, reduced=True, device="cpu",
              log_every=100)
    straight, l_straight = train(name, steps=4, ckpt_dir=None, **kw)
    ckpt = str(tmp_path / "ckpt")
    _, l_first = train(name, steps=2, ckpt_dir=ckpt, **kw)
    resumed, l_rest = train(name, steps=4, ckpt_dir=ckpt, **kw)
    assert l_first + l_rest == l_straight
    assert all(np.isfinite(l_straight))
    a, b = trainable(straight), trainable(resumed)
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("name", ["mixtral-8x22b", "dbrx-132b"])
def test_moe_token_chunk_trains(name):
    """``Ctx.moe_token_chunk`` on masters, as JAX's scan over token chunks:
    the loss and gradients of the chunked dispatch against JAX's."""
    j_cfg, jp, cfg, params = _model(name)
    batch = _batch(cfg, 2, 16, seed=8)
    j_ctx = dataclasses.replace(J_CTX, moe_token_chunk=8)
    ctx = dataclasses.replace(CTX, moe_token_chunk=8)

    def j_loss(p, batch):
        x = jtf.forward_features(j_cfg, p, batch["inputs"], j_ctx)
        return jtf.lm_head_loss_chunked(j_cfg, p, x, batch["labels"], j_ctx,
                                        chunk=8)

    j_val, j_g = jax.jit(jax.value_and_grad(j_loss))(jp, _j(batch))
    val, grads = loss_and_grads(cfg, ctx, params, _t(batch), 8)
    _, whole = loss_and_grads(cfg, CTX, params, _t(batch), 8)
    j_named = named_from_jax(cfg, _np_tree(j_g), "cpu")
    assert abs(float(val) - float(j_val)) < MODEL_TOL
    for n, g in grads.items():
        assert _rel(g, j_named[n]) < MODEL_TOL, n
    # capacity counts a chunk: the router sees other drops than unchunked
    assert any(not torch.equal(grads[n], whole[n]) for n in grads)


@pytest.mark.parametrize("name", ARCHS)
def test_microbatch_step_matches_jax(name):
    """``make_train_step(microbatches=2)`` on each new kind against JAX's
    jitted step with two microbatches (an MoE layer's capacity counts a
    microbatch in both): the loss and each microbatch's gradients within
    MODEL_TOL, or the gap explained and replayed away, microbatch by
    microbatch; the port's step equals its own two ``loss_and_grads``
    averaged and put through AdamW, bit for bit."""
    j_cfg, jp, cfg, params = _model(name)
    batch = _batch(cfg, 4, 16, seed=7)
    j_opt, opt = j_adamw(lr=1e-3), adamw(lr=1e-3)
    j_step = jax.jit(j_make_train_step(j_cfg, J_CTX, j_opt, microbatches=2,
                                       loss_chunk=8))
    _, _, j_m = j_step(jp, j_opt.init(jp), _j(batch))
    p = from_jax_params(cfg, _np_tree(jp), "cpu")
    p, state, m = make_train_step(cfg, CTX, opt, microbatches=2,
                                  loss_chunk=8)(p, opt.init(p), _t(batch))
    halves = [{k: v[2 * i:2 * i + 2] for k, v in batch.items()}
              for i in range(2)]
    parts = [loss_and_grads(cfg, CTX, params, _t(h), 8) for h in halves]
    if abs(float(m["loss"]) - float(j_m["loss"])) > MODEL_TOL:
        j_vg = jax.jit(jax.value_and_grad(
            lambda pp, bb: jtf.lm_head_loss_chunked(
                j_cfg, pp, jtf.forward_features(j_cfg, pp, bb["inputs"],
                                                J_CTX),
                bb["labels"], J_CTX, chunk=8)))
        for h, (val, grads) in zip(halves, parts):
            j_val, j_g = j_vg(jp, _j(h))
            print(name, _hold_loss_and_grads(j_cfg, jp, cfg, params, h, val,
                                             grads, j_val, j_g))
    loss = (parts[0][0] + parts[1][0]) / 2
    grads = {n: (parts[0][1][n] + parts[1][1][n]) / 2 for n in parts[0][1]}
    assert torch.equal(m["loss"], loss)
    ref = from_jax_params(cfg, _np_tree(jp), "cpu")
    upd, ref_state = opt.update(grads, opt.init(ref), ref)
    ref = apply_updates(ref, upd)
    for n, t in trainable(p).items():
        assert torch.equal(t, trainable(ref)[n]), n
        assert torch.equal(state.m[n], ref_state.m[n]), n


DDP_ARCHS_BODY = '''
import copy
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.optim.adamw import trainable
from repro_torch.training import loss_and_grads, make_train_step_ddp

ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=8, attn_kv_chunk=8)
out = {}
for name in ARCHS:
    acfg = get_config(name).reduced()
    master = transformer.init_params(acfg, torch.Generator().manual_seed(6))
    batch = SyntheticLMDataset(acfg, batch=4, seq_len=16, seed=1,
                               device="cpu").batch_at(0)
    local = {k: v[RANK * 2:RANK * 2 + 2] for k, v in batch.items()}
    _, local_grads = loss_and_grads(acfg, ctx, master, local, 8)
    opt = adamw(lr=1e-3)
    p = copy.deepcopy(master)
    err = {n: torch.zeros(t.shape) for n, t in trainable(p).items()}
    step = make_train_step_ddp(acfg, ctx, opt, compress=True, loss_chunk=8,
                               return_grads=True)
    p, _, new_err, m = step(p, opt.init(p), err, batch)
    for n, g in local_grads.items():
        out[f"{name}/local/{n}"] = g.numpy()
        out[f"{name}/grad/{n}"] = m["grads"][n].numpy()
        out[f"{name}/err/{n}"] = new_err[n].numpy()
        out[f"{name}/param/{n}"] = trainable(p)[n].numpy()
np.savez(f"rank{RANK}.npz", **out)
finish("DDP_ARCHS_OK")
'''


def test_compressed_ddp_trains_every_new_kind(tmp_path):
    """A compressed data-parallel step (``make_train_step_ddp``) of each
    new kind on 2 gloo ranks: the reduced gradients and each rank's error
    bit for bit against the replay of JAX's ``compressed_psum`` formula
    over the two shards' gradients, and the ranks' parameters equal."""
    from test_torch_substrate import _replay_compressed_psum
    from torch_mesh_helpers import launch
    launch(tmp_path, f"ARCHS = {ARCHS!r}\n" + DDP_ARCHS_BODY, 2,
           "DDP_ARCHS_OK", timeout=300)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for name in ARCHS:
        names = sorted(k.split("/", 2)[2] for k in ranks[0]
                       if k.startswith(f"{name}/local/"))
        assert names
        for n in names:
            gs = [r[f"{name}/local/{n}"] for r in ranks]
            out, errs = _replay_compressed_psum(
                gs, [np.zeros_like(g) for g in gs])
            for i, r in enumerate(ranks):
                np.testing.assert_array_equal(r[f"{name}/grad/{n}"], out)
                np.testing.assert_array_equal(r[f"{name}/err/{n}"], errs[i])
            np.testing.assert_array_equal(ranks[0][f"{name}/param/{n}"],
                                          ranks[1][f"{name}/param/{n}"])
