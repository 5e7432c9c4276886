"""Split-K decode attention (flash-decoding) in the port against the JAX
package's, from the op to the serving engine.

* ops — ``decode_attention_splitk`` (the advisory ``n_splits`` divisor rule,
  the exact ``num_splits`` with tail padding, prime and non-divisible
  lengths, per-request lengths) and ``splitk_partials`` with a window,
  against JAX's on the same f32 inputs, within ``OP_TOL``;
* the shard-merge contract — the partials of each rank's run of chunks,
  concatenated in rank order and combined, equal one call over all K
  chunks bit for bit (``torch.equal``), at the JAX test's parameters;
  over real gloo ranks in ``tests/test_torch_multidevice.py``;
* the validation errors;
* ``decode_step`` with ``Ctx(kv_splits=K)`` against JAX's
  ``Ctx(kv_splits=K)`` on the same packed weights of reduced qwen1.5-0.5b,
  for the four decode reads (contiguous, contiguous int8, paged, paged
  int8), within ``LOGIT_TOL``;
* the engine with ``kv_splits=2`` emits the tokens of the engine without
  it, and in greedy lockstep the tokens of the JAX engine at
  ``kv_splits=2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.decode_attention import ops as j_ops
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving import Request, ServingEngine

OP_TOL = 2e-6
LOGIT_TOL = 2e-3

torch.set_num_threads(1)


def _qkv(b, h, kv_h, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, 1, d), (b, kv_h, s, d), (b, kv_h, s, d)))


def _both(arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


# (s, kwargs): the divisor rule picks 4 | 256 and 5 | 100 for 8; 97 is
# prime (pads); num_splits is exact whatever divides
CASES = [(256, dict(n_splits=4)), (100, dict(n_splits=8)),
         (97, dict(n_splits=4)), (101, dict(num_splits=4)),
         (256, dict(num_splits=3)), (31, dict(num_splits=8)),
         (64, dict(n_splits=1))]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("s,kw", CASES)
def test_decode_attention_splitk_matches_jax(s, kw, ragged):
    (q, k, v), (jq, jk, jv) = _both(_qkv(3, 4, 2, s, 32, seed=s))
    lens = (np.asarray([1, s // 2, s], np.int32) if ragged
            else np.asarray(s - 3, np.int32))
    got = ops.decode_attention_splitk(q, k, v, torch.from_numpy(lens), **kw)
    want = j_ops.decode_attention_splitk(jq, jk, jv, jnp.asarray(lens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL,
                               rtol=0)
    # and the attention itself: the kernel's plain version
    ref = da_ref.decode_attention_ref(
        q, k, v, torch.from_numpy(np.broadcast_to(lens, (3,)).copy()))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("window", [None, 7, 40])
def test_splitk_partials_with_window_match_jax(window):
    s, K = 96, 4
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, 6, 2, s, 16, seed=window or 0))
    lens = np.asarray([50, 96], np.int32)
    got = ops.splitk_partials(q, k, v, torch.from_numpy(lens), n_splits=K,
                              chunk=s // K, window=window)
    want = j_ops.splitk_partials(jq, jk, jv, jnp.asarray(lens), n_splits=K,
                                 chunk=s // K, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OP_TOL,
                                   rtol=0)
    out = ops.splitk_combine(*got, torch.float32)
    ref = da_ref.decode_attention_ref(q, k, v, torch.from_numpy(lens),
                                      window=window)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("s", [31, 101, 257, 256])
@pytest.mark.parametrize("shards,K", [(2, 2), (2, 4), (4, 4), (4, 8)])
def test_splitk_shard_merge_bitwise(s, shards, K):
    """Each simulated rank computes its K / shards chunks at its global
    offset; their partials, concatenated in rank order (the all-gather)
    and combined, are the bits of one call.  The JAX test's parameters."""
    (q, k, v), _ = _both(_qkv(1, 4, 2, s, 32, seed=s))
    clen = torch.tensor(s - 2, dtype=torch.int32)
    ref = ops.decode_attention_splitk(q, k, v, clen, num_splits=K)
    kp, vp, chunk = ops._pad_seq(k, v, K)
    n_local = K // shards
    parts = []
    for r in range(shards):
        lo = r * n_local * chunk
        parts.append(ops.splitk_partials(
            q, kp[:, :, lo:lo + n_local * chunk],
            vp[:, :, lo:lo + n_local * chunk], clen, n_splits=n_local,
            chunk=chunk, split0=r * n_local))
    out = ops.splitk_combine(*(torch.cat(x, dim=2) for x in zip(*parts)),
                             torch.float32)
    assert torch.equal(out, ref), (s, shards, K)


def test_splitk_validation_errors():
    with pytest.raises(ValueError, match="model"):
        ops.validate_num_splits(3, 2)
    with pytest.raises(ValueError, match="num_splits"):
        ops.validate_num_splits(0, 2)
    ops.validate_num_splits(4, 2)
    (q, k, v), _ = _both(_qkv(1, 2, 2, 64, 16, seed=0))
    clen = torch.tensor(60)
    with pytest.raises(ValueError, match="model"):
        ops.decode_attention_splitk(q, k, v, clen, num_splits=3,
                                    mesh_axis_size=2)
    (q, k, v), _ = _both(_qkv(1, 2, 2, 63, 16, seed=0))
    with pytest.raises(ValueError, match="num_splits="):
        ops.decode_attention_splitk(q, k, v, clen, n_splits=2,
                                    mesh_axis_size=2)


# ---------------------------------------------------------------------------
# Model and engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    j_cfg = j_get_config("qwen1.5-0.5b").reduced()
    cfg = get_config("qwen1.5-0.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    return j_cfg, packed, cfg, ours


S, PS = 16, 5                     # 16 rows: no whole number of 5-row pages
TABLE = np.asarray([[7, 3, 9, 5], [0, 0, 0, 0], [2, 11, 4, 8]], np.int32)


def _cache(cfg, kind, rng):
    """Random cache planes as numpy arrays: contiguous (L, 3, S, kv_h, hd)
    or paged (L, 13, PS, kv_h, hd); int8 with positive scales."""
    lead = ((cfg.n_layers, 3, S) if kind.startswith("contig")
            else (cfg.n_layers, 1 + TABLE.size, PS))
    rows = lead + (cfg.n_kv_heads,)
    if kind.endswith("int8"):
        return {"k": rng.integers(-127, 128, rows + (cfg.hd,), np.int8),
                "v": rng.integers(-127, 128, rows + (cfg.hd,), np.int8),
                "k_scale": rng.uniform(0.005, 0.02, rows).astype(np.float32),
                "v_scale": rng.uniform(0.005, 0.02, rows).astype(np.float32)}
    planes = {}
    for n in ("k", "v"):
        x = jnp.asarray(rng.standard_normal(rows + (cfg.hd,)), jnp.float32)
        planes[n] = np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32))
    return planes


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("kind", ["contig", "contig_int8", "paged",
                                  "paged_int8"])
def test_decode_step_with_kv_splits_matches_jax(served, kind, K):
    """Ragged lengths with the middle lane parked at max_seq (its row is
    not compared), on each of the four decode reads."""
    j_cfg, packed, cfg, ours = served
    rng = np.random.default_rng(11)
    planes = _cache(cfg, kind, rng)
    toks = rng.integers(0, cfg.vocab_size, (3, 1))
    lens = np.asarray([9, S, 6], np.int32)
    table = None if kind.startswith("contig") else TABLE

    def j_plane(x):
        return jnp.asarray(x).astype(jnp.bfloat16) if x.dtype == np.float32 \
            and x.ndim == 5 else jnp.asarray(x)

    def t_plane(x):
        t = torch.from_numpy(x.copy())
        return t.to(torch.bfloat16) if x.dtype == np.float32 \
            and x.ndim == 5 else t

    want, _ = jtf.decode_step(
        j_cfg, packed, jnp.asarray(toks),
        JCtx(mode="packed", group_size=j_cfg.group_size, attn_impl="pallas",
             kv_splits=K), {n: j_plane(x) for n, x in planes.items()},
        jnp.asarray(lens),
        **({} if table is None else {"page_table": jnp.asarray(table)}))
    tt = torch.from_numpy
    got, _ = transformer.decode_step(
        cfg, ours, tt(toks), Ctx(kv_splits=K),
        {n: t_plane(x) for n, x in planes.items()}, tt(lens),
        page_table=None if table is None else tt(table))
    for row in (0, 2):
        np.testing.assert_allclose(got[row].numpy(), np.asarray(want)[row],
                                   atol=LOGIT_TOL)
    # the same step on the decode kernels' plain versions
    kern, _ = transformer.decode_step(
        cfg, ours, tt(toks), Ctx(),
        {n: t_plane(x) for n, x in planes.items()}, tt(lens),
        page_table=None if table is None else tt(table))
    for row in (0, 2):
        np.testing.assert_allclose(got[row].numpy(), kern[row].numpy(),
                                   atol=LOGIT_TOL)


def _requests(cfg, cls, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(1, cfg.vocab_size,
                                    size=int(rng.integers(3, 12))
                                    ).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 9))) for _ in range(n)]


@pytest.mark.parametrize("mode", [
    dict(), dict(kv_quant=True), dict(paged=True, page_size=4),
    dict(paged=True, page_size=4, kv_quant=True),
    dict(paged=True, page_size=4, enable_prefix_sharing=True)])
def test_engine_kv_splits_equals_engine_without(served, mode):
    """Greedy and sampled, device-resident and host-driven: split-K decode
    changes no token of the port's engine (max_seq 31: a tail is padded)."""
    _, _, cfg, ours = served
    for dev in (True, False):
        outs = []
        for kv in (None, 2):
            reqs = _requests(cfg, Request)
            for i, r in enumerate(reqs):
                r.temperature = 0.8 if i % 2 else 0.0
            ServingEngine(cfg, ours, max_seq=31, batch_slots=3,
                          prefill_chunk=4, decode_block=4, device="cpu",
                          device_sched=dev, kv_splits=kv, **mode).run(reqs)
            outs.append([r.output.tolist() for r in reqs])
        assert outs[0] == outs[1], (mode, dev)


def test_engine_kv_splits_lockstep_with_jax(served):
    """The port's and the JAX engine at kv_splits=2 on the same weights,
    greedy, device-resident: the same tokens."""
    j_cfg, packed, cfg, ours = served
    kw = dict(max_seq=32, batch_slots=3, prefill_chunk=4, decode_block=4,
              kv_splits=2)
    j_reqs = _requests(cfg, JRequest)
    JServingEngine(j_cfg, packed, ctx=JCtx(
        mode="packed", group_size=j_cfg.group_size, attn_impl="pallas"),
        **kw).run(j_reqs)
    reqs = _requests(cfg, Request)
    eng = ServingEngine(cfg, ours, device="cpu", **kw)
    eng.run(reqs)
    assert eng.ctx.kv_splits == 2 and eng.ctx.kv_group is None
    assert [r.output.tolist() for r in reqs] == \
        [r.output.tolist() for r in j_reqs]
