"""The port's training substrate against the JAX package's, on the CPU:
the synthetic data (bit for bit), int8 error-feedback gradient compression
(the EF invariant; ``compressed_psum`` on one rank and over two gloo ranks
bit for bit against JAX's formula), data-parallel steps on gloo ranks,
checkpointing (round trip, keep-N, async, a crash mid-write, resume ==
straight run), preemption, and the training launcher with resume.

Mirrors ``tests/test_substrate.py``'s optimizer-free half (the AdamW tests
are in ``tests/test_torch_training.py``).
"""

import copy
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticLMDataset as JData
from repro.optim import compression as j_comp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import install_sigterm_handler
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import trainable
from repro_torch.training import loss_and_grads, make_train_step

from torch_mesh_helpers import launch

torch.set_num_threads(1)

CTX = Ctx(mode="qat", attn="skip", attn_q_chunk=8, attn_kv_chunk=8)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "musicgen-medium"])
@pytest.mark.parametrize("host_id", [0, 1])
def test_batches_equal_jax_bit_for_bit(arch, host_id):
    j_cfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(batch=3, seq_len=17, seed=5, host_id=host_id, n_hosts=2)
    jd, td = JData(j_cfg, **kw), SyntheticLMDataset(cfg, device="cpu", **kw)
    for step in (0, 7):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].numpy().dtype == w.dtype
            np.testing.assert_array_equal(got[k].numpy(), w)


def test_data_deterministic_host_disjoint_and_structured():
    cfg = get_config("qwen1.5-0.5b").reduced(vocab_size=64)
    d0 = SyntheticLMDataset(cfg, batch=2, seq_len=16, seed=1, host_id=0,
                            n_hosts=2, device="cpu")
    d1 = SyntheticLMDataset(cfg, batch=2, seq_len=16, seed=1, host_id=1,
                            n_hosts=2, device="cpu")
    assert torch.equal(d0.batch_at(7)["inputs"], d0.batch_at(7)["inputs"])
    assert not torch.equal(d0.batch_at(7)["inputs"], d1.batch_at(7)["inputs"])
    b = SyntheticLMDataset(cfg, batch=4, seq_len=64, seed=0, structure=1.0,
                           device="cpu").batch_at(0)
    assert torch.equal((31 * b["inputs"] + 7) % 64, b["labels"])


def test_data_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises((RuntimeError, AssertionError)):
        SyntheticLMDataset(cfg, batch=1, seq_len=4).batch_at(0)


# ---------------------------------------------------------------------------
# Gradient compression (error feedback)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 1e3)])
def test_error_feedback_invariant(seed, scale):
    """transmitted + new error == grad + carried error."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal(64) * scale).astype(np.float32))
    err = torch.from_numpy((rng.standard_normal(64) * 0.01 * scale
                            ).astype(np.float32))
    deq, new_err = compression.compress_decompress(g, err)
    np.testing.assert_allclose((deq + new_err).numpy(), (g + err).numpy(),
                               rtol=1e-5, atol=1e-6 * scale)


def test_compression_error_shrinks_with_feedback():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    err = torch.zeros_like(g_true)
    total = torch.zeros_like(g_true)
    for _ in range(50):
        deq, err = compression.compress_decompress(g_true, err)
        total = total + deq
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(),
                               atol=1e-2)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_compressed_psum_one_rank_matches_jax_shard_map(world_of_one):
    """One gloo rank against JAX's ``compressed_psum`` in a one-device
    ``shard_map`` under ``jit``, as the reference's training step runs it:
    the reduced gradient bit for bit, over 20 draws.  The new error is the
    same expression, ``gf - q * scale``; XLA evaluates it as one fused
    multiply-add (checked against the f64 value rounded once) where the
    port rounds the product first, so the two differ by at most one f32
    rounding of the product.  (Run eagerly, as ``tests/test_substrate.py``
    runs it, JAX divides ``amax / 127.0``: ROADMAP C2.)  The result equals
    ``compress_decompress``."""
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    mesh = make_mesh((1,), ("data",))
    f = jax.jit(shard_map(lambda g, e: j_comp.compressed_psum(g, e, "data"),
                          mesh=mesh, in_specs=(P(), P()),
                          out_specs=(P(), P())))
    rng = np.random.default_rng(3)
    for _ in range(20):
        g = (rng.standard_normal(1000) * rng.uniform(1e-3, 10)
             ).astype(np.float32)
        e = (rng.standard_normal(1000) * 1e-4).astype(np.float32)
        j_out, j_err = f(jnp.asarray(g), jnp.asarray(e))
        out, err = compression.compressed_psum({"g": torch.from_numpy(g)},
                                               {"g": torch.from_numpy(e)})
        np.testing.assert_array_equal(out["g"].numpy(), np.asarray(j_out))
        gf = g + e
        scale = np.float32(np.abs(gf).max() * np.float32(1.0 / 127.0))
        q = np.clip(np.round(gf / scale), -127, 127).astype(np.float64)
        np.testing.assert_array_equal(
            np.asarray(j_err),
            (gf.astype(np.float64) - q * np.float64(scale)).astype(
                np.float32))
        np.testing.assert_array_equal(
            err["g"].numpy(), gf - (q * scale).astype(np.float32))
        deq, new_err = compression.compress_decompress(torch.from_numpy(g),
                                                       torch.from_numpy(e))
        assert torch.equal(deq, out["g"]) and torch.equal(new_err, err["g"])


DDP_BODY = '''
import copy
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import trainable
from repro_torch.training import loss_and_grads, make_train_step_ddp

bcfg = get_config("bitnet-0.73b").reduced()
ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=8, attn_kv_chunk=8)
master = transformer.init_params(bcfg, torch.Generator().manual_seed(5))
batch = SyntheticLMDataset(bcfg, batch=4, seq_len=16, seed=0,
                           device="cpu").batch_at(0)
opt = adamw(lr=1e-3)
rows = 4 // WORLD
local = {k: v[RANK * rows:(RANK + 1) * rows] for k, v in batch.items()}
_, local_grads = loss_and_grads(bcfg, ctx, master, local, 8)
out = {}
for compress in (False, True):
    p = copy.deepcopy(master)
    err = {n: torch.full(t.shape, 1e-4 * (RANK + 1)) for n, t in
           trainable(p).items()}
    step = make_train_step_ddp(bcfg, ctx, opt, compress=compress,
                               loss_chunk=8, return_grads=True)
    p, st, new_err, m = step(p, opt.init(p), err, batch)
    tag = "c" if compress else "u"
    out[f"{tag}_loss"] = m["loss"].numpy()
    for n, t in trainable(p).items():
        out[f"{tag}_param/{n}"] = t.numpy()
        out[f"{tag}_grad/{n}"] = m["grads"][n].numpy()
        out[f"{tag}_err/{n}"] = new_err[n].numpy()
for n, g in local_grads.items():
    out[f"local/{n}"] = g.numpy()
np.savez(f"rank{RANK}.npz", **out)
finish("DDP_OK")
'''


@pytest.fixture(scope="module")
def ddp_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    launch(tmp, DDP_BODY, 2, "DDP_OK", timeout=300)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _replay_compressed_psum(gs, es):
    """JAX's ``compressed_psum`` over the ranks' (grad, error) pairs in one
    process, in numpy f32, with the scale of the reference's jitted step
    (``amax * f32(1/127)``, ROADMAP C2) and the error's product rounded
    before the subtraction (see the one-rank test): each rank quantizes
    grad + error with its own scale, the int32 code sums and the f32 scale
    sum are shared, and the result is ``q_sum * (scale_sum / n) / n``."""
    n = np.float32(len(gs))
    qs, scales, errs = [], [], []
    for g, e in zip(gs, es):
        gf = g + e
        amax = np.maximum(np.abs(gf).max(), np.float32(1e-12))
        scale = np.float32(amax * np.float32(1.0 / 127.0))
        q = np.clip(np.round(gf / scale), -127, 127).astype(np.int8)
        qs.append(q.astype(np.int32))
        scales.append(scale)
        errs.append(gf - q.astype(np.float32) * scale)
    q_sum = sum(qs[1:], qs[0])
    scale_sum = np.float32(sum(scales[1:], scales[0]))
    reduced = q_sum.astype(np.float32) * np.float32(scale_sum / n)
    return (reduced / n).astype(np.float32), errs


def test_compressed_ddp_matches_jax_formula_bit_for_bit(ddp_ranks):
    """Two gloo ranks, each with its shard's gradient and its own carried
    error: the reduced gradients (equal on both ranks) and each rank's new
    error bit for bit against the replay of JAX's ``compressed_psum`` over
    the two shards' gradients."""
    names = sorted(k.split("/", 1)[1] for k in ddp_ranks[0]
                   if k.startswith("local/"))
    for n in names:
        gs = [r[f"local/{n}"] for r in ddp_ranks]
        es = [np.full(gs[0].shape, np.float32(1e-4 * (i + 1)))
              for i in range(2)]
        out, errs = _replay_compressed_psum(gs, es)
        for i, r in enumerate(ddp_ranks):
            np.testing.assert_array_equal(r[f"c_grad/{n}"], out)
            np.testing.assert_array_equal(r[f"c_err/{n}"], errs[i])
    for key in ddp_ranks[0]:
        if key.startswith("c_param/"):
            np.testing.assert_array_equal(ddp_ranks[0][key],
                                          ddp_ranks[1][key])


def test_uncompressed_ddp_matches_the_whole_batch_step(ddp_ranks):
    """The mean of the two shards' gradients against one process's step on
    the whole batch: the same rows' losses and gradients summed in another
    order.  Gradients within 1e-5 of the largest, the loss within 1e-6,
    and the updated parameters within 1e-5 of their largest apart from
    AdamW's near-eps elements (``tests/test_torch_training.py``)."""
    cfg = get_config("bitnet-0.73b").reduced()
    master = transformer.init_params(cfg, torch.Generator().manual_seed(5))
    batch = SyntheticLMDataset(cfg, batch=4, seq_len=16, seed=0,
                               device="cpu").batch_at(0)
    loss, grads = loss_and_grads(cfg, CTX, master, batch, 8)
    opt = adamw(lr=1e-3)
    p, state, m = make_train_step(cfg, CTX, opt, loss_chunk=8)(
        copy.deepcopy(master), opt.init(master), batch)
    for r in ddp_ranks:
        assert abs(float(r["u_loss"]) - float(m["loss"])) < 1e-6
        for n, g in grads.items():
            got = torch.from_numpy(r[f"u_grad/{n}"])
            assert (got - g).abs().max() <= 1e-5 * g.abs().max(), n
        for n, t in trainable(p).items():
            got = torch.from_numpy(r[f"u_param/{n}"])
            off = (got - t).abs() > 1e-5 * t.abs().max()
            assert (grads[n][off].abs() < 1e-6).all(), n


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"a": torch.arange(8, dtype=torch.float32),
            "nested": {"b": torch.ones((2, 3), dtype=torch.bfloat16)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] * step,
                        "nested": {"b": tree["nested"]["b"] * step}},
                 blocking=True)
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]
    restored = mgr.restore(3, tree)
    assert torch.equal(restored["a"], torch.arange(8.0) * 3)
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"] * 3)
    raw = np.load(tmp_path / "step_0000000003" / "arrays.npz")
    assert any(raw[k].dtype == np.uint16 for k in raw.files)


def test_checkpoint_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    w = torch.ones((64, 64))
    mgr.save(5, {"w": w}, blocking=False)
    w.add_(1)   # the snapshot was taken at save()
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(None, {"w": w})["w"], torch.ones(64, 64))


def test_checkpoint_crash_mid_write_keeps_latest(tmp_path):
    """A write that died before its rename leaves a ``.tmp`` directory:
    ``latest`` still names the last complete step, which restores."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(3)}, blocking=True)
    torn = tmp_path / "step_0000000002.tmp"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"torn")
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    assert torch.equal(mgr.restore(None, {"w": torch.ones(3)})["w"],
                       torch.zeros(3))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(None, {})


def test_checkpoint_resume_training_equivalence(tmp_path):
    """2 steps, save, restore, 2 more == 4 straight steps, bit for bit."""
    cfg = get_config("bitnet-0.73b").reduced()
    opt = adamw(lr=1e-3)
    step_fn = make_train_step(cfg, CTX, opt, loss_chunk=8)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    data = SyntheticLMDataset(cfg, batch=2, seq_len=16, seed=0, device="cpu")
    p1, s1 = copy.deepcopy(params), opt.init(params)
    for i in range(4):
        p1, s1, _ = step_fn(p1, s1, data.batch_at(i))
    p2, s2 = copy.deepcopy(params), opt.init(params)
    for i in range(2):
        p2, s2, _ = step_fn(p2, s2, data.batch_at(i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"params": p2, "opt": s2}, blocking=True)
    restored = mgr.restore(2, {"params": params, "opt": opt.init(params)})
    p3, s3 = restored["params"], restored["opt"]
    assert int(s3.step) == 2
    for i in range(2, 4):
        p3, s3, _ = step_fn(p3, s3, data.batch_at(i))
    for (n, a), b in zip(trainable(p1).items(), trainable(p3).values()):
        assert torch.equal(a, b), n
    for n in s1.m:
        assert torch.equal(s1.m[n], s3.m[n]) and torch.equal(s1.v[n], s3.v[n])


def test_sigterm_preemption_flag():
    old = signal.getsignal(signal.SIGTERM)
    try:
        flag = install_sigterm_handler()
        assert not flag
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert flag
    finally:
        signal.signal(signal.SIGTERM, old)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    old = signal.getsignal(signal.SIGTERM)
    try:
        kw = dict(batch=4, seq_len=16, ckpt_dir=str(tmp_path), ckpt_every=3,
                  device="cpu", log_every=1)
        _, losses = train_launch.train("bitnet-0.73b", steps=6, **kw)
        assert len(losses) == 6 and np.isfinite(losses).all()
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.latest_step() == 6
        # a second run to 8 resumes at 6 and takes 2 steps
        _, more = train_launch.train("bitnet-0.73b", steps=8, **kw)
        assert len(more) == 2
        assert "resumed from step 6" in capsys.readouterr().out
        # and equals a straight run of 8 steps, bit for bit
        straight, _ = train_launch.train(
            "bitnet-0.73b", steps=8, **dict(kw, ckpt_dir=None))
        like = {"params": straight, "opt": adamw().init(straight)}
        resumed = mgr.restore(8, like)["params"]
        for (n, a), b in zip(trainable(straight).items(),
                             trainable(resumed).values()):
            assert torch.equal(a, b), n
    finally:
        signal.signal(signal.SIGTERM, old)


def test_end_to_end_training_learns(tmp_path):
    """QAT training on the structured stream (80 % deterministic) cuts the
    loss by a fifth in 60 steps, as ``tests/test_system.py`` asks of the
    reference's launcher; a checkpoint lands."""
    old = signal.getsignal(signal.SIGTERM)
    try:
        _, losses = train_launch.train(
            "bitnet-0.73b", steps=60, batch=8, seq_len=64,
            ckpt_dir=str(tmp_path), ckpt_every=30, lr=3e-3, log_every=1000,
            device="cpu")
    finally:
        signal.signal(signal.SIGTERM, old)
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert any(n.startswith("step_") for n in os.listdir(tmp_path))


def test_launcher_cli_on_the_cpu(capsys):
    old = signal.getsignal(signal.SIGTERM)
    try:
        train_launch.main(["--steps", "3", "--batch", "2", "--seq-len", "8",
                           "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, old)
    assert "final loss" in capsys.readouterr().out


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.train("bitnet-0.73b", steps=1, batch=1, seq_len=4,
                           ckpt_dir=None)
