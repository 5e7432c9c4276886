"""The launchers' pieces against the JAX package, on the CPU: the four
dry-run shapes and ``shape_applicable`` for all 11 configs, the paper's
``bits_per_weight`` and eq. 6 (``rope_weight_permutation``, and JAX's
identity on the port's ``apply_rope``), ``launch.serve`` (JAX's requests
drawn exactly, its tokens the packed oracle's) and ``launch.mesh``
(``make_host_mesh`` driving a (1, 1) engine and a sharded step, both equal
to the same run without a mesh)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from repro.configs import ARCHS as J_ARCHS
from repro.configs import PAPER_ARCH as J_PAPER
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import shape_applicable as j_applicable
from repro.core import ternary as j_ternary
from repro.models import layers as j_layers

from repro_torch.configs import (ARCHS, PAPER_ARCH, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.core import ternary
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import serve
from repro_torch.models import layers, transformer
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.runtime import sharding
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import reference_decode
from repro_torch.training import make_train_step, make_train_step_sharded


def test_shapes_and_applicability_equal_jax():
    assert ARCHS == J_ARCHS + [J_PAPER] and PAPER_ARCH == J_PAPER
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in J_SHAPES.items():
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(s)
    for arch in ARCHS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                j_applicable(j_get_config(arch), J_SHAPES[name]), (arch, name)


@pytest.mark.parametrize("g", [3, 5])
def test_bits_per_weight_equals_jax(g):
    assert ternary.bits_per_weight(g) == j_ternary.bits_per_weight(g)
    assert ternary.bits_per_weight(g, 72) == j_ternary.bits_per_weight(g, 72)


@pytest.mark.parametrize("hd", [16, 64])
def test_rope_weight_permutation_is_jax_eq6(hd):
    perm = layers.rope_weight_permutation(hd)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(j_layers.rope_weight_permutation(hd)))
    # JAX's eq. 6 identity on the port's apply_rope: consecutive RoPE on
    # the permuted channels, read back through perm, is interleaved RoPE
    s = 8
    x = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (1, s, 1, hd))))
    angles = layers.rope_angles(torch.arange(s), hd, 10000.0)
    inv = torch.argsort(perm)
    inter = layers.apply_rope(x, angles, "interleaved")
    cons = layers.apply_rope(x[..., inv], angles, "consecutive")
    torch.testing.assert_close(inter, cons[..., perm], atol=1e-5, rtol=0)
    q = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(3), (1, s, 1, hd))))
    qi = layers.apply_rope(q, angles, "interleaved")
    qc = layers.apply_rope(q[..., inv], angles, "consecutive")
    torch.testing.assert_close(
        torch.einsum("bshd,bthd->bsht", qi, inter),
        torch.einsum("bshd,bthd->bsht", qc, cons), atol=1e-4, rtol=0)


SERVE_ARGS = ["--device", "cpu", "--n-requests", "5", "--prompt-len", "12",
              "--max-new", "4", "--batch-slots", "2", "--seed", "3"]


def test_serve_draws_jax_requests_and_emits_the_oracle_tokens(monkeypatch,
                                                              capsys):
    """JAX's launcher on the same flags, its engine replaced by one that
    records the requests; the port's tokens against ``reference_decode``
    on the launcher's weights (reduced bitnet, seed 3)."""
    import repro.launch.serve as j_serve
    seen = []

    class Recorder:
        def __init__(self, *a, **kw):
            self.stats = {"mid_flight_admissions": 0}

        def run(self, reqs):
            seen.extend(reqs)
            for r in reqs:
                r.output, r.ttft_s = np.zeros(1, np.int32), 0.0

    monkeypatch.setattr(j_serve, "ServingEngine", Recorder)
    monkeypatch.setattr("sys.argv", ["serve"] + [
        a for a in SERVE_ARGS if a not in ("--device", "cpu")])
    j_serve.main()
    reqs = serve.main(SERVE_ARGS)
    lines = capsys.readouterr().out.splitlines()
    assert any(x.startswith("served 5 requests") and "tok/s" in x
               for x in lines) and any(x.startswith("TTFT: mean")
                                       for x in lines)
    assert [r.prompt.tolist() for r in reqs] == [
        np.asarray(r.prompt).tolist() for r in seen]
    assert [r.max_new_tokens for r in reqs] == [4] * 5
    cfg = get_config("bitnet-0.73b").reduced(
        n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab_size=256)
    packed = transformer.init_packed_params(
        cfg, torch.Generator().manual_seed(3))
    for r in reqs:
        want, _ = reference_decode(cfg, packed, Ctx(), r.prompt, 4, 16)
        assert r.output.tolist() == want


def test_serve_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--n-requests", "1"])


def test_host_mesh_drives_an_engine_and_a_sharded_step():
    """A (1, 1) mesh in a world of one (gloo on the CPU): the engine's
    tokens equal the engine without a mesh, and the sharded "2d" step
    equals ``make_train_step`` bit for bit."""
    assert not dist.is_initialized()
    mesh = launch_mesh.make_host_mesh("cpu")
    try:
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert (mesh.size(0), mesh.size(1)) == (1, 1)
        cfg = get_config("qwen1.5-0.5b").reduced()
        packed = transformer.init_packed_params(
            cfg, torch.Generator().manual_seed(1))
        prompts = [np.asarray(p, np.int32) for p in
                   ([1, 2, 3, 4, 5], [9, 8, 7], [4, 4, 2, 1, 1, 3])]

        def tokens(**kw):
            eng = ServingEngine(cfg, packed, max_seq=32, batch_slots=2,
                                prefill_chunk=4, decode_block=4,
                                device="cpu", **kw)
            reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
            eng.run(reqs)
            return [r.output.tolist() for r in reqs]

        assert tokens(mesh=mesh) == tokens()

        bcfg = get_config("bitnet-0.73b").reduced()
        ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=16, attn_kv_chunk=16)
        full = transformer.init_params(bcfg, torch.Generator().manual_seed(0))
        batch = SyntheticLMDataset(bcfg, batch=4, seq_len=16, seed=0,
                                   device="cpu").batch_at(0)
        opt = adamw(lr=1e-3)
        ref = transformer.init_params(bcfg, torch.Generator().manual_seed(0))
        ref_state = opt.init(ref)
        ref, _, m_ref = make_train_step(bcfg, ctx, opt, loss_chunk=16)(
            ref, ref_state, batch)
        p = sharding.shard_params(mesh, full, fsdp=False)
        state = opt.init(p)
        p, _, m = make_train_step_sharded(bcfg, ctx, opt, mesh,
                                          global_batch=4, loss_chunk=16)(
            p, state, batch)
        assert torch.equal(m["loss"], m_ref["loss"])
        for (n, a), (_, b) in zip(p.named_buffers(), ref.named_buffers()):
            assert torch.equal(a, b), n
    finally:
        dist.destroy_process_group()


def test_production_mesh_is_a_dry_mesh_without_its_ranks():
    for multi_pod, shape, names in ((False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16),
                                     ("pod", "data", "model"))):
        m = launch_mesh.make_production_mesh(multi_pod=multi_pod)
        assert type(m).__name__ == "DryMesh"
        assert tuple(m.mesh_dim_names) == names
        assert tuple(m.size(i) for i in range(len(shape))) == shape
        t = torch.zeros(3, 8)
        assert m.all_gather(t, "model", 1).shape == (3, 128)
        assert m.all_reduce(t, ("data", "model")) is t
        assert m.collective_bytes["all-gather"] == 3 * 128 * 4
        assert m.collective_bytes["all-reduce"] == 3 * 8 * 4
