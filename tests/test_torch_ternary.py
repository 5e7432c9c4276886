"""Port vs JAX: base-3 packing, int8 activation quantization, the packed
ternary matmul (plain tlmm vs the JAX Pallas kernel in interpret mode),
RMSNorm and both RoPE styles, and the port's package rules (no JAX import,
TF32 off, every kernel wrapper choosing by the device of its tensor).

Integer stages are compared for equality from identical inputs; RMSNorm
and RoPE within 1e-6 (f32 ``rsqrt``/``cos``/``sin`` differ by ULPs between
the frameworks)."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import ternary as jt
from repro.kernels.tlmm import ops as j_tlmm
from repro.models import layers as j_layers

import repro_torch  # noqa: F401  (pins TF32 off)
from repro_torch.core import ternary
from repro_torch.kernels import on_card
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_prefill import kernel as fp_kernel
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill import ref as fp_ref
from repro_torch.kernels.rmsnorm_quant import kernel as rq_kernel
from repro_torch.kernels.rmsnorm_quant import ops as rq_ops
from repro_torch.kernels.rmsnorm_quant import ref as rq_ref
from repro_torch.kernels.swiglu_quant import kernel as sq_kernel
from repro_torch.kernels.swiglu_quant import ops as sq_ops
from repro_torch.kernels.swiglu_quant import ref as sq_ref
from repro_torch.kernels.tlmm import kernel as tlmm_kernel
from repro_torch.kernels.tlmm import ops as t_tlmm
from repro_torch.kernels.tlmm import ref as tlmm_ref
from repro_torch.kernels.tlmm_lut import kernel as lut_kernel
from repro_torch.kernels.tlmm_lut import ops as lut_ops
from repro_torch.kernels.tlmm_lut import ref as lut_ref
from repro_torch.models import layers


@pytest.mark.parametrize("g", [3, 5])
@pytest.mark.parametrize("n,k,row_multiple", [(23, 7, 1), (1536 // 8, 5, 64),
                                              (40, 3, 4)])
def test_pack_ternary_byte_identical(g, n, k, row_multiple):
    rng = np.random.default_rng(n * 10 + g)
    wt = rng.integers(-1, 2, size=(n, k)).astype(np.int8)
    want = np.array(jt.pack_ternary(jnp.asarray(wt), g, row_multiple))
    got = ternary.pack_ternary(torch.from_numpy(wt), g, row_multiple).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    back = ternary.unpack_ternary(torch.from_numpy(got), g, n).numpy()
    np.testing.assert_array_equal(back, wt)
    np.testing.assert_array_equal(
        ternary.unpack_ternary(torch.from_numpy(got), g).numpy(),
        np.asarray(jt.unpack_ternary(jnp.asarray(want), g)))


def test_absmax_quant_identical_including_ties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 96)).astype(np.float32) * 3
    # rows whose scaled values land exactly on .5: amax 127 -> scale 1.0
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    x[1, :4] = [-254.0, 1.0, 3.0, -5.0]   # scale 2.0: x/scale = .5, 1.5, -2.5
    x[2] = 0.0                             # all-zero row: eps floor
    want_q, want_s = jt.absmax_quant(jnp.asarray(x))
    got_q, got_s = ternary.absmax_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[0, :6].tolist() == [127, 0, 2, 2, 0, -4]   # half to even
    assert got_q[1, :4].tolist() == [-127, 0, 2, -2]


def test_ternarize_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    want_t, want_g = jt.ternarize(jnp.asarray(w))
    got_t, got_g = ternary.ternarize(torch.from_numpy(w))
    np.testing.assert_allclose(got_g.item(), float(want_g), rtol=1e-6)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("m,n,k,g,row_multiple", [
    (8, 160, 128, 5, 1),
    (3, 64, 48, 4, 1),
    (1, 165, 40, 5, 64),     # n < rows * g: row-padded codes
    (5, 96, 64, 3, 8),
])
def test_plain_tlmm_equals_jax_tlmm(m, n, k, g, row_multiple):
    rng = np.random.default_rng(m + n + k)
    a = rng.integers(-127, 128, size=(m, n)).astype(np.int8)
    wt = rng.integers(-1, 2, size=(n, k)).astype(np.int8)
    codes = np.array(jt.pack_ternary(jnp.asarray(wt), g, row_multiple))
    want = np.asarray(j_tlmm.tlmm(jnp.asarray(a), jnp.asarray(codes), g=g,
                                  n=n, interpret=True))
    got = t_tlmm.tlmm(torch.from_numpy(a), torch.from_numpy(codes), g=g, n=n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ wt)


@pytest.mark.parametrize("style", ["consecutive", "interleaved"])
def test_rmsnorm_and_rope_match_jax(style):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.asarray([[0, 3, 9, 10, 41], [7, 8, 9, 10, 11]], np.int32)
    want = j_layers.apply_rope(
        jnp.asarray(x), j_layers.rope_angles(jnp.asarray(pos), 16, 10000.0),
        style)
    got = layers.apply_rope(
        torch.from_numpy(x), layers.rope_angles(torch.from_numpy(pos), 16,
                                                10000.0), style)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        layers.rmsnorm(layers.RMSNorm(torch.from_numpy(w)),
                       torch.from_numpy(x)).numpy(),
        np.asarray(j_layers.rmsnorm({"w": jnp.asarray(w)}, jnp.asarray(x))),
        atol=1e-6, rtol=1e-6)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card: shows which path a
    wrapper takes for a CUDA tensor without one."""

    @property
    def is_cuda(self):
        return True


def _wrapper_cases():
    """wrapper name -> (ops module, kernel module, kernel launch, plain
    module, plain version, CPU arguments)."""
    r = torch.randn
    q1, q4 = r(2, 4, 1, 16), r(2, 4, 4, 16)
    kv, fresh = r(2, 2, 8, 16), r(2, 2, 4, 16)
    pool, bt = r(5, 4, 2, 16), torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pool8 = torch.randint(-127, 128, (5, 4, 2, 16), dtype=torch.int8)
    scales = torch.rand(5, 4, 2)
    lens, off = torch.tensor([3, 8], dtype=torch.int32), [0, 4]
    codes = ternary.pack_ternary(torch.randint(-1, 2, (10, 3),
                                               dtype=torch.int8), 5, 1)
    codes3 = ternary.pack_ternary(torch.randint(-1, 2, (10, 3),
                                                dtype=torch.int8), 3, 1)
    a_q = torch.randint(-127, 128, (2, 10), dtype=torch.int8)
    return {
        "tlmm": (t_tlmm, tlmm_kernel, "tlmm_cuda", tlmm_ref, "tlmm_ref",
                 (a_q, codes)),
        "tlmm_lut": (lut_ops, lut_kernel, "tlmm_lut_cuda", lut_ref,
                     "tlmm_lut_ref", (a_q, codes3)),   # default g = 3
        "rmsnorm_quant": (rq_ops, rq_kernel, "rmsnorm_quant_cuda", rq_ref,
                          "rmsnorm_quant_ref", (r(2, 3, 16), r(16))),
        "swiglu_quant": (sq_ops, sq_kernel, "swiglu_quant_cuda", sq_ref,
                         "swiglu_quant_ref",
                         (a_q.int(), a_q.int(), r(2, 1), r(2, 1))),
        "flash_prefill": (fp_ops, fp_kernel, "flash_prefill_cuda", fp_ref,
                          "flash_prefill_ref", (q4, fresh, fresh)),
        "flash_chunk_prefill": (fp_ops, fp_kernel, "flash_chunk_prefill_cuda",
                                fp_ref, "flash_chunk_prefill_ref",
                                (q4, kv, kv, fresh, fresh, off)),
        "flash_chunk_prefill_paged": (
            fp_ops, fp_kernel, "flash_chunk_prefill_paged_cuda", fp_ref,
            "flash_chunk_prefill_paged_ref",
            (q4, pool, pool, bt, off, fresh, fresh)),
        "decode_attention": (da_ops, da_kernel, "decode_attention_cuda",
                             da_ref, "decode_attention_ref",
                             (q1, kv, kv, lens)),
        "decode_attention_paged": (
            da_ops, da_kernel, "decode_attention_paged_cuda", da_ref,
            "paged_decode_attention_ref", (q1, pool, pool, bt, lens)),
        "decode_attention_paged_quant": (
            da_ops, da_kernel, "decode_attention_paged_quant_cuda", da_ref,
            "paged_decode_attention_quant_ref",
            (q1, pool8, pool8, scales, scales, bt, lens)),
    }


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports itself on a device with no path."""

    @property
    def device(self):
        return torch.device("xpu")


@pytest.mark.parametrize("wrapper", sorted(_wrapper_cases()))
def test_wrapper_chooses_by_tensor_device(monkeypatch, wrapper):
    """A CPU tensor takes the plain version, a CUDA tensor the kernel's
    launch (no setting chooses), a ``meta`` tensor the plain version (the
    dry run's shapes), any other device raises."""
    ops, kmod, launch, rmod, plain, args = _wrapper_cases()[wrapper]
    fn = getattr(ops, wrapper)
    out = fn(*args)   # what the stand-ins return, for wrappers that unpack it
    calls = []
    monkeypatch.setattr(kmod, launch,
                        lambda *a, **k: calls.append("kernel") or out)
    monkeypatch.setattr(rmod, plain,
                        lambda *a, **k: calls.append("plain") or out)
    fn(*args)
    fn(args[0].as_subclass(_OnCard), *args[1:])
    fn(args[0].to("meta"), *args[1:])
    assert calls == ["plain", "kernel", "plain"]
    with pytest.raises(ValueError, match="no path for device xpu"):
        on_card(args[0].as_subclass(_Elsewhere), wrapper)


def test_port_imports_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import runpy, sys
        import repro_torch, repro_torch.convert, repro_torch.serving
        import repro_torch.kernels.build
        import repro_torch.core.fused_block
        import repro_torch.runtime.sharding, repro_torch.runtime.collectives
        import repro_torch.runtime.pipeline, repro_torch.training
        import repro_torch.checkpoint, repro_torch.testing
        for mod in ("tlmm", "tlmm_lut", "rmsnorm_quant", "swiglu_quant",
                    "flash_prefill", "decode_attention"):
            for part in ("kernel", "ops", "ref"):
                __import__(f"repro_torch.kernels.{mod}.{part}")
        runpy.run_path("chip_smoke.py", run_name="not_main")
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "jaxlib", "repro")
                     or m.startswith(("jax.", "jaxlib.", "repro.")))
        print(bad)
        assert not bad, bad
    """)
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(root))
    assert out.returncode == 0, out.stderr + out.stdout
    # and no import statement anywhere, function bodies included
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, name)
