"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the shapes the
serving path (or, for tlmm_lut, rmsnorm_quant and swiglu_quant, the LUT
oracle and the fused FFN) gives it (with times and bounds) — the paged kernels also bit
for bit against their contiguous counterparts on the same rows — and serves
bitnet-0.73b at full width and depth (random weights from a seed) through
the continuous-batching ``ServingEngine``: with its bf16 cache, then with a
paged bf16 cache whose pool is too small for every slot's worst case (the
paged tokens must equal the contiguous ones), then with int8 KV contiguous
and paged (equal to each other).  Around each engine path it counts the
kernel launches and checks that every kernel of that path launched.  It
then holds the model to its packed-weight oracle (``prefill_step`` +
``decode_step``): chunked against monolithic prefill logits, decode against
prefill logits, and every token of every request of the engine run again
with an f32 cache, of the bf16 run and of the int8 KV run, against the
oracle on the same history.  Last, it runs the paper's fused FFN
(``fused_ffn_packed``: rmsnorm_quant -> tlmm x2 -> swiglu_quant -> tlmm) on
every layer of the model, against the same dataflow on the plain versions
and against the unfused packed path, and the oracle with every ternary
linear on the table-lookup ``tlmm_lut`` (``Ctx(matmul="tlmm_lut")``), whose
logits and tokens must equal the ``tlmm`` oracle's.

Prints, before its last line, one JSON object ``{"kernels": [...]}`` and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device or any phase fails.  Never imports JAX.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12       # CUDA cores; the attention kernels run in f32

ATTN_ATOL = 1e-4   # f32 attention: kernel and plain version sum in other orders

# Model-level agreement with the oracle; fixed constants, none measured by
# the run they judge.
# Exact class: with an f32 cache, chunked and monolithic prefill run the
# same integer GEMMs and per-row f32 arithmetic in the same order; the
# 2e-3 of the JAX parity tests leaves room for a ULP in the LM head.
LOGIT_TOL_EXACT = 2e-3
# Perturbation class: a bf16 cache rounds K/V by up to 2^-9 (relative),
# which the engine's chunked admission reads back and the oracle's prompt
# prefill does not; the decode kernel sums a row's softmax in another order
# than the prompt kernel and its rows are normalised at another tensor
# shape, and a last-bit difference there can move an int8 activation of
# the next linear by one code.  On this random-weight model
# such perturbations moved logits by up to 0.073 (PERF.md, chip runs of the
# first port slice); 0.15 leaves 2x room.
LOGIT_TOL_PERTURBED = 0.15
# A token is judged on the engine's own history (teacher forcing): the
# oracle's top logit minus its logit of the engine's token.  Logits within
# tol of each other allow at most 2 * tol there.
TOKEN_GAP = 2 * LOGIT_TOL_PERTURBED
# Fused FFN on the card against the same dataflow on the plain versions: the
# kernels' sums of squares run in another order, which can move an int8 code
# by one; one code of the SwiGLU output moves an output by about 1e-3 of the
# outputs' std (a row sums some 4096 such terms), so 0.02 allows twenty.
FFN_PLAIN_TOL = 0.02


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_us(e) -> float:
    """Device time of a profiler entry that is a device kernel or copy (CPU
    op entries are skipped: their device time repeats their kernels')."""
    from torch.autograd import DeviceType
    if e.device_type != DeviceType.CUDA:
        return 0.0
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0) or 0.0)


HOLD_CYCLES = 100_000_000   # a spin of some 50 ms at the H100's clock
CYCLES_PER_S = 2e9          # above the H100's top clock: holds err long


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``, host excluded: a spin kernel holds
    the stream while the host enqueues ``iters`` warm calls, so the events
    around them time the calls back to back on the device.  The hold lasts
    three times the host's time to enqueue the same ``iters`` calls unheld;
    a host that still outlasts it fails the measurement.  The held stream
    queues about a thousand launches before the host blocks, so ``iters``
    times a call's launches must stay below that."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    hold = max(HOLD_CYCLES,
               int(3 * (time.perf_counter() - t0) * CYCLES_PER_S))
    torch.cuda.synchronize()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(hold)
    e1.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    e2.record()
    e2.synchronize()
    if enqueue_ms >= e0.elapsed_time(e1):
        raise AssertionError(f"device_ms: enqueue took {enqueue_ms:.1f} ms, "
                             f"longer than the {e0.elapsed_time(e1):.1f} ms "
                             "hold")
    return e1.elapsed_time(e2) / iters


def event_ms(fn, iters: int = 20) -> float:
    """Time per call between CUDA events around ``iters`` warm calls
    (includes the host's launch cost when the host is the slower side)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def main() -> int:
    # -- 1. card -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import bitlinear, fused_block, ternary
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.flash_prefill import ref as fp_ref
    from repro_torch.kernels.rmsnorm_quant import ops as rq_ops
    from repro_torch.kernels.rmsnorm_quant import ref as rq_ref
    from repro_torch.kernels.swiglu_quant import ops as sq_ops
    from repro_torch.kernels.swiglu_quant import ref as sq_ref
    from repro_torch.kernels.tlmm import ops as tlmm_ops
    from repro_torch.kernels.tlmm import ref as tlmm_ref
    from repro_torch.kernels.tlmm_lut import ops as lut_ops
    from repro_torch.kernels.tlmm_lut import ref as lut_ref
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import reference_decode

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(f"card: {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    # -- 3. each kernel against its plain version at main-path shapes --------
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []   # one entry per kernel for the JSON line

    def entry(name, source, replaces, calls):
        """calls: list of dicts with kernel/plain/library callables, bytes,
        ops, peak, err — one per shape.  The JSON entry's times are device
        times (``device_ms``) and bounds summed over the shapes (one call
        each); its error is the largest."""
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        errs, by = [], {}
        for c in calls:
            ms = device_ms(c["kernel"])
            # a plain version launches up to ~150 kernels per call: 3 calls
            # stay inside the held stream's launch queue (see device_ms)
            pms = device_ms(c["plain"], iters=3)
            # None: no one PyTorch call computes the kernel's function
            lms = device_ms(c["library"]) if c["library"] else None
            b_ms, b_by = bound_ms(c["bytes"], c["ops"], c["peak"])
            log(f"  {name} {c['shape']}: max_abs_err {c['err']:.3g}  "
                f"kernel_ms {event_ms(c['kernel']):.4f} (events, host "
                f"included)  device_ms {ms:.4f} (stream held, host excluded)  "
                f"plain_ms {pms:.4f}  library_ms "
                f"{'none' if lms is None else f'{lms:.4f}'}  bound_ms "
                f"{b_ms:.5f} ({b_by})")
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["library_ms"] = (None if lms is None or tot["library_ms"] is None
                                 else tot["library_ms"] + lms)
            tot["bound_ms"] += b_ms
            by[b_by] = by.get(b_by, 0.0) + b_ms
            errs.append(c["err"])
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": max(errs), **tot,
                     "bound_by": max(by, key=by.get)})

    # tlmm: every ternary linear of bitnet-0.73b, decode (m=4) and chunk (128)
    calls = []
    g = 5
    for m in (4, 128):
        for n, k in ((1536, 1536), (1536, 4096), (4096, 1536)):
            w = torch.randint(-1, 2, (n, k), generator=gen, device=dev,
                              dtype=torch.int8)
            codes = ternary.pack_ternary(w, g, bitlinear.ROW_MULTIPLE)
            a = torch.randint(-127, 128, (m, n), generator=gen, device=dev,
                              dtype=torch.int8)
            got = tlmm_ops.tlmm(a, codes, g=g)
            want = tlmm_ref.tlmm_ref(a, codes, g, n)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"tlmm m={m} n={n} k={k}: kernel != plain")
            w_f = w.float()
            a_f = a.float()
            lib = ((lambda a=a, w=w: torch._int_mm(a, w)) if m > 16
                   else (lambda a_f=a_f, w_f=w_f: a_f @ w_f))
            calls.append({
                "shape": f"m={m} n={n} k={k}", "err": 0.0,
                "kernel": lambda a=a, c=codes, n=n: tlmm_ops.tlmm(a, c, g=g, n=n),
                "plain": lambda a=a, c=codes, n=n: tlmm_ref.tlmm_ref(a, c, g, n),
                "library": lib,
                "bytes": m * n + codes.numel() + m * k * 4,
                "ops": 2.0 * m * n * k, "peak": INT8_OPS_PER_S})
    entry("tlmm", "src/repro_torch/csrc/tlmm.cu",
          "src/repro/kernels/tlmm/kernel.py:35", calls)

    # tlmm_lut: the same linears at the model's g = 5 and re-packed at the
    # paper's g = 3, each equal to its plain version and to tlmm on the same
    # codes; its library call is tlmm's, and its bound tlmm's bytes
    calls, table4 = [], []
    for g in (5, 3):
        for m in (4, 128):
            for n, k in ((1536, 1536), (1536, 4096), (4096, 1536)):
                w = torch.randint(-1, 2, (n, k), generator=gen, device=dev,
                                  dtype=torch.int8)
                codes = ternary.pack_ternary(w, g, bitlinear.ROW_MULTIPLE)
                a = torch.randint(-127, 128, (m, n), generator=gen,
                                  device=dev, dtype=torch.int8)
                got = lut_ops.tlmm_lut(a, codes, g=g)
                torch.cuda.synchronize()
                if not torch.equal(got, lut_ref.tlmm_lut_ref(a, codes, g, n)):
                    raise AssertionError(f"tlmm_lut g={g} m={m} n={n} k={k}: "
                                         "kernel != plain")
                if not torch.equal(got, tlmm_ops.tlmm(a, codes, g=g)):
                    raise AssertionError(f"tlmm_lut g={g} m={m} n={n} k={k}: "
                                         "kernel != tlmm")
                w_f, a_f = w.float(), a.float()
                lib = ((lambda a=a, w=w: torch._int_mm(a, w)) if m > 16
                       else (lambda a_f=a_f, w_f=w_f: a_f @ w_f))
                shape = f"g={g} m={m} n={n} k={k}"
                calls.append({
                    "shape": shape, "err": 0.0,
                    "kernel": lambda a=a, c=codes, g=g: lut_ops.tlmm_lut(
                        a, c, g=g),
                    "plain": lambda a=a, c=codes, g=g, n=n:
                        lut_ref.tlmm_lut_ref(a, c, g, n),
                    "library": lib,
                    "bytes": m * n + codes.numel() + m * k * 4,
                    "ops": 2.0 * m * n * k, "peak": INT8_OPS_PER_S})
                table4.append((shape, calls[-1]["kernel"],
                               lambda a=a, c=codes, g=g: tlmm_ops.tlmm(
                                   a, c, g=g)))
    entry("tlmm_lut", "src/repro_torch/csrc/tlmm_lut.cu",
          "src/repro/kernels/tlmm_lut/kernel.py:29", calls)
    # the paper's Table 4 on this card: decode-to-int8 against table lookup,
    # same codes, timed in turns (tlmm, lut, lut, tlmm) within this call
    for shape, lut_fn, tlmm_fn in table4:
        t1, l1, l2, t2 = (device_ms(f) for f in (tlmm_fn, lut_fn, lut_fn,
                                                 tlmm_fn))
        log(f"  table4 {shape}: tlmm_ms {(t1 + t2) / 2:.4f}  tlmm_lut_ms "
            f"{(l1 + l2) / 2:.4f}  lut/tlmm {(l1 + l2) / (t1 + t2):.2f}")

    # rmsnorm_quant: the norm before an FFN (and before QKV) of one decode
    # tick (m = 4) and one admission chunk (m = 128), bf16 and f32 input
    def quant_err(name, got, want):
        """Scales within rel 1e-6, codes at most one apart; returns the
        largest code difference."""
        (q, sc), (q_w, sc_w) = got, want
        rel = ((sc - sc_w).abs() / sc_w.abs()).max().item()
        diff = (q.int() - q_w.int()).abs()
        log(f"  {name}: scale max rel err {rel:.3g}, codes differing "
            f"{int((diff > 0).sum())} of {q.numel()}")
        if not (rel <= 1e-6 and diff.max().item() <= 1):
            raise AssertionError(f"{name}: kernel and plain version disagree")
        return float(diff.max())

    calls = []
    d, f = 1536, 4096
    for dt in (torch.bfloat16, torch.float32):
        for m in (4, 128):
            x = (torch.randn(m, d, generator=gen, device=dev) * 3).to(dt)
            w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
            shape = f"x ({m}, {d}) {dt}, w f32"
            err = quant_err(f"rmsnorm_quant {shape}",
                            rq_ops.rmsnorm_quant(x, w),
                            rq_ref.rmsnorm_quant_ref(x, w))
            calls.append({
                "shape": shape, "err": err,
                "kernel": lambda x=x, w=w: rq_ops.rmsnorm_quant(x, w),
                "plain": lambda x=x, w=w: rq_ref.rmsnorm_quant_ref(x, w),
                "library": None,
                "bytes": m * d * (x.element_size() + 1) + d * 4 + m * 4,
                # square, add, scale by rsqrt and w, abs-max, divide, round,
                # clamp: 8 f32 operations an element
                "ops": 8.0 * m * d, "peak": F32_FLOPS_PER_S})
    entry("rmsnorm_quant", "src/repro_torch/csrc/rmsnorm_quant.cu",
          "src/repro/kernels/rmsnorm_quant/kernel.py:20", calls)

    # swiglu_quant: on gate and up accumulators that tlmm made from the
    # quantized norm output, with the FFN's dequant scales
    calls = []
    for m in (4, 128):
        xq, xs = rq_ops.rmsnorm_quant(torch.randn(m, d, generator=gen,
                                                  device=dev),
                                      torch.ones(d, device=dev))
        acc = [tlmm_ops.tlmm(xq, ternary.pack_ternary(
            torch.randint(-1, 2, (d, f), generator=gen, device=dev,
                          dtype=torch.int8), 5, bitlinear.ROW_MULTIPLE))
            for _ in range(2)]
        gs, us = xs * 0.8, xs * 0.9       # x_scale * gamma of each linear
        args = (acc[0], acc[1], gs, us)
        shape = f"gate, up ({m}, {f}) int32 from tlmm"
        err = quant_err(f"swiglu_quant {shape}", sq_ops.swiglu_quant(*args),
                        sq_ref.swiglu_quant_ref(*args))
        calls.append({
            "shape": shape, "err": err,
            "kernel": lambda a=args: sq_ops.swiglu_quant(*a),
            "plain": lambda a=args: sq_ref.swiglu_quant_ref(*a),
            "library": None,
            "bytes": m * f * (4 + 4 + 1) + m * 4 * 3,
            # two dequant products, exp, add, divide, two products, abs-max,
            # divide, round, clamp: 12 f32 operations an element
            "ops": 12.0 * m * f, "peak": F32_FLOPS_PER_S})
    entry("swiglu_quant", "src/repro_torch/csrc/swiglu_quant.cu",
          "src/repro/kernels/swiglu_quant/kernel.py:17", calls)

    sdpa = torch.nn.functional.scaled_dot_product_attention

    # flash: the prompt of one request, (1, 24, 128, 64), q/k/v as the model's
    # transposed (b, s, h, d) projections
    b, h, s, d = 1, 24, 128, 64
    q, k_, v = (torch.randn(b, s, h, d, generator=gen, device=dev
                            ).transpose(1, 2) for _ in range(3))
    got = fp_ops.flash_prefill(q, k_, v)
    err = (got - fp_ref.flash_prefill_ref(q, k_, v)).abs().max().item()
    if not err <= ATTN_ATOL:
        raise AssertionError(f"flash: max_abs_err {err} > {ATTN_ATOL}")
    pairs = s * (s + 1) / 2
    entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
          "src/repro/kernels/flash_prefill/kernel.py:35", [{
              "shape": f"q ({b}, {h}, {s}, {d})", "err": err,
              "kernel": lambda: fp_ops.flash_prefill(q, k_, v),
              "plain": lambda: fp_ref.flash_prefill_ref(q, k_, v),
              "library": lambda: sdpa(q, k_, v, is_causal=True),
              "bytes": 4 * b * h * s * d * 4,
              "ops": b * h * pairs * 4 * d, "peak": F32_FLOPS_PER_S}])

    # chunk: one admission wave, 4 slots x 32-token chunks against the bf16
    # cache in place, each row's own span from its fresh f32 K/V
    b, t, S = 4, 32, 256
    off = torch.tensor([0, 37, 100, 224], dtype=torch.int32, device=dev)
    q = torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
    kc, vc = (torch.randn(b, S, h, d, generator=gen, device=dev
                          ).to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    kn, vn = (torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
              for _ in range(2))
    got = fp_ops.flash_chunk_prefill(q, kc, vc, kn, vn, off)
    err = (got - fp_ref.flash_chunk_prefill_ref(q, kc, vc, kn, vn, off)
           ).abs().max().item()
    if not err <= ATTN_ATOL:
        raise AssertionError(f"chunk: max_abs_err {err} > {ATTN_ATOL}")
    qpos = off[:, None].long() + torch.arange(t, device=dev)
    cmask = (torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None]
             )[:, None]
    kf, vf = fp_ref.overlay_chunk(kc, kn, off), fp_ref.overlay_chunk(vc, vn, off)
    prefix_keys = float(off.sum())
    live_pairs = float((qpos + 1).sum())
    entry("flash_chunk_prefill", "src/repro_torch/csrc/flash_prefill.cu",
          "src/repro/kernels/flash_prefill/kernel.py:93", [{
              "shape": f"q ({b}, {h}, {t}, {d}) vs bf16 ({b}, {h}, {S}, {d}) "
                       f"+ f32 chunk, offsets {off.tolist()}", "err": err,
              "kernel": lambda: fp_ops.flash_chunk_prefill(q, kc, vc, kn, vn,
                                                           off),
              "plain": lambda: fp_ref.flash_chunk_prefill_ref(q, kc, vc, kn,
                                                              vn, off),
              "library": lambda: sdpa(q, kf, vf, attn_mask=cmask),
              "bytes": (2 * b * h * t * d * 4 + prefix_keys * h * d * 2 * 2
                        + b * t * h * d * 4 * 2),
              "ops": live_pairs * h * 4 * d, "peak": F32_FLOPS_PER_S}])

    # decode: one tick of 4 slots against the bf16 cache, ragged lengths
    cl = torch.tensor([1, 77, 200, 256], dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).transpose(1, 2)
    kc, vc = (torch.randn(b, S, h, d, generator=gen, device=dev
                          ).to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    got = da_ops.decode_attention(q, kc, vc, cl)
    err = (got - da_ref.decode_attention_ref(q, kc, vc, cl)).abs().max().item()
    if not err <= ATTN_ATOL:
        raise AssertionError(f"decode: max_abs_err {err} > {ATTN_ATOL}")
    kf, vf = kc.float(), vc.float()   # the library call's f32 operands
    dmask = (torch.arange(S, device=dev)[None, :] < cl[:, None])[:, None, None]
    keys = float(cl.sum())
    entry("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
          "src/repro/kernels/decode_attention/kernel.py:39", [{
              "shape": f"q ({b}, {h}, 1, {d}) vs bf16 ({b}, {h}, {S}, {d}), "
                       f"cache_len {cl.tolist()}", "err": err,
              "kernel": lambda: da_ops.decode_attention(q, kc, vc, cl),
              "plain": lambda: da_ref.decode_attention_ref(q, kc, vc, cl),
              "library": lambda: sdpa(q, kf, vf, attn_mask=dmask),
              "bytes": 2 * b * h * d * 4 + keys * h * d * 2 * 2,
              "ops": keys * h * 4 * d, "peak": F32_FLOPS_PER_S}])

    # paged kernels at the same shapes: each slot's rows in shuffled pages
    # of a pool whose other pages and slack rows hold garbage, at page size
    # 16 (16 table columns for the 256 rows) and 5 (52 columns: divides
    # neither the 32-key tile nor the row).  Each is held to its plain
    # version and, bit for bit, to its contiguous kernel on the same rows.
    # No one PyTorch call reads through a block table: the library time is
    # SDPA on a contiguous f32 copy gathered beforehand.
    def paged_copy(rows, ps, fill):
        """(b, S, ...) rows -> a (1 + b * n, ps, ...) pool and its (b, n)
        int32 table."""
        nb, n_rows, tail = rows.shape[0], rows.shape[1], tuple(rows.shape[2:])
        n = -(-n_rows // ps)
        perm = torch.randperm(nb * n, generator=torch.Generator().manual_seed(ps))
        bt = (perm + 1).reshape(nb, n).to(torch.int32).to(dev)
        pool = fill((1 + nb * n, ps) + tail)
        padded = torch.cat([rows, fill((nb, n * ps - n_rows) + tail)], dim=1)
        pool[bt.long()] = padded.reshape((nb, n, ps) + tail)
        return pool, bt

    def noise(shape, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * 100).to(dtype)

    def int8s(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def unit_scales(shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.05

    def check(name, got, want, contiguous):
        err = (got - want).abs().max().item()
        if not err <= ATTN_ATOL:
            raise AssertionError(f"{name}: max_abs_err {err} > {ATTN_ATOL}")
        if not torch.equal(got, contiguous):
            raise AssertionError(f"{name}: differs from the contiguous kernel")
        return err

    PAGE_SIZES = (16, 5)

    # paged chunk: the admission wave above against a bf16 pool
    b, t, S = 4, 32, 256
    q = torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
    kr, vr = (torch.randn(b, S, h, d, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
              for _ in range(2))
    contiguous = fp_ops.flash_chunk_prefill(q, kr.transpose(1, 2),
                                            vr.transpose(1, 2), kn, vn, off)
    calls = []
    for ps in PAGE_SIZES:
        (kp, bt), (vp, _) = paged_copy(kr, ps, noise), paged_copy(vr, ps, noise)
        args = (q, kp, vp, bt, off, kn, vn)
        err = check(f"paged chunk, page size {ps}",
                    fp_ops.flash_chunk_prefill_paged(*args),
                    fp_ref.flash_chunk_prefill_paged_ref(*args), contiguous)
        kf = fp_ref.overlay_chunk(da_ref.gather_pages_ref(kp, bt), kn, off)
        vf = fp_ref.overlay_chunk(da_ref.gather_pages_ref(vp, bt), vn, off)
        cmask = (torch.arange(kf.shape[2], device=dev)[None, None, :]
                 <= qpos[:, :, None])[:, None]
        calls.append({
            "shape": f"q ({b}, {h}, {t}, {d}) vs bf16 pool "
                     f"{tuple(kp.shape)}, page size {ps}, table "
                     f"{tuple(bt.shape)}, + f32 chunk, offsets "
                     f"{off.tolist()}", "err": err,
            "kernel": lambda a=args: fp_ops.flash_chunk_prefill_paged(*a),
            "plain": lambda a=args: fp_ref.flash_chunk_prefill_paged_ref(*a),
            "library": lambda kf=kf, vf=vf, m=cmask: sdpa(q, kf, vf,
                                                          attn_mask=m),
            "bytes": (2 * b * h * t * d * 4 + prefix_keys * h * d * 2 * 2
                      + b * t * h * d * 4 * 2
                      + 4 * float((-(-off // ps)).sum())),
            "ops": live_pairs * h * 4 * d, "peak": F32_FLOPS_PER_S})
    entry("flash_chunk_prefill_paged", "src/repro_torch/csrc/flash_prefill.cu",
          "src/repro/kernels/flash_prefill/kernel.py:151", calls)

    # paged decode: the decode tick above against a bf16 pool
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).transpose(1, 2)
    kr, vr = (torch.randn(b, S, h, d, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
    contiguous = da_ops.decode_attention(q, kr.transpose(1, 2),
                                         vr.transpose(1, 2), cl)
    calls = []
    for ps in PAGE_SIZES:
        (kp, bt), (vp, _) = paged_copy(kr, ps, noise), paged_copy(vr, ps, noise)
        args = (q, kp, vp, bt, cl)
        err = check(f"paged decode, page size {ps}",
                    da_ops.decode_attention_paged(*args),
                    da_ref.paged_decode_attention_ref(*args), contiguous)
        kf = da_ref.gather_pages_ref(kp, bt).float()
        vf = da_ref.gather_pages_ref(vp, bt).float()
        dmask = (torch.arange(kf.shape[2], device=dev)[None, :]
                 < cl[:, None])[:, None, None]
        calls.append({
            "shape": f"q ({b}, {h}, 1, {d}) vs bf16 pool {tuple(kp.shape)}, "
                     f"page size {ps}, table {tuple(bt.shape)}, cache_len "
                     f"{cl.tolist()}", "err": err,
            "kernel": lambda a=args: da_ops.decode_attention_paged(*a),
            "plain": lambda a=args: da_ref.paged_decode_attention_ref(*a),
            "library": lambda kf=kf, vf=vf, m=dmask: sdpa(q, kf, vf,
                                                          attn_mask=m),
            "bytes": (2 * b * h * d * 4 + keys * h * d * 2 * 2
                      + 4 * float((-(-cl // ps)).sum())),
            "ops": keys * h * 4 * d, "peak": F32_FLOPS_PER_S})
    entry("decode_attention_paged", "src/repro_torch/csrc/decode_attention.cu",
          "src/repro/kernels/decode_attention/kernel.py:120", calls)

    # paged int8 decode: int8 pools with f32 per-(token, head) scales, held
    # bit for bit to the contiguous kernel reading the bf16 dequantized copy
    kr, vr = int8s((b, S, h, d)), int8s((b, S, h, d))
    ksr, vsr = unit_scales((b, S, h)), unit_scales((b, S, h))
    contiguous = da_ops.decode_attention(
        q, da_ref.dequant_bf16(kr, ksr).transpose(1, 2),
        da_ref.dequant_bf16(vr, vsr).transpose(1, 2), cl)
    calls = []
    for ps in PAGE_SIZES:
        (kp, bt), (vp, _) = paged_copy(kr, ps, int8s), paged_copy(vr, ps, int8s)
        (ksp, _), (vsp, _) = (paged_copy(x, ps, unit_scales) for x in (ksr, vsr))
        args = (q, kp, vp, ksp, vsp, bt, cl)
        err = check(f"paged int8 decode, page size {ps}",
                    da_ops.decode_attention_paged_quant(*args),
                    da_ref.paged_decode_attention_quant_ref(*args), contiguous)
        kf = da_ref.dequant_bf16(da_ref.gather_pages_ref(kp, bt),
                                 da_ref.gather_scale_pages_ref(ksp, bt)).float()
        vf = da_ref.dequant_bf16(da_ref.gather_pages_ref(vp, bt),
                                 da_ref.gather_scale_pages_ref(vsp, bt)).float()
        dmask = (torch.arange(kf.shape[2], device=dev)[None, :]
                 < cl[:, None])[:, None, None]
        calls.append({
            "shape": f"q ({b}, {h}, 1, {d}) vs int8 pool {tuple(kp.shape)} + "
                     f"f32 scales, page size {ps}, table {tuple(bt.shape)}, "
                     f"cache_len {cl.tolist()}", "err": err,
            "kernel": lambda a=args: da_ops.decode_attention_paged_quant(*a),
            "plain": lambda a=args: da_ref.paged_decode_attention_quant_ref(*a),
            "library": lambda kf=kf, vf=vf, m=dmask: sdpa(q, kf, vf,
                                                          attn_mask=m),
            "bytes": (2 * b * h * d * 4 + keys * h * (d + 4) * 2
                      + 4 * float((-(-cl // ps)).sum())),
            "ops": keys * h * 4 * d, "peak": F32_FLOPS_PER_S})
    entry("decode_attention_paged_quant",
          "src/repro_torch/csrc/decode_attention.cu",
          "src/repro/kernels/decode_attention/kernel.py:168", calls)

    # -- 4. the serving engine at full width ----------------------------------
    cfg = get_config("bitnet-0.73b")
    master = transformer.init_params(cfg, torch.Generator(device=dev
                                                          ).manual_seed(1))
    packed = transformer.pack_params(cfg, master)
    del master
    torch.cuda.empty_cache()
    max_seq = 256

    def requests():
        r = np.random.default_rng(3)
        return [Request(prompt=r.integers(0, cfg.vocab_size,
                                          size=int(r.integers(64, 129))),
                        max_new_tokens=16 + 2 * i) for i in range(8)]

    engine = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                           prefill_chunk=32, decode_block=8)
    engine.run(requests()[:2])                 # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    reqs = engine.run(requests())
    torch.cuda.synchronize()
    eng_counts = kernels.launch_counts()
    st = engine.stats
    mem_contiguous = torch.cuda.max_memory_allocated()
    log(f"engine: bitnet-0.73b L={cfg.n_layers} d={cfg.d_model} slots=4 "
        f"max_seq={max_seq} chunk=32 block=8; {len(reqs)} requests, prompts "
        f"{[len(r.prompt) for r in reqs]}, max_new "
        f"{[r.max_new_tokens for r in reqs]}")
    log(f"engine: {st['total_new_tokens']} tokens in {st['wall_s']:.3f} s = "
        f"{st['tokens_per_s']:.1f} tok/s; decode {st['decode_tok_s']:.1f} "
        f"tok/s; TTFT p50 {st['ttft_p50_s']:.4f} s p95 "
        f"{st['ttft_p95_s']:.4f} s; admissions {st['admissions']} "
        f"(mid-flight {st['mid_flight_admissions']}), waves "
        f"{st['prefill_chunks']}, blocks {st['decode_blocks']}; "
        f"max_memory_allocated {mem_contiguous / 2**30:.2f} GiB")
    log(f"engine launches: {eng_counts}")
    for r in reqs:
        if not (r.done and len(r.output) == r.max_new_tokens
                and ((r.output >= 0) & (r.output < cfg.vocab_size)).all()):
            raise AssertionError(f"engine output wrong: {r.output}")
    for name in ("flash_chunk_prefill", "decode_attention"):
        if eng_counts[name] <= 0:
            raise AssertionError(f"engine path did not launch {name}")

    # where an engine window's time goes: host-side ops vs device kernels
    from torch.profiler import ProfilerActivity, profile

    def profile_window(eng, label):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(requests()[:4])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = prof.key_averages()
        busy = sum(kernel_us(e) for e in ev) / 1e6
        log(f"profile, {label}: engine window of 4 requests {wall:.3f} s wall "
            f"(profiled), device busy {busy:.3f} s, idle share "
            f"{1 - busy / wall:.3f}")
        for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:8]:
            log(f"  host {e.key[:48]:48s} calls {e.count:7d} self "
                f"{e.self_cpu_time_total / 1e3:9.1f} ms")
        for e in sorted(ev, key=lambda e: -kernel_us(e))[:8]:
            log(f"  device {e.key[:46]:46s} calls {e.count:7d} self "
                f"{kernel_us(e) / 1e3:9.1f} ms")

    profile_window(engine, "contiguous bf16")

    # the engine again with an f32 cache (not counted: a check, not the path)
    reqs32 = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                           prefill_chunk=32, decode_block=8,
                           cache_dtype=torch.float32).run(requests())
    log(f"engine tokens, bf16 cache: {[r.output.tolist() for r in reqs]}")
    log(f"engine tokens, f32 cache:  {[r.output.tolist() for r in reqs32]}")
    log(f"distinct tokens: bf16 {len(set(np.concatenate([r.output for r in reqs])))}"
        f", f32 {len(set(np.concatenate([r.output for r in reqs32])))}")
    del engine   # the paged run's memory peak then holds one engine too
    torch.cuda.empty_cache()

    # -- 4b. the paged engine: 25 usable pages of 16 tokens, 400 rows against
    # the contiguous cache's 4 x 256 = 1024.  Each request's worst case is at
    # most 10 pages, so none is refused, and 4 slots cannot all hold theirs:
    # admission must defer.
    def kv_mib(rows):   # bf16 K and V over every layer
        return rows * cfg.n_layers * cfg.kv_dim * 2 * 2 / 2**20

    def paged_engine(**kw):
        return ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                             prefill_chunk=32, decode_block=8, paged=True,
                             page_size=16, kv_pages=26, **kw)

    def engine_line(name, s, mem=None):
        extra = "" if mem is None else (f"; max_memory_allocated "
                                        f"{mem / 2**30:.3f} GiB")
        log(f"{name}: {s['total_new_tokens']} tokens in {s['wall_s']:.3f} s "
            f"= {s['tokens_per_s']:.1f} tok/s; decode {s['decode_tok_s']:.1f} "
            f"tok/s; TTFT p50 {s['ttft_p50_s']:.4f} s p95 "
            f"{s['ttft_p95_s']:.4f} s; waves {s['prefill_chunks']}, blocks "
            f"{s['decode_blocks']}" + extra)

    pengine = paged_engine()
    pengine.run(requests()[:2])                # warm-up, as the contiguous run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    preqs = pengine.run(requests())
    torch.cuda.synchronize()
    paged_counts = kernels.launch_counts()
    mem_paged = torch.cuda.max_memory_allocated()
    pst = pengine.stats
    engine_line("engine, contiguous bf16", st, mem_contiguous)
    engine_line("engine, paged bf16     ", pst, mem_paged)
    log(f"paged: page size {pst['kv_page_size']}, pool {pst['kv_pool_pages']} "
        f"pages ({kv_mib(pst['kv_pool_pages'] * 16):.1f} MiB of KV against "
        f"{kv_mib(4 * max_seq):.1f} MiB contiguous), peak "
        f"{pst['kv_pages_peak']} pages, reserved peak "
        f"{pst['kv_reserved_pages_peak']}, live tokens peak "
        f"{pst['kv_live_tokens_peak']}, admissions deferred "
        f"{pst['admissions_deferred_pages']}, in use after drain "
        f"{pst['kv_pages_in_use']}; worst cases "
        f"{[pengine.worst_case_pages(r) for r in preqs]}")
    log(f"paged engine launches: {paged_counts}")
    if not (pst["admissions_deferred_pages"] > 0
            and 0 < pst["kv_pages_peak"] <= 25
            and pst["kv_pages_in_use"] == 0):
        raise AssertionError(f"paged engine pool accounting: {pst}")
    for r, c in zip(preqs, reqs):
        if r.output.tolist() != c.output.tolist():
            raise AssertionError(f"paged tokens {r.output.tolist()} != "
                                 f"contiguous {c.output.tolist()}")
    for name in ("flash_chunk_prefill_paged", "decode_attention_paged"):
        if paged_counts[name] <= 0:
            raise AssertionError(f"paged engine did not launch {name}")
    profile_window(pengine, "paged bf16, 25 pages")
    del pengine

    # -- 4c. int8 KV, contiguous and paged (same pool), token for token ------
    kv8_contiguous = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                                   prefill_chunk=32, decode_block=8,
                                   kv_quant=True)
    kv8_paged = paged_engine(kv_quant=True)
    for eng in (kv8_contiguous, kv8_paged):
        eng.run(requests()[:2])                # warm-up, as the bf16 runs
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    reqs8 = kv8_contiguous.run(requests())
    preqs8 = kv8_paged.run(requests())
    torch.cuda.synchronize()
    kv8_counts = kernels.launch_counts()
    engine_line("engine, contiguous int8 KV", kv8_contiguous.stats)
    engine_line("engine, paged int8 KV     ", kv8_paged.stats)
    log(f"int8 KV engine launches: {kv8_counts}")
    log(f"engine tokens, int8 KV: {[r.output.tolist() for r in reqs8]}")
    for r, c in zip(preqs8, reqs8):
        if r.output.tolist() != c.output.tolist():
            raise AssertionError(f"paged int8 tokens {r.output.tolist()} != "
                                 f"contiguous int8 {c.output.tolist()}")
    if kv8_paged.stats["admissions_deferred_pages"] <= 0:
        raise AssertionError("paged int8 engine did not defer admission")
    for name in ("decode_attention_paged_quant", "flash_chunk_prefill",
                 "decode_attention"):
        if kv8_counts[name] <= 0:
            raise AssertionError(f"int8 KV engines did not launch {name}")
    profile_window(kv8_contiguous, "contiguous int8 KV")
    del kv8_contiguous, kv8_paged

    # -- 5. the model against its packed-weight oracle ------------------------
    ctx = Ctx()
    failures = []
    # logits: each prompt chunked (the engine's admission, 32-token chunks,
    # the last shifted to end at the prompt) against the oracle's monolithic
    # prefill, and one decode step against a monolithic prefill one longer
    for dt in (torch.float32, torch.bfloat16):
        worst = {"chunk": [], "decode": []}
        for r in reqs32:
            prompt = torch.as_tensor(r.prompt, device=dev)
            plen = len(r.prompt)
            mono_cache = transformer.init_cache(cfg, 1, max_seq, dt, dev)
            mono, _ = transformer.prefill_step(cfg, packed, prompt[None], ctx,
                                               mono_cache)
            if not (torch.isfinite(mono).all()
                    and mono.shape == (1, cfg.vocab_size)):
                raise AssertionError("oracle logits not finite or of the "
                                     "wrong shape")
            cache = transformer.init_cache(cfg, 1, max_seq, dt, dev)
            for lo in range(0, plen, 32):
                lo = min(lo, plen - 32)
                chunk, _ = transformer.prefill_chunk(
                    cfg, packed, prompt[None, lo:lo + 32], ctx, cache,
                    offsets=[lo], admit_mask=[True], last_index=[31])
            tok = torch.tensor([[r.output[0]]], device=dev)
            step, _ = transformer.decode_step(cfg, packed, tok, ctx,
                                              mono_cache, plen)
            longer, _ = transformer.prefill_step(
                cfg, packed, torch.cat([prompt, tok[0]])[None], ctx,
                transformer.init_cache(cfg, 1, max_seq, dt, dev))
            worst["chunk"].append((chunk - mono).abs().max().item())
            worst["decode"].append((step - longer).abs().max().item())
        for what, diffs in worst.items():
            lim = (LOGIT_TOL_EXACT if (dt, what) == (torch.float32, "chunk")
                   else LOGIT_TOL_PERTURBED)
            log(f"logits, {dt} cache, {what} vs monolithic prefill, per "
                f"prompt: max |diff| {[round(x, 6) for x in diffs]} "
                f"(tolerance {lim})")
            if max(diffs) > lim:
                failures.append(f"{dt} {what} logits differ by {max(diffs)}")
    log(f"logit range, last prompt: [{mono.min().item():.3f}, "
        f"{mono.max().item():.3f}]")

    # tokens: every step of every request, judged by the oracle on the
    # engine's own history, for both engine runs
    kernels.reset_launch_counts()
    for dt, run in ((torch.float32, reqs32), (torch.bfloat16, reqs),
                    ("int8 KV", reqs8)):
        gaps = []
        for r in run:
            # int8 KV is judged against the bf16-cache oracle: its rounding
            # is a perturbation of the same kind as the bf16 cache's
            ref_toks, g_r = reference_decode(
                cfg, packed, ctx, r.prompt, len(r.output), max_seq,
                torch.bfloat16 if dt == "int8 KV" else dt, follow=r.output)
            gaps.append(max(g_r))
            if ref_toks != r.output.tolist():
                i = next(i for i, (a, b_) in enumerate(
                    zip(ref_toks, r.output.tolist())) if a != b_)
                log(f"  {dt} request {run.index(r)}: first flip at emit "
                    f"index {i}, oracle logit gap {g_r[i]:.5f}")
        log(f"tokens, {dt} cache: largest oracle logit gap per request "
            f"{[round(g, 5) for g in gaps]} (limit {TOKEN_GAP})")
        if max(gaps) > TOKEN_GAP:
            failures.append(f"{dt} engine token off the oracle's choice by "
                            f"{max(gaps)}")
    if failures:
        raise AssertionError("; ".join(failures))
    torch.cuda.synchronize()
    ora_counts = kernels.launch_counts()
    log(f"oracle launches: {ora_counts}")
    for name in ("tlmm", "flash_prefill", "decode_attention"):
        if ora_counts[name] <= 0:
            raise AssertionError(f"oracle path did not launch {name}")

    # -- 6. the fused FFN (paper Fig. 4a) at full width ------------------------
    # every layer's packed MLP and ln2 on a decode tick's rows (m = 4) and an
    # admission chunk's (m = 128): five kernels, int8/int32 between them
    xs_ffn = [torch.randn(m, cfg.d_model, generator=gen, device=dev)
              for m in (4, 128)]
    blocks = packed["layers"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fused = [[fused_block.fused_ffn_packed(blk["mlp"], blk["ln2"].w, x)
              for x in xs_ffn] for blk in blocks]
    torch.cuda.synchronize()
    ffn_counts = kernels.launch_counts()
    log(f"fused FFN launches: {ffn_counts}")
    calls_ffn = cfg.n_layers * len(xs_ffn)
    want = {"rmsnorm_quant": calls_ffn, "swiglu_quant": calls_ffn,
            "tlmm": 3 * calls_ffn}
    if {k: ffn_counts[k] for k in want} != want:
        raise AssertionError(f"fused FFN launches {ffn_counts}, not {want}")
    # the same dataflow on the plain versions (a CPU copy of the weights),
    # and the unfused packed path under the JAX fused-block test's tolerance
    worst_plain, worst_unfused = 0.0, 0.0
    for blk, outs in zip(blocks, fused):
        mlp_cpu = copy.deepcopy(blk["mlp"]).cpu()
        for x, y in zip(xs_ffn, outs):
            if not (torch.isfinite(y).all() and y.shape == x.shape):
                raise AssertionError("fused FFN output not finite or of the "
                                     "wrong shape")
            plain = fused_block.fused_ffn_packed(mlp_cpu, blk["ln2"].w.cpu(),
                                                 x.cpu())
            diff = (y.cpu() - plain).abs().max().item()
            worst_plain = max(worst_plain, diff / plain.std().item())
            if diff > FFN_PLAIN_TOL * plain.std().item():
                failures.append(f"fused FFN differs from its plain dataflow "
                                f"by {diff}")
            ref = fused_block.unfused_reference(blk["mlp"], blk["ln2"].w, x)
            lim = 0.05 * ref.std().item() + 1e-3 + 0.1 * ref.abs()
            worst_unfused = max(worst_unfused,
                                ((y - ref).abs() / lim).max().item())
    log(f"fused FFN, {cfg.n_layers} layers x m {[x.shape[0] for x in xs_ffn]}"
        f": max |fused - plain dataflow| {worst_plain:.3g} x std (limit "
        f"{FFN_PLAIN_TOL}); max |fused - unfused| {worst_unfused:.3g} of "
        f"the tolerance 0.05 std + 1e-3 + 0.1 |unfused|")
    if worst_unfused > 1:
        failures.append(f"fused FFN off the unfused path ({worst_unfused} of "
                        f"the tolerance)")

    # -- 7. the LUT oracle: every ternary linear on tlmm_lut ------------------
    # two requests at full depth with an f32 cache; the int32 sums are exact
    # either way, so logits and tokens equal the tlmm oracle's
    lut_reqs = reqs32[:2]
    tlmm_logits, lut_logits = [], []
    tlmm_toks = [reference_decode(cfg, packed, Ctx(), r.prompt,
                                  len(r.output), max_seq, torch.float32,
                                  logits=tlmm_logits)[0] for r in lut_reqs]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lut_toks = [reference_decode(cfg, packed, Ctx(matmul="tlmm_lut"),
                                 r.prompt, len(r.output), max_seq,
                                 torch.float32, logits=lut_logits)[0]
                for r in lut_reqs]
    torch.cuda.synchronize()
    lut_counts = kernels.launch_counts()
    log(f"LUT oracle launches: {lut_counts}")
    log(f"LUT oracle tokens: {lut_toks}; tlmm oracle: {tlmm_toks}")
    if lut_counts["tlmm_lut"] <= 0 or lut_counts["tlmm"] != 0:
        failures.append(f"LUT oracle launches {lut_counts}")
    if lut_toks != tlmm_toks or not all(
            torch.equal(a, b) for a, b in zip(lut_logits, tlmm_logits)):
        failures.append("LUT oracle logits or tokens differ from the tlmm "
                        "oracle's")
    if failures:
        raise AssertionError("; ".join(failures))

    for row in rows:   # each path's launches, counted around that path alone
        row["launches"] = sum(c[row["name"]] for c in (
            eng_counts, paged_counts, kv8_counts, ora_counts, ffn_counts,
            lut_counts))

    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
