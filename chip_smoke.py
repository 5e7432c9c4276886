"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the shapes the
serving path gives it (with times and bounds), serves bitnet-0.73b at full
width and depth (random weights from a seed) through the continuous-
batching ``ServingEngine`` with its bf16 cache, and checks that every
kernel of the path launched.  It then holds the model to its packed-weight
oracle (``prefill_step`` + ``decode_step``): chunked against monolithic
prefill logits, decode against prefill logits, and every token of every
request of the engine run again with an f32 cache, and of the bf16 run,
against the oracle on the same history.

Prints, before its last line, one JSON object ``{"kernels": [...]}`` and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device or any phase fails.  Never imports JAX.
"""

from __future__ import annotations

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


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``, host excluded: a spin kernel holds
    the stream while the host enqueues ``iters`` warm calls, so the events
    around them time the calls back to back on the device.  Fails if the
    host needed longer than the hold to enqueue them."""
    fn()
    torch.cuda.synchronize()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(HOLD_CYCLES)
    e1.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    e2.record()
    e2.synchronize()
    if enqueue_ms >= e0.elapsed_time(e1):
        raise AssertionError(f"device_ms: enqueue took {enqueue_ms:.1f} ms, "
                             "longer than the hold")
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
    from repro_torch.core import bitlinear, ternary
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.flash_prefill import ref as fp_ref
    from repro_torch.kernels.tlmm import ops as tlmm_ops
    from repro_torch.kernels.tlmm import ref as tlmm_ref
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
            pms = device_ms(c["plain"])
            lms = device_ms(c["library"])
            b_ms, b_by = bound_ms(c["bytes"], c["ops"], c["peak"])
            log(f"  {name} {c['shape']}: max_abs_err {c['err']:.3g}  "
                f"kernel_ms {event_ms(c['kernel']):.4f} (events, host "
                f"included)  device_ms {ms:.4f} (stream held, host excluded)  "
                f"plain_ms {pms:.4f}  "
                f"library_ms {lms:.4f}  bound_ms {b_ms:.5f} ({b_by})")
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["library_ms"] += lms
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
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(requests()[:4])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    busy = sum(kernel_us(e) for e in ev) / 1e6
    log(f"profile: engine window of 4 requests {wall:.3f} s wall (profiled), "
        f"device busy {busy:.3f} s, idle share {1 - busy / wall:.3f}")
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"  host {e.key[:48]:48s} calls {e.count:7d} self "
            f"{e.self_cpu_time_total / 1e3:9.1f} ms")
    for e in sorted(ev, key=lambda e: -kernel_us(e))[:8]:
        log(f"  device {e.key[:46]:46s} calls {e.count:7d} self "
            f"{kernel_us(e) / 1e3:9.1f} ms")

    # the engine again with an f32 cache (not counted: a check, not the path)
    reqs32 = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                           prefill_chunk=32, decode_block=8,
                           cache_dtype=torch.float32).run(requests())
    log(f"engine tokens, bf16 cache: {[r.output.tolist() for r in reqs]}")
    log(f"engine tokens, f32 cache:  {[r.output.tolist() for r in reqs32]}")
    log(f"distinct tokens: bf16 {len(set(np.concatenate([r.output for r in reqs])))}"
        f", f32 {len(set(np.concatenate([r.output for r in reqs32])))}")

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
    for dt, run in ((torch.float32, reqs32), (torch.bfloat16, reqs)):
        gaps = []
        for r in run:
            ref_toks, g_r = reference_decode(cfg, packed, ctx, r.prompt,
                                             len(r.output), max_seq, dt,
                                             follow=r.output)
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
    for row in rows:
        row["launches"] = eng_counts[row["name"]] + ora_counts[row["name"]]

    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
