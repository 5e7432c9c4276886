"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the shapes the
serving path (or, for tlmm_lut, rmsnorm_quant and swiglu_quant, the LUT
oracle and the fused FFN) gives it (with times and bounds) — the paged kernels also bit
for bit against their contiguous counterparts on the same rows — and serves
bitnet-0.73b at full width, its first 8 of 24 layers (``SERVE_LAYERS``:
the cut is the run's time), random weights from a seed, through
the continuous-batching ``ServingEngine``: with its bf16 cache, then with a
paged bf16 cache whose pool is too small for every slot's worst case (the
paged tokens must equal the contiguous ones), then with int8 KV contiguous
and paged (equal to each other).  Each of these engines serves the same
requests host-driven (``device_sched=False``) and device-resident (the
default: the decode block one captured CUDA graph, replayed), with equal
tokens; a profiled window of each mode counts ``cudaLaunchKernel`` and
``cudaGraphLaunch`` calls and fails on a kernel launch call inside a
replayed block.  A templated mix (one 64-token template, 16-64-token tails)
is then served with paged prefix sharing against plain paged: the same
tokens from fewer prefill chunks.  Phase 4e serves the device-resident
engines under injected faults (a NaN lane and a corrupt readback, a
cancellation, a queued deadline, an invalid request; a dispatch outage that
degrades the engine to host-driven blocks until a canary promotes it back to
replays of the same graph, profiled; on the templated mix with sharing a
failed page allocation and a retried NaN lane, audited after every
retirement): every surviving or retried request emits the fault-free
tokens.  Phase 4f serves the requests on device-resident engines with
split-K decode attention (``kv_splits=4``, contiguous and paged: no decode
kernel launches, tokens held to phase 4's), times plain split-K beside the
decode kernel, serves a (1, 1) ``DeviceMesh`` engine in an NCCL world of
one (its captured block holding its gather collective; phase 4's tokens),
and runs the oracle's prompt under the Fig. 6b attention baselines
(``Ctx(attn="skip")``, ``"naive"``) against the flash kernel.  Around each
engine path it counts the
kernel launches, a graph replay adding the launches it holds, and checks
that every kernel of that path launched.  It
then holds the model to its packed-weight oracle (``prefill_step`` +
``decode_step``): chunked against monolithic prefill logits, decode against
prefill logits, and every token of every request of the engine run again
with an f32 cache, of the bf16 run and of the int8 KV run, against the
oracle on the same history.  Last, it runs the paper's fused FFN
(``fused_ffn_packed``: rmsnorm_quant -> tlmm x2 -> swiglu_quant -> tlmm) on
every layer of the model, against the same dataflow on the plain versions
and against the unfused packed path, and the oracle with every ternary
linear on the table-lookup ``tlmm_lut`` (``Ctx(matmul="tlmm_lut")``), whose
logits and tokens must equal the ``tlmm`` oracle's, and the oracle at bf16
activations (``Ctx(act_dtype=torch.bfloat16)``): every kernel launches on
bf16 queries, with finite logits and tokens in the vocabulary.  Phase 9
runs the JAX package's other attention-block configs at full width, two
layers each: mixtral-8x22b (MoE, each expert bank a tlmm launch an expert)
served drop-free in both scheduling modes with profiled windows holding
the traced tlmm and decode kernels to the launch counters, its bf16
tokens judged by an oracle that prefills in the engine's chunk order on a
bf16 cache (a token past the gap passes only at a router near-tie), its
f32 tokens by the monolithic oracle, and at capacity factor 1.25 the
tokens that differ between the modes printed; granite-3-2b, command-r-35b
and qwen2-72b served device-resident and judged by the oracle; and the
embed-frontend musicgen-medium and internvl2-76b, a decode step against a
prefill one longer.  Phase 10 runs the recurrent kinds: tlmm on every
linear shape of hymba-1.5b and xlstm-350m at 1, 4 and 128 rows bit for bit,
flash_prefill and the decode kernel at hymba's 1024-token window past it
(the decode kernel on a bf16 cache with its probabilities rounded, as the
engine reads it, and on an f32 one), then each model at full width, 4
layers, served through ``serve_modes`` (whole-prompt admission, a 2-token
prompt among the requests) and judged by the oracle on bf16 and f32
caches, hymba's 2-token prefill decoded on against the 3-token prefill,
and the kernel launches of one admission printed.  Phase 11 trains
bitnet-0.73b with QAT on the card (``make_train_step``: STE linears, the
flash backward, the chunked loss, AdamW): 8 steps at full width, the first
12 of 24 layers (``TRAIN11_LAYERS``: the cut is the run's time), whose
loss, and that of a batch they never see, must fall; the trained masters
packed and served by the engine, judged by the packed oracle, whose
prefill logits are held to the QAT forward's; at 2 layers, one step on the
card against the CPU (the CPU also replaying the card's quantized values,
and a TF32 control that must fail that gradient gate), a checkpointed and
resumed run against a straight one bit for bit, and a compressed
data-parallel step on phase 4f's NCCL world of one (which the script ends
on its way out).  Phase 12 trains the other kinds with QAT at full width:
mixtral-8x22b at 1 layer, hymba-1.5b and xlstm-350m at 4, each a held
batch's loss falling, no port kernel launched, hymba also past its
1024-token window; at 2 layers hymba's and xLSTM's gradients on the card
against the CPU replaying the card's quantized values (xLSTM's with the
sLSTM's first-position kinks taken out of the backward), a TF32 control
past that limit; then each trained model packed and served on the
device-resident engine, judged by the oracle, with B1 inside mixtral's
captured block; xLSTM's gradients are also held every element, with the
CPU taking the card's pre-activations at the sLSTM kinks (C7's gate).
Phase 13 trains bitnet-0.73b at full width under a training mesh
(``make_train_step_sharded``): on a (1, 1) mesh in the NCCL world of one,
``2d``, ``2d`` with FSDP and ``dpzero1`` equal to ``make_train_step`` bit
for bit; on two gloo ranks on the one card, (1, 2) tensor-parallel, (2, 1)
FSDP and (2, 1) ZeRO-1 steps against the single-device step (its quantized
values replayed on each rank's blocks), the (1, 2) state saved and
restored onto (2, 1) and one device (the elastic restart) bit for bit,
and all 24 blocks in a 2-stage GPipe against the sequential stack.  Phase
14 runs MoE, hymba and xLSTM on meshes of gloo ranks on the one card:
mixtral-8x22b (2 layers) served device-resident on a (2, 1) mesh engine
against the single-device engine (drop-free equal tokens but at router
near-ties; at capacity factor 1.25 each rank counts its shard's rows, the
differences printed); one QAT step of mixtral-8x22b (1 layer, experts
split over "model", at 1.25 with a pair dropped) and xlstm-350m (4 layers)
on (1, 2) and hymba-1.5b (4 layers) on (1, 5) and on (1, 2) (25 heads on
2 ranks: the mixer runs whole on each), each against the single-device
step with its quantized values and routing replayed.  Phase 15 runs the
launchers: ``repro_torch.launch.serve`` serves bitnet-0.73b at full width
and depth (8 requests, 16 tokens each, two judged by the packed oracle),
and ``repro_torch.launch.dryrun`` estimates one training cell on ``meta``
tensors, then runs it on the card: its argument bytes, its peak within
20 % of the allocator's and its FLOPs equal to ``FlopCounterMode``'s on
the card's step.  Phase 16 runs JAX's partitioned packed serving program
(packed weights, the batch and the cache's sequence split over a
("data", "model") mesh) on two gloo ranks on the one card: bitnet-0.73b
at full width, 4 layers, a prefill and 16 greedy decode steps on (1, 2)
and (2, 1) against one device reading its cache as the ranks do, and the
dry run's estimate of the (1, 2) prefill held to each rank's argument
bytes and peak; then the same program at full width for mixtral-8x22b
(2 layers, (1, 2) and (2, 1)), xlstm-350m (4 layers, (1, 2)) and
hymba-1.5b (4 layers, (1, 5), five ranks), each run free (held to the same
gates up to its first int8 code or route that differs from one device's)
and replaying one device's int8 values and routing (every code the rank
computes held to the recorded one: moved only one step at a rounding tie;
the run held to the same gates).  Phase 14 also replays one device's int8
values and routing on its drop-free (2, 1) mesh engine's lanes, its
tokens held to one device's.  All phases must end within 1000 s.  Phase 6 also runs the fused FFN at qwen2-72b's width,
and phase 3 holds rmsnorm_quant and swiglu_quant on rows past their
one-block layouts (the looping kernels) to their plain versions.  Phase 3
also holds each attention wrapper's bf16 query to its f32 launch, times
the decode kernel at the oracle's one-slot shape and an empty kernel (the
launch floor), checks that a CUDA tensor divided by a Python scalar is its
product by the scalar's f32 reciprocal, and holds swiglu_quant bit for bit
to its plain version and rmsnorm_quant to its plain version summing in the
kernel's order; the build's ``ptxas`` lines are searched for spills in the
attention and quant kernels.

Prints, before its last line, one JSON object ``{"kernels": [...]}`` and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device or any phase fails.  Never imports JAX.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import re
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
# An MoE token judged past TOKEN_GAP passes only where a router's
# top_k-th and (top_k + 1)-th logits lie closer than this at the first
# diverging position: a ULP there flips an expert, which no tolerance on
# logits describes.
ROUTER_NEAR_TIE = 1e-3


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the serving engine's profiler span around a replayed decode block
REPLAY = "ServingEngine.replay_block"


def kernel_us(e) -> float:
    """Device time of a profiler entry that is a device kernel or copy (CPU
    op entries are skipped: their device time repeats their kernels', and so
    are user spans on the device timeline, such as REPLAY's)."""
    from torch.autograd import DeviceType
    if (e.device_type != DeviceType.CUDA or e.key == REPLAY
            or getattr(e, "is_user_annotation", False)):
        return 0.0
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0) or 0.0)


def loaded_library(part: str) -> ctypes.CDLL:
    """The copy of a shared library this process has loaded."""
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if part in os.path.basename(path):
                return ctypes.CDLL(path)
    raise RuntimeError(f"{part} is not loaded")


def cupti_dropped() -> int:
    """Activity records the profiler's CUPTI dropped for the current
    context since the last call (CUPTI is loaded once a profile ran)."""
    ctx, n = ctypes.c_void_p(), ctypes.c_size_t(0)
    if (loaded_library("libcuda.so").cuCtxGetCurrent(ctypes.byref(ctx))
            or loaded_library("libcupti").cuptiActivityGetNumDroppedRecords(
                ctx, 0, ctypes.byref(n))):
        raise RuntimeError("could not read CUPTI's dropped records")
    return n.value


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


def ptxas_summary(build_log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v output: its name
    (template arguments of the tlmm kernels spelled out), registers, shared
    memory and spills."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"\d+(tlmm\w*_kernel)I((?:Li\d+E)+)E", name)
            f = re.search(r"flash_attn_kernelILi(\d+)EN5repro\d+"
                          r"(ContigKV|PagedKV)I(f|13__nv_bfloat16)E", name)
            da = re.search(r"decode_attn_kernelILi(\d+)ELb([01])ELb([01])E"
                           r"N5repro\d+(ContigKV|PagedKV)I(f|13__nv_bfloat16|a)"
                           r"EE(\w)", name)
            rq = re.search(r"rmsnorm_quant_kernelI(f|13__nv_bfloat16)"
                           r"(f|13__nv_bfloat16|S\d*_)Lb([01])ELb([01])E",
                           name)
            sq = re.search(r"swiglu_quant_kernelILb([01])ELi([012])E", name)
            if t:
                name = f"{t.group(1)}<{', '.join(re.findall(r'Li(\d+)E', t.group(2)))}>"
            elif f:
                kv = "float" if f.group(3) == "f" else "bf16"
                name = f"flash_attn_kernel<{f.group(1)}, {f.group(2)}<{kv}>>"
            elif da:
                kv = {"f": "float", "a": "int8"}.get(da.group(5), "bf16")
                qt = "float" if da.group(6) == "f" else "bf16"
                name = (f"decode_attn_kernel<{da.group(1)}, WIN={da.group(2)}, "
                        f"RP={da.group(3)}, {da.group(4)}<{kv}>, q {qt}>")
            elif rq:
                tx, tw = ("f32" if g == "f" else "bf16" for g in rq.group(1, 2))
                name = (f"rmsnorm_quant_kernel<x {tx}, w {tw}, "
                        f"VEC={rq.group(3)}, LOOP={rq.group(4)}>")
            elif sq:
                path = ("REGS", "STAGED", "LOOPED")[int(sq.group(2))]
                name = f"swiglu_quant_kernel<VEC={sq.group(1)}, {path}>"
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "registers" in line and name is not None:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
            name, spill = None, ""
    return out


# -- engine windows, shared by every serving phase -----------------------------

DECODE_COUNTERS = ("decode_attention", "decode_attention_paged",
                   "decode_attention_paged_quant")
# what a profiled window holds its trace to: a label -> (which traced
# kernel names count, which launch counters count them)
DECODE_CHECK = {"decode attention": (lambda k: "decode_attn_kernel" in k,
                                     DECODE_COUNTERS)}
TLMM_CHECK = {"tlmm": (lambda k: ("tlmm_dp4a_kernel" in k
                                  or "tlmm_mma_kernel" in k), ("tlmm",))}


def is_launch(name):
    return name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))


def launch_total(names) -> int:
    from repro_torch import kernels
    c = kernels.launch_counts()
    return sum(c[k] for k in names)


def engine_line(name, s, mem=None):
    extra = "" if mem is None else (f"; max_memory_allocated "
                                    f"{mem / 2**30:.3f} GiB")
    log(f"{name}: {s['total_new_tokens']} tokens in {s['wall_s']:.3f} s "
        f"= {s['tokens_per_s']:.1f} tok/s; decode {s['decode_tok_s']:.1f} "
        f"tok/s; TTFT p50 {s['ttft_p50_s']:.4f} s p95 "
        f"{s['ttft_p95_s']:.4f} s; waves {s['prefill_chunks']}, blocks "
        f"{s['decode_blocks']} (steady {s['steady_state_blocks']}, "
        f"{s['steady_state_syncs_per_block']:.1f} gating syncs a steady "
        f"block)" + extra)


def profile_window(eng, label, reqs, checks):
    """Serve ``reqs`` on a warmed engine under the profiler: where the
    window's time goes (host ops, device kernels, idle share), the
    ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls, and a failure on a
    kernel launch call inside a replayed decode block.  For each entry of
    ``checks`` (label -> (which traced kernel names, which launch
    counters)) the kernels the profiler traced on the device, replays
    included, must equal the launch counters' count, and be more than
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = kernels.launch_counts()
    dropped = cupti_dropped()
    ev = prof.key_averages()
    traced = {what: sum(e.count for e in ev if e.device_type == DeviceType.CUDA
                        and match(e.key))
              for what, (match, _) in checks.items()}
    counted = {what: sum(after[k] - before[k] for k in names)
               for what, (_, names) in checks.items()}
    busy = sum(kernel_us(e) for e in ev) / 1e6
    calls = {name: sum(e.count for e in ev if e.key == name)
             for name in ("cudaLaunchKernel", "cudaGraphLaunch")}
    replays = inside = 0
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == REPLAY:
            replays += 1
        elif is_launch(e.name):
            p = e.cpu_parent
            while p is not None and p.name != REPLAY:
                p = p.cpu_parent
            inside += p is not None
    log(f"profile, {label}: engine window of {len(reqs)} requests {wall:.3f} "
        f"s wall (profiled), device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}; cudaLaunchKernel {calls['cudaLaunchKernel']}"
        f", cudaGraphLaunch {calls['cudaGraphLaunch']}, replayed blocks "
        f"{replays}, launch calls inside them {inside}; "
        + "; ".join(f"{what} kernels traced {traced[what]}, counted "
                    f"{counted[what]}" for what in checks)
        + f"; CUPTI dropped records {dropped}")
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"  host {e.key[:48]:48s} calls {e.count:7d} self "
            f"{e.self_cpu_time_total / 1e3:9.1f} ms")
    for e in sorted(ev, key=lambda e: -kernel_us(e))[:8]:
        log(f"  device {e.key[:46]:46s} calls {e.count:7d} self "
            f"{kernel_us(e) / 1e3:9.1f} ms")
    if inside:
        raise AssertionError(f"{label}: {inside} kernel launch calls "
                             "inside replayed decode blocks")
    for what in checks:
        if traced[what] != counted[what] or counted[what] <= 0:
            raise AssertionError(f"{label}: the profiler traced "
                                 f"{traced[what]} {what} kernels, the launch "
                                 f"counters say {counted[what]} (CUPTI "
                                 f"dropped {dropped} records)")
    if eng.device_sched and not (
            replays > 0 and calls["cudaGraphLaunch"] >= replays):
        raise AssertionError(f"{label}: no decode block replayed as a "
                             f"graph ({replays} spans, "
                             f"{calls['cudaGraphLaunch']} graph launches)")
    return {"wall": wall, "busy": busy, "replays": replays,
            "traced": traced}


def sampled_of(reqs):
    """The requests again, each with its own temperature and seed: a
    sampled token depends on (seed, emit index, logits), so a replay that
    read stale state would show even where greedy tokens repeat."""
    for i, r in enumerate(reqs):
        r.temperature, r.seed = 1.0 + 0.5 * i, 1000 + i
    return reqs


def serve_modes(cfg, packed, label, requests, *, max_seq, checks, prof=True,
                sampled=True, same_tokens=True, **kw):
    """``requests()`` (a fresh list each call) on a warmed engine in each
    scheduling mode, host-driven then device-resident (its decode block
    captured at the warm-up's first block and replayed from then on), one
    engine alive at a time; the device-resident engine is kept.  With
    ``same_tokens`` the device tokens must be the host ones, greedy (and,
    with ``sampled``, sampled), and only the host-driven engine may wait on
    a readback in steady state.  ``prof`` profiles a window of 4 requests
    in each mode (``prof="device"``: the device-resident mode only), held
    to ``checks`` (``profile_window``).  Returns
    {"host"/"device": {"engine", "reqs", "sampled", "counts", "mem",
    "stats", "profile"}}."""
    from repro_torch import kernels
    from repro_torch.serving import ServingEngine
    out = {}
    for mode in ("host", "device"):
        eng = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                            prefill_chunk=32, decode_block=8,
                            device_sched=mode == "device", **kw)
        eng.run(requests()[:2])            # warm-up (cuBLAS, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        run = {"reqs": eng.run(requests())}
        torch.cuda.synchronize()
        run.update(counts=kernels.launch_counts(), stats=eng.stats,
                   mem=torch.cuda.max_memory_allocated())
        engine_line(f"engine, {label}, {mode:6s}", eng.stats, run["mem"])
        log(f"  launches ({mode}): {run['counts']}")
        if prof is True or prof == mode:
            run["profile"] = profile_window(eng, f"{label}, {mode}",
                                            requests()[:4], checks)
        if sampled:
            run["sampled"] = eng.run(sampled_of(requests()))
        run["engine"] = eng if mode == "device" else None
        del eng
        out[mode] = run
    dev, host = out["device"], out["host"]
    if dev["engine"]._graph is None:
        raise AssertionError(f"{label}: no captured decode block")
    if not same_tokens:
        return out
    for kind in ("reqs", "sampled") if sampled else ("reqs",):
        for h, d in zip(host[kind], dev[kind]):
            if h.output.tolist() != d.output.tolist():
                raise AssertionError(f"{label}: device-resident tokens "
                                     f"({kind}) {d.output.tolist()} != "
                                     f"host-driven {h.output.tolist()}")
    if (dev["stats"]["steady_state_syncs_per_block"] != 0.0
            or host["stats"]["host_syncs_per_block"] != 1.0):
        raise AssertionError(f"{label}: gating syncs a block, device "
                             f"{dev['stats']}, host {host['stats']}")
    distinct = {kind: len(set(np.concatenate([r.output for r in dev[kind]])))
                for kind in (("reqs", "sampled") if sampled else ("reqs",))}
    log(f"  {label}: device-resident tokens == host-driven tokens, "
        f"{'greedy and sampled' if sampled else 'greedy'} (distinct tokens: "
        f"{distinct}); graph launches a replay {dev['engine']._graph.launches}")
    return out


def router_margins(fn):
    """Run fn() with every MoE layer's router logits recorded: returns
    (fn's result, for each routing call in order the margin between the
    top_k-th and the (top_k + 1)-th router logit of each row)."""
    from repro_torch.models import layers
    from repro_torch.models.layers import Ctx
    seen = []

    def route(p, x, *, top_k, capacity_factor, ctx=None):
        logits = layers.linear_apply(p.router, x, Ctx(),
                                     ternary_w=False).float()
        top = torch.topk(logits, top_k + 1, dim=-1).values
        seen.append((top[:, top_k - 1] - top[:, top_k]).detach().cpu())
        return orig(p, x, top_k=top_k, capacity_factor=capacity_factor,
                    ctx=ctx)

    orig = layers.moe_route
    layers.moe_route = route
    try:
        out = fn()
    finally:
        layers.moe_route = orig
    return out, seen


def chunked_oracle(mc, mp, r, dt, dev, max_seq):
    """One request alone as the engine admits it (32-token chunks from 0,
    the last padded past the prompt) on a ``dt`` cache, then one decode
    step a token fed the engine's tokens: each step's gap (the oracle's top
    logit minus its logit of the engine's token) and the least router
    margin over the layers at the row that gives that step's logits (the
    prompt's last row at the prefill, in the last chunk's routing calls;
    padding rows are not read)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    c = 32
    toks = torch.as_tensor(np.asarray(r.prompt, np.int64), device=dev)
    plen = len(r.prompt)
    last_row = (plen - 1) % c
    cache = transformer.init_cache(mc, 1, max_seq, dt, dev)
    gaps, margins = [], []

    def prefill():
        for lo in range(0, plen, c):
            seg = torch.zeros((1, c), dtype=torch.int64, device=dev)
            seg[0, :min(c, plen - lo)] = toks[lo:lo + c]
            out, _ = transformer.prefill_chunk(
                mc, mp, seg, Ctx(), cache, offsets=[lo],
                admit_mask=[True], last_index=[min(plen - 1 - lo, c - 1)])
        return out

    step = prefill
    for i, t in enumerate(r.output.tolist()):
        logits, seen = router_margins(step)
        row = logits[0].float()
        gaps.append(float(row.max() - row[t]))
        margins.append(min(
            float(s[last_row]) for s in seen[-mc.n_layers:]) if i == 0
            else min(float(s.min()) for s in seen))
        pos = plen + i
        step = (lambda t=t, pos=pos: transformer.decode_step(
            mc, mp, torch.tensor([[t]], device=dev), Ctx(), cache,
            pos)[0])
    return gaps, margins


def phase9(dev, gen, requests, max_seq):
    """Phase 9: MoE (mixtral-8x22b), the dense configs (granite-3-2b,
    command-r-35b, qwen2-72b) and ``frontend="embed"`` (musicgen-medium,
    internvl2-76b) at full width, 2 layers each, on random weights from a
    seed.  ``requests()`` gives phase 4's 8 requests afresh.  Returns (the
    kernels' launches in the phase, the failures found)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import ternary
    from repro_torch.kernels.tlmm import ref as tlmm_ref
    from repro_torch.models import layers, transformer
    from repro_torch.models.layers import Ctx
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import reference_decode
    failures = []
    # -- 9. MoE, the dense configs and frontend="embed" at full width -------
    # two layers of each (random weights from a seed); the rest of each
    # model is as published.  Every path's launches are counted.
    t_9 = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    p9_counts = {}

    def add_counts():
        for k, v in kernels.launch_counts().items():
            p9_counts[k] = p9_counts.get(k, 0) + v
        kernels.reset_launch_counts()

    # (a) mixtral-8x22b: 8 experts top-2, window 4096; 2 of 56 layers (the
    # draw and the packed banks: 56 layers' banks alone are ~27 GB)
    mcfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=2)
    mfree = dataclasses.replace(mcfg, capacity_factor=float(mcfg.n_experts))
    torch.cuda.reset_peak_memory_stats()
    mpacked = transformer.init_packed_params(
        mcfg, torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()
    log(f"mixtral-8x22b, 2 layers: packed parameters drawn bank by bank, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB")
    # B1 at the expert banks' shapes, outside the counted runs: each bank
    # of layer 0, one tlmm launch an expert (layers._expert_matmul_packed,
    # as the MoE runs it), at every capacity the engines reach (cf 1.25: 2
    # rows a tick, 40 a wave; drop-free: 8 and 256), each expert's output
    # equal bit for bit to the plain version's acc * x_scale * gamma
    moe0 = mpacked["layers"][0]["moe"]
    bank_gen = torch.Generator(device=dev).manual_seed(90)
    bank_lines = []
    for rows in (2, 8, 40, 256):
        for bank in layers.MoE.BANKS:
            codes = getattr(moe0, f"{bank}_codes")
            gamma = getattr(moe0, f"{bank}_gamma")
            n_in = mcfg.d_ff if bank == "down" else mcfg.d_model
            n_out = codes.shape[-1]
            x = torch.randn((mcfg.n_experts, rows, n_in), generator=bank_gen,
                            device=dev)
            got = layers._expert_matmul_packed(codes, gamma, n_in, moe0.g, x)
            xq, xs = ternary.absmax_quant(x)
            for e in range(mcfg.n_experts):
                want = (tlmm_ref.tlmm_ref(xq[e], codes[e], moe0.g,
                                          n_in).float() * xs[e] * gamma[e])
                if not torch.equal(got[e], want):
                    failures.append(f"tlmm at mixtral's {bank} bank, {rows} "
                                    f"rows, expert {e}: kernel != plain")
            ms = device_ms(lambda c=codes, gm=gamma, n=n_in, x=x:
                           layers._expert_matmul_packed(c, gm, n, moe0.g, x))
            b_ms, b_by = bound_ms(
                mcfg.n_experts * (rows * n_in + codes[0].numel()
                                  + rows * n_out * 4),
                2.0 * mcfg.n_experts * rows * n_in * n_out, INT8_OPS_PER_S)
            bank_lines.append(f"{bank} ({rows}, {n_in}) -> {n_out}: "
                              f"device_ms {ms:.4f} bound_ms {b_ms:.4f} "
                              f"({b_by})")
    log(f"  tlmm at mixtral's expert banks, {mcfg.n_experts} launches a "
        "call, each expert == plain bit for bit (wide shapes, not in the "
        "rows): " + "; ".join(bank_lines))
    del x, got, xq, xs
    kernels.reset_launch_counts()
    moe_checks = {**DECODE_CHECK, **TLMM_CHECK}
    mres = serve_modes(mfree, mpacked, "mixtral-8x22b 2 layers, drop-free",
                       requests, max_seq=max_seq, checks=moe_checks,
                       sampled=False)
    for mode in ("host", "device"):
        c = mres[mode]["counts"]
        for name in ("tlmm", "flash_chunk_prefill", "decode_attention"):
            if c[name] <= 0:
                raise AssertionError(f"mixtral engine ({mode}) did not launch "
                                     f"{name}")
    log(f"  mixtral drop-free, device-resident: tlmm launches in the profiled"
        f" window's replays and waves traced {mres['device']['profile']['traced']}")
    add_counts()
    mreqs = mres["device"]["reqs"]
    del mres
    # the bf16-cache engine judged by an oracle that prefills in the
    # engine's chunk order on a bf16 cache; a request past the gap passes
    # only at a router near-tie at its first diverging position (at most 2)
    near_tie_passes, worst = 0, []
    for i, r in enumerate(mreqs):
        gaps, margins = chunked_oracle(mfree, mpacked, r, torch.bfloat16,
                                       dev, max_seq)
        worst.append(round(max(gaps), 5))
        if max(gaps) > TOKEN_GAP:
            first = next(j for j, g in enumerate(gaps) if g > 0)
            log(f"  mixtral bf16 request {i}: first diverging position {first}"
                f", gap there {gaps[first]:.5f}, least router margin there "
                f"{margins[first]:.3g} (near-tie below {ROUTER_NEAR_TIE})")
            if margins[first] >= ROUTER_NEAR_TIE:
                failures.append(f"mixtral bf16 request {i} off the chunked "
                                f"oracle by {max(gaps)} with no router "
                                "near-tie")
            else:
                near_tie_passes += 1
    log(f"tokens, mixtral bf16 cache vs the chunked bf16 oracle: largest gap "
        f"per request {worst} (limit {TOKEN_GAP}); passed at a router "
        f"near-tie: {near_tie_passes} (at most 2)")
    if near_tie_passes > 2:
        failures.append(f"mixtral: {near_tie_passes} requests passed only at "
                        "router near-ties")
    # the f32-cache engine against the monolithic oracle, as phase 5 judges
    eng = ServingEngine(mfree, mpacked, max_seq=max_seq, batch_slots=4,
                        prefill_chunk=32, decode_block=8,
                        cache_dtype=torch.float32)
    m32 = eng.run(requests())
    del eng
    gaps32 = [max(reference_decode(mfree, mpacked, Ctx(), r.prompt,
                                   len(r.output), max_seq, torch.float32,
                                   follow=r.output)[1]) for r in m32]
    log(f"tokens, mixtral f32 cache vs the monolithic oracle: largest gap per "
        f"request {[round(g, 5) for g in gaps32]} (limit {TOKEN_GAP})")
    if max(gaps32) > TOKEN_GAP:
        failures.append(f"mixtral f32 engine token off the oracle's choice "
                        f"by {max(gaps32)}")
    add_counts()
    # at the config's capacity factor 1.25 capacity couples the lanes (idle
    # and masked rows count), so the two modes may differ: printed
    cres = serve_modes(mcfg, mpacked, "mixtral-8x22b 2 layers, cf 1.25",
                       requests, max_seq=max_seq, checks=moe_checks,
                       prof=False, sampled=False, same_tokens=False)
    differ = sum(int(a != b) for h, d in zip(cres["host"]["reqs"],
                                             cres["device"]["reqs"])
                 for a, b in zip(h.output.tolist(), d.output.tolist()))
    log(f"  mixtral cf 1.25: {differ} of "
        f"{sum(len(r.output) for r in cres['host']['reqs'])} tokens differ "
        "between host-driven and device-resident")
    del cres, mpacked, mreqs
    torch.cuda.empty_cache()
    add_counts()

    # (b) dense configs: one device-resident engine each on 2 requests,
    # every token judged by the oracle
    for name in ("granite-3-2b", "command-r-35b", "qwen2-72b"):
        dcfg = dataclasses.replace(get_config(name), n_layers=2)
        torch.cuda.reset_peak_memory_stats()
        dpacked = transformer.init_packed_params(
            dcfg, torch.Generator(device=dev).manual_seed(9))
        eng = ServingEngine(dcfg, dpacked, max_seq=max_seq, batch_slots=4,
                            prefill_chunk=32, decode_block=8)
        eng.run(requests()[:1])          # warm-up: the block is captured
        drs = eng.run(requests()[:2])
        torch.cuda.synchronize()
        engine_line(f"engine, {name} 2 layers, device", eng.stats,
                    torch.cuda.max_memory_allocated())
        del eng
        dgaps = [max(reference_decode(dcfg, dpacked, Ctx(), r.prompt,
                                      len(r.output), max_seq,
                                      follow=r.output)[1]) for r in drs]
        log(f"  {name}: tokens {[r.output.tolist()[:8] for r in drs]}...; "
            f"largest oracle gap per request {[round(g, 5) for g in dgaps]} "
            f"(limit {TOKEN_GAP})")
        if max(dgaps) > TOKEN_GAP or not all(
                len(r.output) == r.max_new_tokens for r in drs):
            failures.append(f"{name} engine off the oracle by {max(dgaps)}")
        del dpacked
        torch.cuda.empty_cache()
        add_counts()

    # (c) frontend="embed": precomputed embeddings from the seed; the
    # decode step after prefill_step against a monolithic prefill one longer
    for name in ("musicgen-medium", "internvl2-76b"):
        ecfg = dataclasses.replace(get_config(name), n_layers=2)
        epacked = transformer.init_packed_params(
            ecfg, torch.Generator(device=dev).manual_seed(9))
        emb = torch.randn((1, 97, ecfg.d_model), generator=gen, device=dev)
        s_ = emb.shape[1] - 1
        for dt in (torch.float32, torch.bfloat16):
            lim = (LOGIT_TOL_EXACT if dt == torch.float32
                   else LOGIT_TOL_PERTURBED)
            cache = transformer.init_cache(ecfg, 1, max_seq, dt, dev)
            first, _ = transformer.prefill_step(ecfg, epacked, emb[:, :s_],
                                                Ctx(), cache)
            step, _ = transformer.decode_step(ecfg, epacked, emb[:, s_:],
                                              Ctx(), cache, s_)
            longer, _ = transformer.prefill_step(
                ecfg, epacked, emb, Ctx(),
                transformer.init_cache(ecfg, 1, max_seq, dt, dev))
            diff = (step - longer).abs().max().item()
            log(f"  {name} 2 layers, {dt} cache: decode step after "
                f"prefill_step vs monolithic prefill of {s_ + 1}: max |diff| "
                f"{diff:.3g} (tolerance {lim}); logits "
                f"{tuple(step.shape)}, range [{step.min().item():.3f}, "
                f"{step.max().item():.3f}]")
            if not (torch.isfinite(step).all() and torch.isfinite(first).all()
                    and step.shape == (1, ecfg.vocab_size)):
                failures.append(f"{name}: logits not finite or of the wrong "
                                "shape")
            if diff > lim:
                failures.append(f"{name} {dt}: decode vs prefill {diff}")
        del epacked
        torch.cuda.empty_cache()
        add_counts()
    log(f"phase 9: {time.perf_counter() - t_9:.1f} s; launches {p9_counts}")
    return p9_counts, failures


def phase10(dev, gen, max_seq):
    """Phase 10: the recurrent kinds.  (a) The kernels at the shapes
    hymba-1.5b and xlstm-350m give them: tlmm on every linear of both at
    m = 1, 4, 128, bit for bit; flash_prefill at hymba's window of 1024 past
    it (s = 1100, 1500, GQA 25/5, d 64); the decode kernel at lengths [1,
    700, 1100, 1500] with the window, on a bf16 cache (its probabilities
    rounded, as the engine reads it) and an f32 one.  (b) hymba-1.5b and
    (c) xlstm-350m at full width, 4 layers each (random weights from a
    seed), served by ``serve_modes`` on phase 4's 8 requests drawn over
    the model's vocabulary plus a 2-token prompt (whole-prompt admission),
    each token judged by the oracle on a bf16 and an f32 cache; hymba's
    2-token prompt decoded on against the 3-token prefill; the launches of
    one admission.  Returns (the kernels' launches in the phase, the
    failures found)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import bitlinear, ternary
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
    from torch.profiler import ProfilerActivity, profile
    failures = []
    t_10 = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    p10_counts = {}

    def add_counts():
        for k, v in kernels.launch_counts().items():
            p10_counts[k] = p10_counts.get(k, 0) + v
        kernels.reset_launch_counts()

    hcfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=4)
    xcfg = dataclasses.replace(get_config("xlstm-350m"), n_layers=4)

    # -- (a) the kernels at the recurrent models' shapes ----------------------
    g = hcfg.group_size
    shapes = set()
    for c in (hcfg, xcfg):
        d, di = c.d_model, c.n_heads * c.hd
        if c.block_kind == "hymba":
            shapes |= {(d, c.q_dim), (d, c.kv_dim), (c.q_dim, d),
                       (d, 2 * di), (d, 2 * c.ssm_state), (d, c.n_heads),
                       (di, d), (d, c.d_ff), (c.d_ff, d)}
        else:
            shapes |= {(d, 3 * di), (d, 2 * c.n_heads), (d, di), (di, d),
                       (d, 4 * di)}
    parts = []
    for n, k in sorted(shapes):
        w = torch.randint(-1, 2, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        codes = ternary.pack_ternary(w, g, bitlinear.ROW_MULTIPLE)
        for m in (1, 4, 128):
            a = torch.randint(-127, 128, (m, n), generator=gen, device=dev,
                              dtype=torch.int8)
            got = tlmm_ops.tlmm(a, codes, g=g, n=n)
            if not torch.equal(got, tlmm_ref.tlmm_ref(a, codes, g, n)):
                failures.append(f"tlmm m={m} n={n} k={k}: kernel != plain")
            ms = device_ms(lambda a=a, c=codes, n=n: tlmm_ops.tlmm(a, c, g=g,
                                                                    n=n))
            b_ms, _ = bound_ms(m * n + codes.numel() + m * k * 4,
                               2.0 * m * n * k, INT8_OPS_PER_S)
            parts.append(f"m={m} n={n} k={k} {ms:.4f} (bound {b_ms:.5f})")
    log(f"  tlmm at hymba's and xLSTM's {len(shapes)} linear shapes, m = 1, "
        f"4, 128: kernel == plain bit for bit; device_ms " + "; ".join(parts))

    h, kv_h, d, win = hcfg.n_heads, hcfg.n_kv_heads, hcfg.hd, hcfg.swa_window
    for s_ in (1100, 1500):
        q, k, v = (torch.randn(1, s_, nh, d, generator=gen, device=dev
                               ).transpose(1, 2) for nh in (h, kv_h, kv_h))
        got = fp_ops.flash_prefill(q, k, v, window=win)
        want = fp_ref.flash_prefill_ref(q, k, v, window=win)
        err = (got - want).abs().max().item()
        ms = device_ms(lambda q=q, k=k, v=v: fp_ops.flash_prefill(
            q, k, v, window=win))
        # the plain version takes ~850 launches a call at this length, past
        # what the held stream of device_ms queues: timed by events
        pms = event_ms(lambda q=q, k=k, v=v: fp_ref.flash_prefill_ref(
            q, k, v, window=win), iters=2)
        live = sum(min(i + 1, win) for i in range(s_))
        b_ms, by = bound_ms(4 * (2 * s_ * h * d + 2 * s_ * kv_h * d),
                            4.0 * live * h * d, F32_FLOPS_PER_S)
        log(f"  flash_prefill q (1, {h}, {s_}, {d}) k/v (1, {kv_h}, {s_}, "
            f"{d}) window {win}: max_abs_err {err:.3g} (limit {ATTN_ATOL}); "
            f"device_ms {ms:.4f} plain_ms {pms:.4f} (events, host included) "
            f"bound_ms {b_ms:.5f} ({by})")
        if not err <= ATTN_ATOL:
            failures.append(f"flash_prefill s={s_} window {win}: {err}")

    lens = [1, 700, 1100, 1500]
    b, S = len(lens), 1536
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).transpose(1, 2)
    rows_ = [torch.randn(b, S, kv_h, d, generator=gen, device=dev)
             for _ in range(2)]
    live = sum(min(n, win) for n in lens)
    for dt in (torch.bfloat16, torch.float32):
        k, v = (x.to(dt).transpose(1, 2) for x in rows_)
        rnd = dt == torch.bfloat16
        plain = (da_ref.decode_attention_rounded_ref if rnd
                 else da_ref.decode_attention_ref)
        got = da_ops.decode_attention(q, k, v, cl, window=win)
        err = (got - plain(q, k, v, cl, window=win)).abs().max().item()
        ms = device_ms(lambda k=k, v=v: da_ops.decode_attention(
            q, k, v, cl, window=win))
        pms = event_ms(lambda k=k, v=v, plain=plain: plain(
            q, k, v, cl, window=win), iters=2)
        esz = 2 if dt == torch.bfloat16 else 4
        b_ms, by = bound_ms(2 * b * h * d * 4 + 2 * live * kv_h * d * esz,
                            4.0 * live * h * d, F32_FLOPS_PER_S)
        log(f"  decode_attention q ({b}, {h}, 1, {d}) vs {dt} cache (S {S}, "
            f"kv_h {kv_h}), lengths {lens}, window {win}, probabilities "
            f"{'rounded to bf16' if rnd else 'f32'}: max_abs_err {err:.3g} "
            f"(limit {ATTN_ATOL}); device_ms {ms:.4f} plain_ms {pms:.4f} "
            f"(events, host included) bound_ms {b_ms:.5f} ({by})")
        if not err <= ATTN_ATOL:
            failures.append(f"decode_attention window {win} {dt}: {err}")
    # (a)'s checks and timing loops are not the path's launches
    kernels.reset_launch_counts()
    log(f"  (a) kernels at the recurrent models' shapes: "
        f"{time.perf_counter() - t_10:.1f} s")

    # -- (b), (c) the models through the engine -------------------------------
    def requests_of(vocab):
        def requests():
            r = np.random.default_rng(3)
            reqs = [Request(prompt=r.integers(0, vocab,
                                              size=int(r.integers(64, 129))),
                            max_new_tokens=16 + 2 * i) for i in range(8)]
            return reqs + [Request(prompt=np.asarray([7, 11]),
                                   max_new_tokens=12)]
        return requests

    def admission_launches(eng, prompt):
        """cudaLaunchKernel calls of one admission (a request that ends at
        its first token), host-driven."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run([Request(prompt=prompt, max_new_tokens=1)])
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if is_launch(e.key))

    for mcfg, checks in ((hcfg, DECODE_CHECK), (xcfg, {})):
        t_m = time.perf_counter()
        name = f"{mcfg.name} {mcfg.n_layers} layers"
        torch.cuda.reset_peak_memory_stats()
        mpacked = transformer.init_packed_params(
            mcfg, torch.Generator(device=dev).manual_seed(10))
        requests = requests_of(mcfg.vocab_size)
        marks = [("draw", time.perf_counter())]
        res = serve_modes(mcfg, mpacked, name, requests, max_seq=max_seq,
                          checks=checks, prof="device")
        marks.append(("serve_modes", time.perf_counter()))
        for mode in ("host", "device"):
            c = res[mode]["counts"]
            if mcfg.block_kind == "hymba":
                for kname in ("flash_prefill", "decode_attention"):
                    if c[kname] <= 0:
                        failures.append(f"{name} engine ({mode}) did not "
                                        f"launch {kname}")
            elif sum(c.values()):
                failures.append(f"{name} engine ({mode}) launched attention "
                                f"or other port kernels: {c}")
        breqs = res["device"]["reqs"]
        del res
        torch.cuda.empty_cache()
        for r in breqs:
            if not (r.done and len(r.output) == r.max_new_tokens
                    and ((r.output >= 0) & (r.output < mcfg.vocab_size)).all()):
                failures.append(f"{name}: engine output wrong: {r.output}")
        gaps16 = [max(reference_decode(mcfg, mpacked, Ctx(), r.prompt,
                                       len(r.output), max_seq,
                                       torch.bfloat16, follow=r.output)[1])
                  for r in breqs]
        marks.append(("bf16 oracle", time.perf_counter()))
        eng = ServingEngine(mcfg, mpacked, max_seq=max_seq, batch_slots=4,
                            decode_block=8, cache_dtype=torch.float32)
        reqs32 = eng.run(requests())
        engine_line(f"engine, {name}, f32 cache, device", eng.stats,
                    torch.cuda.max_memory_allocated())
        gaps32 = [max(reference_decode(mcfg, mpacked, Ctx(), r.prompt,
                                       len(r.output), max_seq, torch.float32,
                                       follow=r.output)[1]) for r in reqs32]
        marks.append(("f32 engine and oracle", time.perf_counter()))
        log(f"  {name}: largest oracle gap per request, bf16 cache "
            f"{[round(x, 5) for x in gaps16]}, f32 cache "
            f"{[round(x, 5) for x in gaps32]} (limit {TOKEN_GAP})")
        if max(gaps16 + gaps32) > TOKEN_GAP:
            failures.append(f"{name}: engine token off the oracle by "
                            f"{max(gaps16 + gaps32)}")
        # the launches of one admission, at the longest and the shortest
        # prompt (host-driven; counted once, not as the path's)
        heng = ServingEngine(mcfg, mpacked, max_seq=max_seq, batch_slots=4,
                             decode_block=8, device_sched=False)
        heng.run([Request(prompt=np.asarray([1, 2, 3]), max_new_tokens=1)])
        longest = max(requests()[:8], key=lambda r: len(r.prompt)).prompt
        n_long = admission_launches(heng, longest)
        n_short = admission_launches(heng, np.asarray([7, 11]))
        log(f"  {name}: one admission takes {n_long} kernel launches at a "
            f"{len(longest)}-token prompt, {n_short} at a 2-token one")
        del heng, eng
        marks.append(("admission launches", time.perf_counter()))
        # a prompt shorter than the conv ring, decoded on: the 2-token
        # prefill then a decode step against the 3-token prefill (f32)
        p = torch.tensor([[7, 11, 13]], device=dev)
        cache = transformer.init_cache(mcfg, 1, max_seq, torch.float32, dev)
        transformer.prefill_step(mcfg, mpacked, p[:, :2], Ctx(), cache)
        ring_ok = True
        if mcfg.block_kind == "hymba":
            ring_ok = bool((cache["ssm"]["conv"][:, :, 0] == 0).all())
        step, _ = transformer.decode_step(mcfg, mpacked, p[:, 2:], Ctx(),
                                          cache, 2)
        longer, _ = transformer.prefill_step(
            mcfg, mpacked, p, Ctx(),
            transformer.init_cache(mcfg, 1, max_seq, torch.float32, dev))
        diff = (step - longer).abs().max().item()
        gated = mcfg.block_kind == "hymba"
        log(f"  {name}: prefill of 2 tokens, then a decode step, vs the "
            f"prefill of 3, f32 cache: max |diff| {diff:.3g} "
            + (f"(limit {LOGIT_TOL_EXACT}); the ring's leading row zero: "
               f"{ring_ok}" if gated else "(a diagnostic)"))
        if gated and not (diff <= LOGIT_TOL_EXACT and ring_ok):
            failures.append(f"{name}: short prompt decode vs prefill {diff}, "
                            f"zero-padded ring {ring_ok}")
        if not (torch.isfinite(step).all() and step.shape == (
                1, mcfg.vocab_size)):
            failures.append(f"{name}: logits not finite or misshapen")
        del mpacked, cache
        torch.cuda.empty_cache()
        add_counts()
        marks.append(("short prompt", time.perf_counter()))
        log(f"  {name}: {time.perf_counter() - t_m:.1f} s (" + ", ".join(
            f"{what} {t - t0:.1f}" for (_, t0), (what, t) in zip(
                [("", t_m)] + marks[:-1], marks)) + ")")
    log(f"phase 10: {time.perf_counter() - t_10:.1f} s; launches {p10_counts}")
    return p10_counts, failures


# Phase 11's gates.  (a) and (b)'s first three and (c)-(e) were fixed
# before the phase's first run; (a)'s held batch and (b)'s pinned gradients
# were added after (b)'s first parameter gate failed (PERF.md section 6).
# (a): the loss of one batch the steps never see, before and after the 8
# steps, must fall by TRAIN_HELD_DROP: no batch noise, and a run that does
# not train leaves it where it was to the last bit.  (b): the card and the
# CPU run the same f32 step (TF32 off) with their sums in other orders, a
# few ULPs a product, which can move an int8 activation code by one; a
# moved code moves the next linear's output by a whole quantization step,
# and so more codes after it (the CPU tests' finding): the loss within
# TRAIN_LOSS_RTOL of itself, the gradient norm within TRAIN_GNORM_RTOL, and
# every parameter within TRAIN_PARAM_LR_BOUND * lr (AdamW's first update is
# +-lr an element wherever |g| >> eps).  The gradients themselves are held
# with the quantizers pinned (``repro_torch.testing.pinned_quantizers``):
# the CPU replays the card's fake-quantized activations and weights, so the
# two differ in their sums alone, and every leaf's gradient must lie within
# TRAIN_GRAD_RTOL of its largest element.  A control run of the card with TF32 on must fail
# that limit, so the gate can fail.
# (d): the packed oracle's prefill logits against the QAT
# forward's on the same masters: the same math up to association (integer
# sums scaled once against products of dequantized values), so int8 codes
# move as between two softmax orders: LOGIT_TOL_PERTURBED.
TRAIN_HELD_DROP = 0.005
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GNORM_RTOL = 1e-2
TRAIN_PARAM_LR_BOUND = 2.2
# the geometric mean of a calibration run's worst leaves (NVIDIA H100 80GB
# HBM3, 700 W): 1.9e-6 pinned f32, 1.0e-3 the TF32 control (PERF.md)
TRAIN_GRAD_RTOL = 4e-5


TRAIN11_LAYERS = 12   # phase 11 (a) and (d): bitnet's first 12 of 24 layers


def phase11(dev, requests, max_seq, smi):
    """Phase 11: QAT training on the card, bitnet-0.73b, seed 11.  (a) At
    full width, its first TRAIN11_LAYERS layers, batch 8 x seq 128 from the
    synthetic stream, lr
    3e-4 with the launcher's warmup, loss chunk 128: 8 steps of
    ``make_train_step``; the last loss below the first, and the loss of a
    batch never trained on lower after than before; s/step, tokens/s and
    ``max_memory_allocated``.  (d) Those trained masters packed and
    served (phase 4's 8 requests, device-resident engine), every token
    judged by the packed oracle on the engine's history (TOKEN_GAP); the
    oracle's prefill logits against the QAT forward's on the masters.
    At full width with 2 layers: (b) one step on the card against the same
    step on the CPU from the same weights and batch, then with the CPU
    replaying the card's quantized values, and a TF32 control; (c) under
    ``torch.use_deterministic_algorithms``, 2 steps, a checkpoint saved and
    restored, 2 more, equal bit for bit to 4 straight steps; (e) a
    compressed data-parallel step on the NCCL world of one phase 4f set up,
    its gradients equal to ``compress_decompress`` of the single-device
    gradients bit for bit.  Returns (the kernels' launches in the phase,
    the failures found)."""
    import shutil

    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import bitlinear, ternary
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    from repro_torch.optim import adamw, compression
    from repro_torch.optim.adamw import apply_updates, trainable
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import reference_decode
    from repro_torch.testing import leaf_grad_errors, pinned_quantizers
    from repro_torch.training import (loss_and_grads, make_train_step,
                                      make_train_step_ddp, softmax_xent)
    failures = []
    t_11 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    cfg = dataclasses.replace(get_config("bitnet-0.73b"),
                              n_layers=TRAIN11_LAYERS)
    batch, seq, lr, chunk = 8, 128, 3e-4, 128
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=seq, attn_kv_chunk=seq)

    def optimizer(steps):   # the launcher's schedule
        return adamw(lr=lr, warmup_steps=min(100, steps // 10 + 1))

    # -- (a) 8 steps at full width and depth -------------------------------
    mem_before = torch.cuda.memory_allocated()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(11))
    data = SyntheticLMDataset(cfg, batch=batch, seq_len=seq, seed=11,
                              device=dev)
    held = data.batch_at(8)   # the stream's next batch: never trained on

    def held_loss(p):
        with torch.no_grad():
            return float(softmax_xent(transformer.forward(
                cfg, p, held["inputs"], ctx), held["labels"]))

    held_before = held_loss(params)
    torch.cuda.reset_peak_memory_stats()
    opt = optimizer(8)
    state = opt.init(params)
    step = make_train_step(cfg, ctx, opt, loss_chunk=chunk)
    losses, secs = [], []
    for i in range(8):
        b = data.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    held_after = held_loss(params)
    s_step = sum(secs[1:]) / len(secs[1:])
    # the untrained logits' variance costs ~ excess nats over the uniform
    # ln vocab; the stream's map (31 x + 7 mod vocab) has 32000 entries,
    # too many for 8 steps to learn, so only this excess can fall yet
    excess = held_before - math.log(cfg.vocab_size)
    n_params = sum(t.numel() for t in trainable(params).values())
    log(f"  (a) bitnet-0.73b L={cfg.n_layers} d={cfg.d_model} "
        f"{n_params / 1e6:.1f}M f32 masters, batch {batch} x seq {seq}, lr "
        f"{lr}, loss chunk {chunk}: losses {[round(x, 5) for x in losses]}; "
        f"held batch's loss {held_before:.6f} -> {held_after:.6f} (fall "
        f"{held_before - held_after:.6f}, gate {TRAIN_HELD_DROP}; its excess "
        f"over ln vocab {excess:.6f}, of which 8 steps of +-lr on the 0.02 "
        f"tied embeddings can take ~{excess * (1 - (1 - 8 * lr / 0.02) ** 2):.4f}"
        f"); s/step "
        f"{[round(x, 4) for x in secs]} (steps 1-7 mean {s_step:.4f} "
        f"s, {batch * seq / s_step:.1f} tokens/s); max_memory_allocated "
        f"{peak / 2**30:.3f} GiB ({mem_before / 2**30:.3f} GiB held before "
        f"the phase); {smi}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        failures.append(f"(a) losses {losses}: not finite or the last not "
                        "below the first")
    if not held_before - held_after >= TRAIN_HELD_DROP:
        failures.append(f"(a) held batch's loss {held_before} -> "
                        f"{held_after}: fell less than {TRAIN_HELD_DROP}")
    if any(kernels.launch_counts().values()):
        failures.append(f"(a) training launched a port kernel: "
                        f"{kernels.launch_counts()}")
    del state, step, opt, m

    # -- (d) the trained masters packed and served --------------------------
    t_d = time.perf_counter()
    with torch.no_grad():
        packed = transformer.pack_params(cfg, params)
        gaps_logits = []
        for r in requests()[:4]:
            prompt = torch.as_tensor(r.prompt, device=dev)[None]
            qat = transformer.forward(cfg, params, prompt, ctx)[:, -1]
            ora, _ = transformer.prefill_step(
                cfg, packed, prompt, Ctx(), transformer.init_cache(
                    cfg, 1, max_seq, torch.float32, dev))
            gaps_logits.append((qat - ora).abs().max().item())
    del params
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                        prefill_chunk=32, decode_block=8)
    eng.run(requests()[:2])   # warm-up: eager block, capture
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    reqs = eng.run(requests())
    torch.cuda.synchronize()
    p11_counts = kernels.launch_counts()
    st = eng.stats
    del eng
    kernels.reset_launch_counts()
    gaps = []
    for r in reqs:
        if not (r.done and len(r.output) == r.max_new_tokens):
            failures.append(f"(d) request not served: {r.output}")
            continue
        _, g_r = reference_decode(cfg, packed, Ctx(), r.prompt,
                                  len(r.output), max_seq, torch.bfloat16,
                                  follow=r.output)
        gaps.append(max(g_r))
    torch.cuda.synchronize()
    for k, v in kernels.launch_counts().items():
        p11_counts[k] = p11_counts.get(k, 0) + v
    engine_line("  (d) engine, contiguous bf16, device, on the trained "
                "masters packed", st)
    log(f"  (d) tokens {[r.output.tolist() for r in reqs]}; oracle gap per "
        f"request {[round(g, 5) for g in gaps]} (limit {TOKEN_GAP}); QAT "
        f"forward vs oracle prefill logits, 4 prompts: "
        f"{[round(g, 5) for g in gaps_logits]} (limit "
        f"{LOGIT_TOL_PERTURBED}); {time.perf_counter() - t_d:.1f} s")
    if not gaps or max(gaps) > TOKEN_GAP:
        failures.append(f"(d) engine token off the oracle's by {gaps}")
    if max(gaps_logits) > LOGIT_TOL_PERTURBED:
        failures.append(f"(d) QAT forward vs oracle logits {gaps_logits}")
    for name in ("flash_chunk_prefill", "decode_attention", "tlmm",
                 "flash_prefill"):
        if p11_counts.get(name, 0) <= 0:
            failures.append(f"(d) did not launch {name}")
    del packed, reqs
    torch.cuda.empty_cache()

    # -- (b) the card against the CPU, full width, 2 layers ------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    master2 = transformer.init_params(cfg2, torch.Generator().manual_seed(12))
    data2 = SyntheticLMDataset(cfg2, batch=batch, seq_len=seq, seed=12,
                               device="cpu")
    batch2 = data2.batch_at(0)
    t_b = time.perf_counter()

    def one_step(where, tape=None, replay=False, tf32=False):
        """One step from master2 on batch2: (loss, grad norm, updated
        params, grads, int8 input codes of each QAT linear), all on the
        CPU.  With ``tape`` the quantizers are recorded or replayed."""
        p = copy.deepcopy(master2).to(where)
        b = {k: v.to(where) for k, v in batch2.items()}
        codes, apply_qat = [], bitlinear.apply_qat

        def recording(lin, x, **kw):
            codes.append(ternary.absmax_quant(x.detach(),
                                              reciprocal=True)[0].cpu())
            return apply_qat(lin, x, **kw)

        bitlinear.apply_qat = recording
        torch.backends.cuda.matmul.allow_tf32 = tf32
        pin = (pinned_quantizers(tape, replay) if tape is not None
               else contextlib.nullcontext())
        try:
            with pin:
                loss, grads = loss_and_grads(cfg2, ctx, p, b, chunk)
        finally:
            bitlinear.apply_qat = apply_qat
            torch.backends.cuda.matmul.allow_tf32 = False
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in grads.values()))
        # a copy: AdamW clips the gradients in place
        grads_cpu = {n: g.to("cpu", copy=True) for n, g in grads.items()}
        opt = optimizer(1)
        upd, _ = opt.update(grads, opt.init(p), p)
        p = apply_updates(p, upd)
        return (float(loss), float(gnorm),
                {n: t.cpu() for n, t in trainable(p).items()},
                grads_cpu, codes)

    tape32, tape_tf32 = [], []
    l_c, g_c, p_c, gr_c, codes_c = one_step(dev, tape32)
    l_h, g_h, p_h, gr_h, codes_h = one_step("cpu")
    _, _, p_pin, gr_pin, _ = one_step("cpu", tape32, replay=True)
    gr_tf32 = one_step(dev, tape_tf32, tf32=True)[3]
    gr_tf32_pin = one_step("cpu", tape_tf32, replay=True)[3]
    del tape32, tape_tf32
    moved = [int((a != b_).sum()) for a, b_ in zip(codes_c, codes_h)]
    err_free = leaf_grad_errors(gr_c, gr_h)
    err_pin = leaf_grad_errors(gr_c, gr_pin)
    err_tf32 = leaf_grad_errors(gr_tf32, gr_tf32_pin)
    worst_pin = max(err_pin, key=err_pin.get)
    worst_tf32 = max(err_tf32.values())
    # the card's gradients through AdamW on the CPU: the update alone
    p_ref = copy.deepcopy(master2)
    opt = optimizer(1)
    upd, _ = opt.update({n: g.clone() for n, g in gr_c.items()},
                        opt.init(p_ref), p_ref)
    p_ref = trainable(apply_updates(p_ref, upd))
    worst, n_off, n_off_pin, n_off_same, n_all = 0.0, 0, 0, 0, 0
    for n, t in p_h.items():
        d = (p_c[n] - t).abs()
        worst = max(worst, d.max().item())
        n_off += int((d > 1e-6 * t.abs().max()).sum())
        n_off_pin += int(((p_c[n] - p_pin[n]).abs()
                          > 1e-6 * p_pin[n].abs().max()).sum())
        n_off_same += int(((p_c[n] - p_ref[n]).abs()
                           > 1e-6 * t.abs().max()).sum())
        n_all += t.numel()
    log(f"  (b) one step, card vs CPU (2 layers, TF32 off): loss {l_c:.7f} "
        f"vs {l_h:.7f}, grad norm {g_c:.6f} vs {g_h:.6f}; int8 activation "
        f"codes moved, QAT linear inputs in call order (forward, then the "
        f"remat recompute): {moved} of {codes_h[0].numel()} each; params: "
        f"largest difference {worst:.3g} ({worst / lr:.3f} lr), {n_off} of "
        f"{n_all} elements past 1e-6 of their tensor's largest ({n_off_pin} "
        f"with the quantizers pinned); the card's gradients through AdamW on "
        f"the CPU: {n_off_same} elements past that from the card's update")
    log(f"  (b) gradients, max |card - CPU| / max |CPU| a leaf: quantizers "
        f"free, worst {max(err_free.values()):.3g} "
        f"({max(err_free, key=err_free.get)}); pinned, worst "
        f"{err_pin[worst_pin]:.3g} ({worst_pin}, gate {TRAIN_GRAD_RTOL}); "
        f"TF32 control pinned, least {min(err_tf32.values()):.3g}, worst "
        f"{worst_tf32:.3g} (must exceed the gate); per leaf, pinned f32 / "
        f"TF32: " + ", ".join(f"{n} {err_pin[n]:.2g}/{err_tf32[n]:.2g}"
                              for n in err_pin)
        + f"; {time.perf_counter() - t_b:.1f} s")
    if not (abs(l_c - l_h) <= TRAIN_LOSS_RTOL * abs(l_h)
            and abs(g_c - g_h) <= TRAIN_GNORM_RTOL * g_h
            and worst <= TRAIN_PARAM_LR_BOUND * lr and n_off_same == 0):
        failures.append("(b) card and CPU steps differ past the gates")
    if not err_pin[worst_pin] <= TRAIN_GRAD_RTOL < worst_tf32:
        failures.append(f"(b) pinned gradients: worst leaf "
                        f"{err_pin[worst_pin]}, TF32 control {worst_tf32}, "
                        f"gate {TRAIN_GRAD_RTOL}")
    del gr_h, gr_pin, gr_tf32, gr_tf32_pin, p_pin

    # -- (c) checkpoint resume and (e) compressed DDP, deterministic ---------
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "phase11_ckpt")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    t_c = time.perf_counter()
    try:
        opt = optimizer(4)
        step = make_train_step(cfg2, ctx, opt, loss_chunk=chunk)
        batches = [{k: v.to(dev) for k, v in data2.batch_at(i).items()}
                   for i in range(4)]
        p1 = copy.deepcopy(master2).to(dev)
        s1 = opt.init(p1)
        for b in batches:
            p1, s1, _ = step(p1, s1, b)
        p2 = copy.deepcopy(master2).to(dev)
        s2 = opt.init(p2)
        for b in batches[:2]:
            p2, s2, _ = step(p2, s2, b)
        mgr = CheckpointManager(ckpt_dir)
        mgr.save(2, {"params": p2, "opt": s2})
        restored = mgr.restore(None, {"params": p2, "opt": s2})
        del p2, s2
        p3, s3 = restored["params"], restored["opt"]
        for b in batches[2:]:
            p3, s3, _ = step(p3, s3, b)
        same = all(torch.equal(a, b) for a, b in zip(
            trainable(p1).values(), trainable(p3).values())) and all(
            torch.equal(s1.m[n], s3.m[n]) and torch.equal(s1.v[n], s3.v[n])
            for n in s1.m) and int(s1.step) == int(s3.step) == 4
        log(f"  (c) 2 steps + save + restore + 2 steps == 4 straight steps, "
            f"bit for bit (deterministic algorithms): {same}; "
            f"{time.perf_counter() - t_c:.1f} s")
        if not same:
            failures.append("(c) resumed training differs from 4 straight "
                            "steps")
        del p1, s1, p3, s3, restored, step

        t_e = time.perf_counter()
        p = copy.deepcopy(master2).to(dev)
        _, grads = loss_and_grads(cfg2, ctx, p, batches[0], chunk)
        zero = compression.init_error_state(trainable(p))
        ddp = make_train_step_ddp(cfg2, ctx, optimizer(1), compress=True,
                                  loss_chunk=chunk, return_grads=True)
        _, _, err, m = ddp(p, optimizer(1).init(p), zero, batches[0])
        exact = all(torch.equal(m["grads"][n], compression.compress_decompress(
            g, zero[n])[0]) and torch.equal(err[n], compression
                                              .compress_decompress(
                                                  g, zero[n])[1])
            for n, g in grads.items())
        log(f"  (e) compressed DDP step, NCCL world of "
            f"{dist.get_world_size()} ({dist.get_backend()}): gradients == "
            f"compress_decompress of the single-device gradients, and the "
            f"errors, bit for bit: {exact}; {time.perf_counter() - t_e:.1f} s")
        if not exact:
            failures.append("(e) compressed DDP gradients differ from "
                            "compress_decompress")
        del p, grads, m, err
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 11: {time.perf_counter() - t_11:.1f} s; launches "
        f"{p11_counts}")
    if time.perf_counter() - t_11 > 90:
        failures.append(f"phase 11 took {time.perf_counter() - t_11:.1f} s "
                        "(gate 90 s)")
    return p11_counts, failures


# Phase 12's gates, fixed before its first run (PERF.md section 6).
# (a) full width, batch 8 x seq 128 (the launcher's), lr 3e-4 and the
# launcher's warmup, loss chunk 128; depth cut, widths never: {name:
# (layers, steps)}.  Each model's held batch (the stream's
# ``batch_at(steps)``, never trained on) must lose TRAIN_HELD_DROP over its
# steps, as phase 11's (an untrained model leaves it to the bit).  The
# reckoning, written before the first run: each untied head is N(0, 1/d),
# so its logits have variance ~1 and the loss starts ~0.5 over ln vocab;
# AdamW moves every head element by +-lr a step, 9.4 % (mixtral, 4 steps),
# 9.6 % (hymba, 8) and 7.7 % (xLSTM, 8) of its std, which can take ~0.07-0.09
# of that excess; phase 11 took 44 % of its like reckoning: ~0.03-0.04
# predicted, 0.005 the gate for each.
TRAIN12 = {"mixtral-8x22b": (1, 4), "hymba-1.5b": (4, 8),
           "xlstm-350m": (4, 8)}
# (b) xLSTM: the gate fixed before the phase's first run (every gradient
# leaf within TRAIN_GRAD_RTOL with the quantizers pinned) failed in that
# run, 0.0268 at the sLSTM's wx (PERF.md section 6).  The failure stands:
# its reading is printed, not gated.  Gated since, set before its own
# first run: the same comparison with the sLSTM's first-position kinks
# taken out of the backward on both devices
# (``repro_torch.testing.slstm_kinks_excluded``, found from the recorded
# quantized values, never from a gradient), at most SLSTM_KINKS_MAX of
# them an sLSTM (8 x 1024 first-position input-gate pre-activations).
# C7's gate, fixed before its first run: every element of every leaf
# within TRAIN_GRAD_RTOL with the CPU taking the card's pre-activation
# values at those kinks (``repro_torch.testing.slstm_kinks_pinned``),
# nothing cut from the backward; a TF32 control past it.
SLSTM_KINKS_MAX = 8
# phase 12 as a whole, and every phase of the script
PHASE12_S = 120
ALL_PHASES_S = 1000


def phase12(dev, requests, max_seq, smi):
    """Phase 12: QAT training of MoE, hymba and xLSTM on the card, seed
    12, through ``make_train_step`` at full width (TRAIN12's depths and
    steps): (a) finite losses, a held batch's loss lower after than before,
    no port kernel launched, s/step, tokens/s, ``max_memory_allocated`` and
    the kernel launches of one step; hymba's ``loss_and_grads`` at 1 x 1536
    (past its 1024 window) with finite gradients and fewer live attention
    tile pairs than causal.  (b) hymba and xLSTM at 2 layers (1 pair), one
    step, TF32 off: every gradient leaf within TRAIN_GRAD_RTOL of the CPU
    replaying the card's quantized values (xLSTM's with the sLSTM's
    first-position kinks excluded), a TF32 control past it; xLSTM's also
    every element with the CPU taking the card's pre-activations at those
    kinks (C7's gate, a TF32 control past it), and every element as first
    fixed, printed ungated.  (c)
    Each trained model packed and serving phase 4's 8 requests on the
    device-resident engine (mixtral drop-free), every token judged by the
    oracle on the engine's history (TOKEN_GAP; mixtral by phase 9's chunked
    bf16 oracle and its router near-tie rule), the QAT forward's
    last-position logits within LOGIT_TOL_PERTURBED of the oracle's
    prefill on 4 prompts; tlmm (inside mixtral's captured block),
    flash_prefill, flash_chunk_prefill and decode_attention (hymba's
    rounded read) launched.  Returns (the kernels' launches in (c), the
    failures found)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import attention, transformer
    from repro_torch.models.layers import Ctx
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import trainable
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import reference_decode
    from repro_torch.testing import (leaf_grad_errors, pinned_quantizers,
                                     slstm_kinks_excluded, slstm_kinks_pinned)
    from repro_torch.training import (loss_and_grads, make_train_step,
                                      softmax_xent)
    failures = []
    t_12 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    batch, seq, lr, chunk = 8, 128, 3e-4, 128
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=seq, attn_kv_chunk=seq)
    p12_counts = {}

    def add_counts():
        for k, v in kernels.launch_counts().items():
            p12_counts[k] = p12_counts.get(k, 0) + v
        kernels.reset_launch_counts()

    def step_launches(step, params, state, b):
        """cudaLaunchKernel calls of one training step (profiled)."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = step(params, state, b)
            torch.cuda.synchronize()
        return out, sum(e.count for e in prof.key_averages()
                        if is_launch(e.key))

    trained = {}
    # -- (a) training at full width ---------------------------------------
    for name, (n_layers, steps) in TRAIN12.items():
        t_a = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(12))
        data = SyntheticLMDataset(cfg, batch=batch, seq_len=seq, seed=12,
                                  device=dev)
        held = data.batch_at(steps)   # never trained on

        def held_loss(p):
            with torch.no_grad():
                return float(softmax_xent(transformer.forward(
                    cfg, p, held["inputs"], ctx), held["labels"]))

        held_before = held_loss(params)
        opt = adamw(lr=lr, warmup_steps=min(100, steps // 10 + 1))
        state = opt.init(params)
        step = make_train_step(cfg, ctx, opt, loss_chunk=chunk)
        losses, secs, launches = [], [], None
        for i in range(steps):
            b = data.batch_at(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 1:   # the first step after the warm one, profiled
                (params, state, m), launches = step_launches(step, params,
                                                             state, b)
            else:
                params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        held_after = held_loss(params)
        timed = [x for i, x in enumerate(secs) if i > 1]
        s_step = sum(timed) / len(timed)
        n_params = sum(t.numel() for t in trainable(params).values())
        log(f"  (a) {name} L={n_layers} d={cfg.d_model} {n_params / 1e6:.1f}M "
            f"f32 masters, batch {batch} x seq {seq}, lr {lr}, loss chunk "
            f"{chunk}, {steps} steps: losses {[round(x, 5) for x in losses]}; "
            f"held batch's loss {held_before:.6f} -> {held_after:.6f} (fall "
            f"{held_before - held_after:.6f}, gate {TRAIN_HELD_DROP}, excess "
            f"over ln vocab {held_before - math.log(cfg.vocab_size):.4f}); "
            f"s/step {[round(x, 4) for x in secs]} (unprofiled steps 2+ mean "
            f"{s_step:.4f} s, {batch * seq / s_step:.1f} tokens/s); "
            f"cudaLaunchKernel calls of step 1 (profiled) {launches}; "
            f"max_memory_allocated {peak / 2**30:.3f} GiB "
            f"({mem_before / 2**30:.3f} GiB held before); "
            f"{time.perf_counter() - t_a:.1f} s; {smi}")
        if not all(np.isfinite(losses)):
            failures.append(f"(a) {name}: losses {losses} not finite")
        if not held_before - held_after >= TRAIN_HELD_DROP:
            failures.append(f"(a) {name}: held batch's loss {held_before} -> "
                            f"{held_after}: fell less than {TRAIN_HELD_DROP}")
        del state, step, opt, m, b
        trained[name] = (cfg, params)
        if name == "hymba-1.5b":
            # one sequence past the 1024 window: the live tiles skip the
            # window's dead ones, every gradient finite
            pairs, live_pairs = [], attention.live_tile_pairs

            def counted(*a, **kw):
                out = live_pairs(*a, **kw)
                pairs.append(len(out))
                return out

            long = SyntheticLMDataset(cfg, batch=1, seq_len=1536, seed=12,
                                      device=dev).batch_at(0)
            attention.live_tile_pairs = counted
            try:
                l_long, g_long = loss_and_grads(cfg, ctx, params, long, chunk)
            finally:
                attention.live_tile_pairs = live_pairs
            n_t = 1536 // seq
            causal = len(live_pairs(n_t, n_t, seq, seq, True, None))
            finite = all(torch.isfinite(g).all() for g in g_long.values())
            log(f"  (a) hymba-1.5b loss_and_grads at 1 x 1536, window "
                f"{cfg.swa_window}: loss {float(l_long):.5f}, gradients "
                f"finite {finite}; live tile pairs a call {sorted(set(pairs))}"
                f" against {causal} causal ({n_t} x {n_t} tiles of {seq})")
            if not (finite and pairs and max(pairs) < causal):
                failures.append(f"(a) hymba at 1536: finite {finite}, tile "
                                f"pairs {pairs} against causal {causal}")
            del g_long
        if any(kernels.launch_counts().values()):
            failures.append(f"(a) {name}: training launched a port kernel: "
                            f"{kernels.launch_counts()}")
        kernels.reset_launch_counts()
        torch.cuda.empty_cache()

    # -- (c) the trained masters packed and served ---------------------------
    for name, (cfg, params) in list(trained.items()):
        t_c = time.perf_counter()
        scfg = (dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
                if cfg.n_experts else cfg)   # MoE drop-free
        with torch.no_grad():
            packed = transformer.pack_params(scfg, params)
            gaps_logits = []
            for r in requests()[:4]:
                prompt = torch.as_tensor(r.prompt, device=dev)[None]
                (qat, ), seen = router_margins(lambda: (transformer.forward(
                    scfg, params, prompt, ctx)[:, -1], ))
                ora, _ = transformer.prefill_step(
                    scfg, packed, prompt, Ctx(), transformer.init_cache(
                        scfg, 1, max_seq, torch.float32, dev))
                gap = (qat - ora).abs().max().item()
                tie = min((float(s_[-1]) for s_ in seen), default=math.inf)
                gaps_logits.append((round(gap, 5), round(tie, 5)))
                if gap > LOGIT_TOL_PERTURBED and not tie < ROUTER_NEAR_TIE:
                    failures.append(f"(c) {name}: QAT forward vs oracle "
                                    f"logits {gap}, router margin {tie}")
        del params
        trained[name] = None
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        eng = ServingEngine(scfg, packed, max_seq=max_seq, batch_slots=4,
                            prefill_chunk=32, decode_block=8)
        eng.run(requests()[:2])   # warm-up: eager block, capture
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        reqs = eng.run(requests())
        torch.cuda.synchronize()
        st = eng.stats
        in_graph = (dict(eng._graph.launches) if eng._graph is not None
                    else {})
        eng_counts = kernels.launch_counts()
        add_counts()
        del eng
        gaps, ties = [], 0
        for i, r in enumerate(reqs):
            if not (r.done and len(r.output) == r.max_new_tokens):
                failures.append(f"(c) {name}: request not served: "
                                f"{r.output}")
                continue
            if cfg.n_experts:   # phase 9's chunked bf16 oracle
                g_r, margins = chunked_oracle(scfg, packed, r,
                                              torch.bfloat16, dev, max_seq)
                if max(g_r) > TOKEN_GAP:
                    first = next(j for j, g in enumerate(g_r) if g > 0)
                    log(f"  (c) {name} request {i}: first diverging position "
                        f"{first}, gap {g_r[first]:.5f}, least router margin "
                        f"{margins[first]:.3g}")
                    if margins[first] < ROUTER_NEAR_TIE:
                        ties += 1
                        g_r = [0.0]
            else:
                _, g_r = reference_decode(scfg, packed, Ctx(), r.prompt,
                                          len(r.output), max_seq,
                                          torch.bfloat16, follow=r.output)
            gaps.append(max(g_r))
        add_counts()
        engine_line(f"  (c) engine, {name} {cfg.n_layers} layers, bf16 cache, "
                    "device, on the trained masters packed", st)
        log(f"  (c) {name}: oracle gap per request "
            f"{[round(g, 5) for g in gaps]} (limit {TOKEN_GAP}; passed at a "
            f"router near-tie: {ties}, at most 2); QAT forward vs oracle "
            f"prefill logits, 4 prompts (gap, least router margin at the last"
            f" row): {gaps_logits} (limit {LOGIT_TOL_PERTURBED}); engine "
            f"launches {eng_counts}, a replay {in_graph}; "
            f"{time.perf_counter() - t_c:.1f} s")
        if not gaps or max(gaps) > TOKEN_GAP or ties > 2:
            failures.append(f"(c) {name}: engine tokens off the oracle's by "
                            f"{gaps} ({ties} near-ties)")
        if cfg.n_experts and in_graph.get("tlmm", 0) <= 0:
            failures.append(f"(c) {name}: no tlmm launch in the captured "
                            f"block {in_graph}")
        if cfg.block_kind == "hymba" and eng_counts.get(
                "decode_attention", 0) <= 0:
            failures.append(f"(c) {name}: the engine did not launch "
                            "decode_attention")
        del packed, reqs
        torch.cuda.empty_cache()
    for k in ("tlmm", "flash_prefill", "flash_chunk_prefill",
              "decode_attention"):
        if p12_counts.get(k, 0) <= 0:
            failures.append(f"(c) did not launch {k}")

    # -- (b) the card against the CPU, full width, 2 layers -----------------
    t_b = time.perf_counter()
    for name in ("hymba-1.5b", "xlstm-350m"):
        cfg2 = dataclasses.replace(get_config(name), n_layers=2)
        master = transformer.init_params(cfg2,
                                         torch.Generator().manual_seed(12))
        b2 = SyntheticLMDataset(cfg2, batch=batch, seq_len=seq, seed=12,
                                device="cpu").batch_at(0)
        xl = cfg2.block_kind == "xlstm_pair"

        def grads_of(where, tape, replay, tf32=False, kinks=None, pin=None):
            p = copy.deepcopy(master).to(where)
            bb = {k: v.to(where) for k, v in b2.items()}
            torch.backends.cuda.matmul.allow_tf32 = tf32
            excl = (slstm_kinks_excluded(tape, kinks[0], not replay,
                                         kinks[1]) if kinks is not None
                    else slstm_kinks_pinned(tape, *pin, not replay)
                    if pin is not None else contextlib.nullcontext())
            try:
                with pinned_quantizers(tape, replay), excl:
                    loss, grads = loss_and_grads(cfg2, ctx, p, bb, chunk)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            return float(loss), {n: g.to("cpu", copy=True)
                                 for n, g in grads.items()}

        errs, losses, kinks, standing = {}, {}, {}, None
        for tf32 in (False, True):
            tape, masks, seen_c, seen_h = [], [], [], []
            l_c, g_c = grads_of(dev, tape, False, tf32,
                                (masks, seen_c) if xl else None)
            l_h, g_h = grads_of("cpu", tape, True, False,
                                (masks, seen_h) if xl else None)
            errs[tf32], losses[tf32] = leaf_grad_errors(g_c, g_h), (l_c, l_h)
            kinks[tf32] = (masks, seen_c, seen_h)
            del tape, g_c, g_h
        if xl:
            # every element; the card's run records its kink values (its
            # forward unchanged), read twice on the CPU: as first fixed
            # (ungated) and with the kinks given the card's values (C7)
            c7 = {}
            for tf32 in (False, True):
                tape, pm, pv = [], [], []
                _, g_c = grads_of(dev, tape, False, tf32, pin=(pm, pv))
                if not tf32:
                    _, g_h = grads_of("cpu", tape, True)
                    standing = leaf_grad_errors(g_c, g_h)
                    del g_h
                _, g_k = grads_of("cpu", tape, True, pin=(pm, pv))
                c7[tf32] = (leaf_grad_errors(g_c, g_k),
                            [int(m.sum()) for m in pm])
                del tape, g_c, g_k
        worst = max(errs[False], key=errs[False].get)
        worst_tf32 = max(errs[True].values())
        n_kinks = [int(m.sum()) for m in kinks[False][0]]
        log(f"  (b) {name}, 2 layers, one step, card vs the CPU replaying the "
            f"card's quantized values"
            + (" with the sLSTM's first-position kinks excluded" if xl
               else "")
            + f": losses {losses[False]}; gradients, max |card - CPU| / max "
            f"|CPU| a leaf: worst {errs[False][worst]:.3g} ({worst}, gate "
            f"{TRAIN_GRAD_RTOL}); TF32 control worst {worst_tf32:.3g}, least "
            f"{min(errs[True].values()):.3g} (must exceed the gate)"
            + (f"; kinks excluded an sLSTM call {n_kinks} (at most "
               f"{SLSTM_KINKS_MAX}; TF32 run "
               f"{[int(m.sum()) for m in kinks[True][0]]}), their "
               f"pre-activations on the card "
               f"{[v.tolist() for v in kinks[False][1][:1]]}, on the CPU "
               f"{[v.tolist() for v in kinks[False][2][:1]]}; the gate as "
               f"fixed before the first run (every element, not met there, "
               f"not gated): worst {max(standing.values()):.3g} "
               f"({max(standing, key=standing.get)}); C7, every element with "
               f"the kinks given the card's pre-activations: worst "
               f"{max(c7[False][0].values()):.3g} "
               f"({max(c7[False][0], key=c7[False][0].get)}, gate "
               f"{TRAIN_GRAD_RTOL}), TF32 control worst "
               f"{max(c7[True][0].values()):.3g} (must exceed the gate), "
               f"kinks pinned an sLSTM call {c7[False][1]} (TF32 run "
               f"{c7[True][1]})" if xl else "")
            + f"; {time.perf_counter() - t_b:.1f} s")
        if not errs[False][worst] <= TRAIN_GRAD_RTOL < worst_tf32:
            failures.append(f"(b) {name}: pinned gradients worst "
                            f"{errs[False][worst]}, TF32 control {worst_tf32}"
                            f", gate {TRAIN_GRAD_RTOL}")
        if xl and not (max(c7[False][0].values()) <= TRAIN_GRAD_RTOL
                       < max(c7[True][0].values())):
            failures.append(f"(b) {name}: C7's gate, every element with the "
                            f"kinks pinned: worst "
                            f"{max(c7[False][0].values())}, TF32 control "
                            f"{max(c7[True][0].values())}, gate "
                            f"{TRAIN_GRAD_RTOL}")
        if xl and not (c7[False][1] and max(c7[False][1]) <= SLSTM_KINKS_MAX):
            failures.append(f"(b) {name}: sLSTM kinks pinned {c7[False][1]} "
                            f"(at most {SLSTM_KINKS_MAX})")
        if xl and not (n_kinks and max(n_kinks) <= SLSTM_KINKS_MAX):
            failures.append(f"(b) {name}: sLSTM kinks excluded {n_kinks} "
                            f"(at most {SLSTM_KINKS_MAX})")
        del master
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_12
    log(f"phase 12: {took:.1f} s; launches {p12_counts}")
    if took > PHASE12_S:
        failures.append(f"phase 12 took {took:.1f} s (gate {PHASE12_S} s)")
    return p12_counts, failures


# phase 13: QAT training under a mesh, fixed before its first run
PHASE13_S = 90
# bitnet-0.73b's layers served and judged in phases 4-8 (of its 24): the cut
# is the run's time (PERF.md section 4; 8 since phase 13's FSDP step went to
# 8 layers and phase 14 took a third mixtral step)
SERVE_LAYERS = 8
TRAIN13 = dict(batch=8, seq=128, lr=3e-4, chunk=128, layers=2, seed=13)
# (b)'s three setups: (name, mesh, layout, fsdp, layers); FSDP at 8 of the
# 24 layers, so that a rank's blocks and one block gathered at a time show
FSDP13_LAYERS = 8
SETUPS13 = (("(1, 2) 2d", (1, 2), "2d", False, TRAIN13["layers"]),
            ("(2, 1) 2d fsdp", (2, 1), "2d", True, FSDP13_LAYERS),
            ("(2, 1) dpzero1", (2, 1), "dpzero1", False, TRAIN13["layers"]))
# (b)'s FSDP step: each rank's peak above what it held before the step,
# against the dry run's estimate of the same step, relative to the reading
PEAK13_RTOL = 0.2
PIPE13 = dict(stages=2, micro=4, rows=2)
PHASE13_RANK_S = 75   # the two ranks' share of the phase


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phase13_setup(dev, n_layers=None):
    """bitnet-0.73b at full width (``n_layers`` deep, else its 24), its
    training context, masters from seed 13 and the synthetic batches."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    t = TRAIN13
    cfg = get_config("bitnet-0.73b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=t["seq"],
              attn_kv_chunk=t["seq"])
    full = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(t["seed"]))
    data = SyntheticLMDataset(cfg, batch=t["batch"], seq_len=t["seq"],
                              seed=t["seed"], device=dev)
    return cfg, ctx, full, data


def _sharded_state(mesh, full, layout, fsdp, opt):
    from repro_torch.runtime import sharding
    p = sharding.shard_params(mesh, full, fsdp=fsdp,
                              layout="dp" if layout == "dpzero1" else "2d")
    z = sharding.Zero1(mesh, p) if layout == "dpzero1" else None
    return p, opt.init(p, zero1=z), z


def _phase13_judge(mesh, p, m, g_ref, p_ref, l_ref, lr, secs, peak, held):
    """(b)'s readings of one setup's step on a rank against the
    single-device step: the loss, the worst gathered gradient leaf, the
    parameters after AdamW, s/step and the peak (``peak``, and above what
    the rank held before the step, ``held``)."""
    from repro_torch.optim.adamw import trainable
    from repro_torch.runtime import sharding
    from repro_torch.testing import leaf_grad_errors
    t = TRAIN13
    specs = sharding.tree_specs(p)
    grads = {n: mesh.full_part(g, specs[n]) for n, g in m["grads"].items()}
    errs = leaf_grad_errors(grads, g_ref)
    worst = max(errs, key=errs.get)
    p_err = max(((mesh.full_part(v, specs[n]) - p_ref[n]).abs().max()
                 ).item() for n, v in trainable(p).items())
    loss = float(m["loss"])
    return dict(loss=loss, loss_ref=float(l_ref),
                loss_rel=abs(loss - float(l_ref)) / abs(float(l_ref)),
                grad_worst=errs[worst], grad_worst_leaf=worst,
                param_err_lr=p_err / lr, s_step=secs,
                tokens_s=t["batch"] * t["seq"] / secs, peak_gib=peak / 2**30,
                above=peak - held)


def _phase13_estimate(layers):
    """The dry run's estimate (``launch.dryrun``: the step on ``meta``
    tensors, ``Census``) of (b)'s FSDP step on rank 0 of a (2, 1)
    ``DryMesh``, the card's own step (f32 masters, the phase's context,
    ``return_grads``) at ``layers``: (bytes above its arguments, one
    block's leaves' bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    from repro_torch.optim import adamw
    from repro_torch.runtime.collectives import DryMesh
    from repro_torch.training import make_train_step_sharded
    t = TRAIN13
    cfg = dataclasses.replace(get_config("bitnet-0.73b"), n_layers=layers)
    with dryrun.MetaInit():
        full = transformer.init_params(cfg, torch.Generator())
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=t["seq"],
              attn_kv_chunk=t["seq"])
    opt = adamw(lr=t["lr"])
    mesh = DryMesh((2, 1))
    p, st, _ = _sharded_state(mesh, full, "2d", True, opt)
    step = make_train_step_sharded(cfg, ctx, opt, mesh,
                                   global_batch=t["batch"],
                                   loss_chunk=t["chunk"], return_grads=True)
    batch = {k: torch.zeros_like(v, device="meta") for k, v in
             make_batch_specs(cfg, t["batch"], t["seq"],
                              device="meta").items()}
    est = dryrun.estimate(dryrun.Cell(step, (p, st, batch), mesh, 0))
    block = sum(v.numel() * v.element_size()
                for v in full["layers"][0].buffers())
    return est["memory"]["peak_bytes_est"], block


def _phase13_rank(rank, world, port, workdir, device="cuda"):
    """One of phase 13's two gloo ranks on the one card: (b), (c), (d).
    Writes its readings to ``workdir/rank{rank}.json``."""
    entered = time.time()
    import hashlib
    import shutil
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import layers, transformer
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWState, trainable
    from repro_torch.runtime import sharding
    from repro_torch.runtime.collectives import TrainMesh
    from repro_torch.runtime.pipeline import (pipeline_forward,
                                              split_layers_into_stages)
    from repro_torch.testing import pinned_quantizers
    from repro_torch.training import loss_and_grads, make_train_step_sharded
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    dev = torch.device(device, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.use_deterministic_algorithms(True)
    out = {"rank": rank, "entered": entered}
    t = TRAIN13
    lr = t["lr"]
    try:
        cfg, ctx, full, data = _phase13_setup(dev, t["layers"])
        batch = data.batch_at(0)
        opt = adamw(lr=lr)
        out["ready"] = time.time()
        # -- (b) the single-device step on the card at each setup's depth,
        # its quantized values recorded; each setup replays its block of them
        t_b = time.perf_counter()
        out["b"], out["tapes_equal"] = {}, True
        saved = None
        for depth in sorted({s_[-1] for s_ in SETUPS13}):
            cfg_d, full_d = ((cfg, full) if depth == t["layers"]
                             else _phase13_setup(dev, depth)[::2])
            tape = []
            ref = copy.deepcopy(full_d)
            with pinned_quantizers(tape, replay=False):
                l_ref, g_ref = loss_and_grads(cfg_d, ctx, ref, batch,
                                              t["chunk"])
            g_ref = {n: g.clone() for n, g in g_ref.items()}
            st_ref = opt.init(ref)
            upd, _ = opt.update({n: g.clone() for n, g in g_ref.items()},
                                st_ref, ref)
            p_ref = {n: p + upd[n] for n, p in trainable(ref).items()}
            del ref, st_ref, upd
            digest = hashlib.sha256()
            for v in tape:
                digest.update(v.numpy().tobytes()[:1 << 16])
            digests = [None] * world
            dist.all_gather_object(digests, digest.hexdigest())
            out["tapes_equal"] &= len(set(digests)) == 1
            for name, shape, layout, fsdp, at in SETUPS13:
                if at != depth:
                    continue
                mesh = TrainMesh(shape)
                p, st, z = _sharded_state(mesh, full_d, layout, fsdp, opt)
                step = make_train_step_sharded(
                    cfg_d, ctx, opt, mesh, global_batch=t["batch"],
                    layout=layout, zero1=z, loss_chunk=t["chunk"],
                    return_grads=True)
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with pinned_quantizers(tape, replay=True):
                    p, st, m = step(p, st, batch)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                out["b"][name] = _phase13_judge(
                    mesh, p, m, g_ref, p_ref, l_ref, lr, secs, peak, held)
                if name == "(1, 2) 2d":
                    saved = (mesh, p, st)
                del p, st, m, step
            del tape, g_ref, p_ref, full_d
            torch.cuda.empty_cache()
        out["b_s"] = time.perf_counter() - t_b

        # -- (c) the elastic restore -------------------------------------
        t_c = time.perf_counter()
        ckpt_dir = os.path.join(workdir, "ckpt")
        mesh12, p12, st12 = saved
        sp12 = sharding.tree_specs(p12)
        whole = {"p": {n: mesh12.full_part(v, sp12[n])
                       for n, v in p12.named_buffers()},
                 "m": {n: mesh12.full_part(v, sp12[n])
                       for n, v in st12.m.items()},
                 "v": {n: mesh12.full_part(v, sp12[n])
                       for n, v in st12.v.items()}}

        def shardings(mesh, p):
            parts = sharding.tree_parts(mesh, sharding.tree_specs(p))
            return (parts, AdamWState(step=None, m=parts, v=parts))

        ckpt = CheckpointManager(ckpt_dir)
        ckpt.save(1, (p12, st12), shardings=shardings(mesh12, p12))
        del saved, p12, st12
        mesh21 = TrainMesh((2, 1))
        like, like_st, _ = _sharded_state(mesh21, full, "2d", True, opt)
        rp, rs = ckpt.restore(1, (like, like_st), shardings(mesh21, like))
        sp21 = sharding.tree_specs(rp)

        def equal_to_whole(mesh, p, s, specs):
            return (all(torch.equal(v, mesh.local_part(whole["p"][n],
                                                       specs[n]))
                        for n, v in p.named_buffers())
                    and all(torch.equal(s.m[n], mesh.local_part(
                        whole["m"][n], specs[n])) and torch.equal(
                        s.v[n], mesh.local_part(whole["v"][n], specs[n]))
                        for n in whole["m"]) and int(s.step) == 1)

        out["c_restored_2x1"] = equal_to_whole(mesh21, rp, rs, sp21)
        if rank == 0:
            one_p, one_s = ckpt.restore(1, (full, opt.init(full)))
            out["c_restored_one"] = (
                all(torch.equal(v, whole["p"][n])
                    for n, v in one_p.named_buffers())
                and all(torch.equal(one_s.m[n], whole["m"][n])
                        and torch.equal(one_s.v[n], whole["v"][n])
                        for n in whole["m"]))
            del one_p, one_s
        direct = sharding.map_buffers(
            like, lambda n, v: mesh21.local_part(whole["p"][n],
                                                 sp21[n]).clone())
        dstate = AdamWState(
            step=torch.ones((), dtype=torch.int32, device=dev),
            m={n: mesh21.local_part(v, sp21[n]).clone()
               for n, v in whole["m"].items()},
            v={n: mesh21.local_part(v, sp21[n]).clone()
               for n, v in whole["v"].items()})
        step21 = make_train_step_sharded(cfg, ctx, opt, mesh21,
                                         global_batch=t["batch"],
                                         loss_chunk=t["chunk"])
        b1 = data.batch_at(1)
        a, a_s, a_m = step21(rp, rs, b1)
        b, b_s, b_m = step21(direct, dstate, b1)
        out["c_step_after_restore"] = (
            torch.equal(a_m["loss"], b_m["loss"])
            and all(torch.equal(x, y) for x, y in zip(a.buffers(),
                                                      b.buffers()))
            and all(torch.equal(a_s.m[n], b_s.m[n])
                    and torch.equal(a_s.v[n], b_s.v[n]) for n in a_s.m))
        del a, a_s, b, b_s, rp, rs, like, like_st, direct, dstate, whole
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        out["c_s"] = time.perf_counter() - t_c
        del full
        torch.cuda.empty_cache()

        # -- (d) GPipe: every block in 2 stages, the quantizers pinned ----
        t_d = time.perf_counter()
        pc = PIPE13
        cfg24, ctx24, full24, data24 = _phase13_setup(dev)
        with torch.no_grad():
            x = layers.embed_apply(full24["embed"], data24.batch_at(0)[
                "inputs"]).reshape(pc["micro"], pc["rows"], t["seq"],
                                   cfg24.d_model)
            stages = split_layers_into_stages(full24["layers"], pc["stages"])
            tape, seq = [], []
            for i in range(pc["micro"]):
                h = x[i]
                for s_, blocks in enumerate(stages):
                    with (pinned_quantizers(tape, replay=False)
                          if s_ == rank else contextlib.nullcontext()):
                        h = transformer.apply_blocks(cfg24, blocks, h, ctx24)
                seq.append(h)
            seq = torch.stack(seq)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with pinned_quantizers(tape, replay=True):
                y = pipeline_forward(
                    lambda p, v: transformer.apply_blocks(cfg24, p, v, ctx24),
                    None, stages[rank], x)
            torch.cuda.synchronize()
            out["d_pipeline_s"] = time.perf_counter() - t0
            out["d_err"] = ((y - seq).abs().max() / seq.abs().max()).item()
            out["d_finite"] = bool(torch.isfinite(y).all())
        del tape, full24
        out["d_s"] = time.perf_counter() - t_d
        out["ok"] = True
    finally:
        out["done"] = time.time()
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def phase13(dev, smi):
    """Phase 13: QAT training under a mesh, seed 13, bitnet-0.73b at full
    width, batch 8 x 128, TF32 off, deterministic algorithms.  (a) on the
    NCCL world of one (phase 4f's), 2 layers: ``make_train_step_sharded``
    on a (1, 1) mesh in ``2d``, ``2d`` with FSDP and ``dpzero1``, 2 steps
    each, equal to ``make_train_step`` bit for bit (loss, every parameter,
    m and v).  (b)-(d) on two gloo ranks on the one card (spawned; CUDA
    tensors staged through host memory around each collective): (b) one
    step in each of SETUPS13 (2 layers; FSDP at FSDP13_LAYERS, each block's
    leaves gathered inside its checkpoint region) against the
    single-device step of its depth on the card, whose quantized values
    each rank replays on its blocks: loss within 1e-5 relative, every
    gathered gradient leaf within TRAIN_GRAD_RTOL of its largest, every
    parameter after AdamW within TRAIN_PARAM_LR_BOUND lr; the FSDP step's
    peak above what each rank held before it within PEAK13_RTOL of the
    dry run's estimate of the same step (``_phase13_estimate``); (c) (b)'s (1, 2) state saved (gathered, rank
    0 writing) and restored onto (2, 1) and one device, every leaf equal to
    the saved tree, and a step after the restore on (2, 1) equal to a step
    from the saved tree sharded directly onto (2, 1), bit for bit; (d) all
    24 blocks in 2 pipeline stages, 4 microbatches of 2 x 128, the
    quantizers pinned: the features within 1e-5 of the largest against the
    sequential stack on the card.  The phase within PHASE13_S.  s/step,
    tokens/s and ``max_memory_allocated`` per rank printed, ungated.
    Returns the failures found."""
    import shutil
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.optim import adamw
    from repro_torch.training import (make_train_step,
                                      make_train_step_sharded)
    from repro_torch.runtime.collectives import TrainMesh
    failures = []
    t_13 = time.perf_counter()
    t = TRAIN13
    tokens = t["batch"] * t["seq"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        # -- (a) a (1, 1) mesh on the NCCL world of one ----------------------
        cfg, ctx, full, data = _phase13_setup(dev, t["layers"])
        batches = [data.batch_at(i) for i in range(2)]
        opt = adamw(lr=t["lr"])
        ref = copy.deepcopy(full)
        ref_st = opt.init(ref)
        step = make_train_step(cfg, ctx, opt, loss_chunk=t["chunk"])
        ref_losses = []
        for b in batches:
            ref, ref_st, m = step(ref, ref_st, b)
            ref_losses.append(m["loss"].clone())
        mesh = TrainMesh((1, 1))
        for layout, fsdp in (("2d", False), ("2d", True), ("dpzero1", False)):
            p, st, z = _sharded_state(mesh, full, layout, fsdp, opt)
            sstep = make_train_step_sharded(
                cfg, ctx, opt, mesh, global_batch=t["batch"], layout=layout,
                zero1=z, loss_chunk=t["chunk"])
            torch.cuda.reset_peak_memory_stats()
            same, secs = True, []
            for b, want in zip(batches, ref_losses):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, st, m = sstep(p, st, b)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                same &= torch.equal(m["loss"], want)
            same &= all(torch.equal(x, y) for x, y in zip(
                ref.buffers(), p.buffers()))
            same &= all(torch.equal(ref_st.m[n], st.m[n])
                        and torch.equal(ref_st.v[n], st.v[n])
                        for n in ref_st.m)
            label = layout + (" fsdp" if fsdp else "")
            log(f"  (a) (1, 1) mesh, {dist.get_backend()} world of "
                f"{dist.get_world_size()}, bitnet-0.73b {t['layers']} layers"
                f", {label}: 2 steps == make_train_step bit for bit (loss, "
                f"parameters, m, v): {same}; s/step "
                f"{[round(x, 4) for x in secs]} (the second: "
                f"{tokens / secs[-1]:.1f} tokens/s); max_memory_allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {smi}")
            if not same:
                failures.append(f"(a) {label}: the (1, 1) mesh step differs "
                                "from make_train_step")
            del p, st, sstep
        del ref, ref_st, full, step
        torch.cuda.empty_cache()
        t_a = time.perf_counter() - t_13
    finally:
        torch.use_deterministic_algorithms(False)

    # -- (b)-(d): two gloo ranks on the one card -----------------------------
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase13")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t_r = time.perf_counter()
    spawned = time.time()
    procs = mp.spawn(_phase13_rank, args=(2, _free_port(), workdir),
                     nprocs=2, join=False)
    deadline = time.perf_counter() + PHASE13_RANK_S + 60
    try:
        while not procs.join(timeout=2):
            if time.perf_counter() > deadline:
                raise TimeoutError("phase 13's ranks did not finish")
    except Exception as e:   # a rank that fails fails the phase
        failures.append(f"(b)-(d) ranks: {type(e).__name__}: "
                        f"{str(e)[-2000:]}")
    finally:
        for p_ in procs.processes:
            if p_.is_alive():
                p_.kill()
            p_.join()
    joined = time.time()
    ranks = []
    for r in range(2):
        path = os.path.join(workdir, f"rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else {})
    shutil.rmtree(workdir, ignore_errors=True)
    t_ranks = time.perf_counter() - t_r
    if all("ready" in r for r in ranks):   # where the ranks' time goes
        log(f"  the ranks: spawn to entry "
            f"{[round(r['entered'] - spawned, 1) for r in ranks]} s, entry "
            f"to (b) {[round(r['ready'] - r['entered'], 1) for r in ranks]}"
            f" s, (b) to done "
            f"{[round(r['done'] - r['ready'], 1) for r in ranks]} s, done "
            f"to joined {[round(joined - r['done'], 1) for r in ranks]} s")
    if not all(r.get("ok") for r in ranks):
        failures.append(f"(b)-(d): a rank did not finish: {ranks}")
    else:
        lr = t["lr"]
        for name, *_, layers in SETUPS13:
            rows = [r["b"][name] for r in ranks]
            b0 = rows[0]
            log(f"  (b) {name}, {layers} layers, 2 gloo ranks on the card, "
                f"one step against "
                f"the single-device step (its quantized values replayed on "
                f"each rank's blocks): loss {b0['loss']:.7f} vs "
                f"{b0['loss_ref']:.7f} (rel {b0['loss_rel']:.3g}, gate 1e-5);"
                f" worst gradient leaf {b0['grad_worst']:.3g} "
                f"({b0['grad_worst_leaf']}, gate {TRAIN_GRAD_RTOL}); "
                f"parameters after AdamW within "
                f"{max(r['param_err_lr'] for r in rows):.3f} lr (gate "
                f"{TRAIN_PARAM_LR_BOUND}); s/step per rank "
                f"{[round(r['s_step'], 4) for r in rows]}, tokens/s "
                f"{[round(r['tokens_s'], 1) for r in rows]}, "
                f"max_memory_allocated per rank "
                f"{[round(r['peak_gib'], 3) for r in rows]} GiB, above what "
                f"the rank held before the step "
                f"{[r['above'] for r in rows]} B; {smi}")
            for r in rows:
                if not (r["loss_rel"] <= 1e-5
                        and r["grad_worst"] <= TRAIN_GRAD_RTOL
                        and r["param_err_lr"] <= TRAIN_PARAM_LR_BOUND):
                    failures.append(f"(b) {name}: {r}")
        # the FSDP step's peak against the dry run's estimate of it
        t_e = time.perf_counter()
        est, block = _phase13_estimate(FSDP13_LAYERS)
        above = [r["b"]["(2, 1) 2d fsdp"]["above"] for r in ranks]
        rel = [(est - a) / a for a in above]
        log(f"  (b) (2, 1) 2d fsdp, {FSDP13_LAYERS} layers: each rank's peak "
            f"above its arguments {above} B against the dry run's estimate "
            f"{est} B (rel {[round(x, 4) for x in rel]}, gate "
            f"{PEAK13_RTOL}); the whole tree gathered for the step would "
            f"add {FSDP13_LAYERS} blocks x {block / 1e6:.1f} MB and their "
            f"f32 gradients, {2 * FSDP13_LAYERS * block / 2**30:.3f} GiB; "
            f"estimate {time.perf_counter() - t_e:.1f} s")
        if not all(abs(x) <= PEAK13_RTOL for x in rel):
            failures.append(f"(b) FSDP peak {above} vs the dry run's {est}")
        log(f"  (b) the ranks' recorded quantized values equal: "
            f"{[r['tapes_equal'] for r in ranks]}; (b) took "
            f"{[round(r['b_s'], 1) for r in ranks]} s")
        c_ok = (all(r["c_restored_2x1"] and r["c_step_after_restore"]
                    for r in ranks) and ranks[0]["c_restored_one"])
        log(f"  (c) (1, 2)'s state saved and restored: onto (2, 1) "
            f"{[r['c_restored_2x1'] for r in ranks]}, onto one device "
            f"{ranks[0]['c_restored_one']}, bit for bit; a step after the "
            f"restore == a step from the saved tree sharded onto (2, 1), bit "
            f"for bit: {[r['c_step_after_restore'] for r in ranks]}; "
            f"{[round(r['c_s'], 1) for r in ranks]} s")
        if not c_ok:
            failures.append(f"(c) elastic restore: {ranks}")
        d_err = max(r["d_err"] for r in ranks)
        log(f"  (d) GPipe, bitnet-0.73b's 24 blocks in {PIPE13['stages']} "
            f"stages over the 2 ranks, {PIPE13['micro']} microbatches of "
            f"{PIPE13['rows']} x {t['seq']}, quantizers pinned: features vs "
            f"the sequential stack on the card {d_err:.3g} of the largest "
            f"(gate 1e-5); pipeline forward "
            f"{[round(r['d_pipeline_s'], 3) for r in ranks]} s; "
            f"{[round(r['d_s'], 1) for r in ranks]} s")
        if not (d_err <= 1e-5 and all(r["d_finite"] for r in ranks)
                and all(r["tapes_equal"] for r in ranks)):
            failures.append(f"(d) GPipe: {d_err}, finite "
                            f"{[r['d_finite'] for r in ranks]}")
    took = time.perf_counter() - t_13
    log(f"phase 13: {took:.1f} s ((a) {t_a:.1f} s, the ranks {t_ranks:.1f}"
        f" s)")
    if took > PHASE13_S:
        failures.append(f"phase 13 took {took:.1f} s (gate {PHASE13_S} s)")
    return failures


PHASE14_S = 200
# (a): mixtral-8x22b's first 2 layers served on a (2, 1) gloo mesh of two
# ranks on the one card against the single-device engine
SERVE14 = dict(layers=2, seed=14)
# (b): (model, layers, mesh, batch rows): one step on the mesh against the
# single-device step, every quantized value (weights by their gammas) and
# MoE routing replayed; mixtral's batch is the first of 16 data seeds from
# 14 whose single-device routing drops a pair at capacity factor 1.25
# hymba's 25 heads on 2 ranks: "model" does not divide them, the mixer
# runs whole on each rank (the same single-device step judges both);
# mixtral cut to 3 experts, which 2 ranks do not divide: each bank split
# inside each expert, every rank computing every expert on its columns
TRAIN14 = (("mixtral-8x22b", 1, (1, 2), 1), ("xlstm-350m", 4, (1, 2), 8),
           ("hymba-1.5b", 4, (1, 2), 8), ("hymba-1.5b", 4, (1, 5), 8),
           ("mixtral-8x22b 3 experts", 1, (1, 2), 1))
T14 = dict(seq=128, lr=3e-4, chunk=128, seed=14)
PHASE14_RANK_S = 150


def _config14(name, layers):
    """TRAIN14's config of ``name`` at full width, ``layers`` deep (an
    "<arch> <E> experts" name cuts its experts to E)."""
    from repro_torch.configs import get_config
    arch, *cut = name.split(" ")
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    return dataclasses.replace(cfg, n_experts=int(cut[0])) if cut else cfg


def _phase14_train_setup(dev, name, layers, batch, data_seed):
    """A full-width config ``layers`` deep, its training context, masters
    from seed 14 and the batch of ``data_seed``."""
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    cfg = _config14(name, layers)
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=T14["seq"],
              attn_kv_chunk=T14["seq"])
    full = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(T14["seed"]))
    data = SyntheticLMDataset(cfg, batch=batch, seq_len=T14["seq"],
                              seed=data_seed, device=dev)
    return cfg, ctx, full, data.batch_at(0)


def _moe_drops(fn):
    """(fn's result, the (token, slot) pairs its MoE routings dropped)."""
    from repro_torch.models import layers
    orig, dropped = layers.moe_route, [0]

    def route(*a, **kw):
        r = orig(*a, **kw)
        dropped[0] += int((~r["keep"]).sum())
        return r
    layers.moe_route = route
    try:
        return fn(), dropped[0]
    finally:
        layers.moe_route = orig


def _phase14_serve(dev, cfg, packed, prompts, news, mesh=None,
                   pins=None):
    """The 8 requests on a mixtral engine (phase 4's shape) after a
    one-request warm-up: (tokens, stats, peak).  Device-resident, or,
    given ``pins`` (the engine -> a context entered around the 8
    requests), host-driven under it."""
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(cfg, packed, max_seq=256, batch_slots=4,
                        prefill_chunk=32, decode_block=8, mesh=mesh,
                        device_sched=pins is None)

    def reqs():
        return [Request(prompt=np.asarray(p), max_new_tokens=n)
                for p, n in zip(prompts, news)]
    eng.run(reqs()[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = reqs()
    with contextlib.nullcontext() if pins is None else pins(eng):
        out = eng.run(run)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    s = {k: eng.stats[k] for k in ("tokens_per_s", "decode_tok_s",
                                   "ttft_p50_s", "ttft_p95_s",
                                   "total_new_tokens", "wall_s")}
    s["graph_captures"] = eng.lifetime["graph_captures"]
    del eng
    return [r.output.tolist() for r in out], s, peak


def _lane_pins(eng, tape, moved):
    """The pins of a (2, 1) mesh engine's rank replaying one device's
    ``tape`` (``_phase16_pins``, each code and route held to its own) on
    its lanes: a token-major value's rows are its lanes' (slot-major: a
    prefill wave's chunks, a decode tick's tokens), an expert buffer's
    rows its tokens' pairs, each at its position in this rank's buffer
    (the engine routes a data shard's rows alone) taken from its position
    in one device's, found from the recorded experts of that routing."""
    from repro_torch.models import layers
    slots, lo, n = eng.slots, eng._lo, eng.slots_per_device
    whole = iter(tape["routes"])
    cur = {}

    def lanes(t):
        t = t.reshape((slots, -1) + t.shape[1:])[lo:lo + n]
        return t.reshape((-1,) + t.shape[2:])

    def rows(t):
        if t.dim() != 3:
            return lanes(t)
        idx = cur["idx"]
        per = idx.shape[0] // slots   # a lane's tokens
        one = layers.route_positions(idx.reshape(-1), cur["experts"])
        span = slice(lo * per * idx.shape[1], (lo + n) * per * idx.shape[1])
        mine = idx.reshape(-1)[span]
        pos = layers.route_positions(mine, cur["experts"])
        keep = (pos < cur["cap"]) & (one[span] < t.shape[1])
        out = t.new_zeros((t.shape[0], cur["cap"]) + t.shape[2:])
        out[mine[keep], pos[keep]] = t[mine[keep], one[span][keep]]
        return out

    stack = _phase16_pins(tape, True, rows, moved)
    route = layers.moe_route

    def routed(p, x, **kw):
        cur["idx"] = next(whole)
        r = route(p, x, **kw)
        cur.update(experts=p.n_experts, cap=int(r["capacity"]))
        return r
    layers.moe_route = routed
    stack.callback(setattr, layers, "moe_route", route)
    return stack


def _phase14_rank(rank, world, port, workdir, device="cuda"):
    """One of phase 14's gloo ranks on the one card.  A world of 2: (a)'s
    mesh engines, then (b)'s (1, 2) steps; a world of 5: (b)'s hymba step.
    Writes its readings to ``workdir/rank{world}_{rank}.json``."""
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWState, trainable
    from repro_torch.runtime import sharding
    from repro_torch.runtime.collectives import TrainMesh
    from repro_torch.testing import pinned_quantizers, pinned_routing
    from repro_torch.training import make_train_step_sharded
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    dev = torch.device(device, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {"rank": rank, "b": {}}
    try:
        if world == 2:   # -- (a) the mesh engines ---------------------------
            t0 = time.perf_counter()
            plan = json.load(open(os.path.join(workdir, "serve.json")))
            mcfg = dataclasses.replace(get_config("mixtral-8x22b"),
                                       n_layers=SERVE14["layers"])
            packed = transformer.init_packed_params(
                mcfg, torch.Generator(device=dev).manual_seed(
                    SERVE14["seed"]))
            mesh = DeviceMesh(device, torch.arange(2).reshape(2, 1),
                              mesh_dim_names=("data", "model"))
            out["a"] = {}
            for label, cf in (("drop-free", float(mcfg.n_experts)),
                              ("cf 1.25", mcfg.capacity_factor)):
                toks, s, peak = _phase14_serve(
                    dev, dataclasses.replace(mcfg, capacity_factor=cf),
                    packed, plan["prompts"], plan["news"], mesh)
                out["a"][label] = dict(tokens=toks, stats=s,
                                       peak_gib=peak / 2**30)
            # the drop-free engine host-driven, replaying one device's int8
            # values and routing on this rank's lanes
            t_p = time.perf_counter()
            tape = torch.load(os.path.join(workdir, "replay.pt"), mmap=True)
            moved = {"int8": [], "routes": []}
            toks, _, _ = _phase14_serve(
                dev, dataclasses.replace(mcfg, capacity_factor=float(
                    mcfg.n_experts)), packed, plan["prompts"], plan["news"],
                mesh, pins=lambda eng: _lane_pins(eng, tape, moved))
            out["replay"] = dict(tokens=toks, moved=_moved_line(moved),
                                 s=time.perf_counter() - t_p)
            del tape
            del packed
            torch.cuda.empty_cache()
            out["a_s"] = time.perf_counter() - t0
        for name, layers, shape, rows in TRAIN14:   # -- (b) -----------------
            if math.prod(shape) != world:
                continue
            path = os.path.join(workdir, f"{name}.pt")
            if not os.path.exists(path):
                continue
            t0 = time.perf_counter()
            ref = torch.load(path, mmap=True, weights_only=True)
            cfg, ctx, full, batch = _phase14_train_setup(
                dev, name, layers, rows, int(ref["data_seed"]))
            mesh = TrainMesh(shape)
            p = sharding.shard_params(mesh, full, fsdp=False)
            del full
            torch.cuda.empty_cache()
            before = {n: t.cpu() for n, t in trainable(p).items()}
            opt = adamw(lr=T14["lr"])
            st = opt.init(p)
            step = make_train_step_sharded(
                cfg, ctx, opt, mesh, global_batch=rows,
                loss_chunk=T14["chunk"], return_grads=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_s = time.perf_counter()
            with pinned_quantizers(list(ref["tape"]), True, gammas=True), \
                    (pinned_routing(list(ref["routes"]), True)
                     if cfg.n_experts else contextlib.nullcontext()):
                p, st, m = step(p, st, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t_s
            peak = torch.cuda.max_memory_allocated()
            del st   # the moments: room for the comparison's blocks
            torch.cuda.empty_cache()
            specs = sharding.tree_specs(p)
            grad_err, param_err = {}, 0.0
            sq = ref["sq"].to(dev)
            for n, t in trainable(p).items():
                g_ref = mesh.local_part(ref["g"][n], specs[n]).to(dev)
                grad_err[n] = ((m["grads"][n] - g_ref).abs().max()
                               / ref["gmax"][n]).item()
                # the single-device AdamW's update of this block: the whole
                # gradient's clip scale (its sum of squares), fresh moments
                zeros = torch.zeros_like(g_ref)
                upd, _ = opt.update(
                    {n: g_ref}, AdamWState(
                        step=torch.zeros((), dtype=torch.int32, device=dev),
                        m={n: zeros}, v={n: zeros.clone()}),
                    {n: before[n].to(dev)}, sq_sum=lambda g, sq=sq: sq)
                param_err = max(param_err, (t - before[n].to(dev) - upd[n]
                                            ).abs().max().item())
            worst = max(grad_err, key=grad_err.get)
            loss = float(m["loss"])
            out["b"][name] = dict(
                loss=loss, loss_ref=float(ref["loss"]),
                loss_rel=abs(loss - float(ref["loss"])) / abs(
                    float(ref["loss"])),
                grad_worst=grad_err[worst], grad_worst_leaf=worst,
                param_err_lr=param_err / T14["lr"], s_step=secs,
                tokens_s=rows * T14["seq"] / secs, peak_gib=peak / 2**30,
                s=time.perf_counter() - t0)
            del p, m, step, ref, before
            torch.cuda.empty_cache()
        out["ok"] = True
    finally:
        with open(os.path.join(workdir, f"rank{world}_{rank}.json"),
                  "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def _spawn14(world, workdir, deadline_s):
    """Phase 14's ranks in a world of ``world``: their readings, and the
    failure of a rank that did not finish."""
    import torch.multiprocessing as mp
    procs = mp.spawn(_phase14_rank, args=(world, _free_port(), workdir),
                     nprocs=world, join=False)
    deadline = time.perf_counter() + deadline_s
    failure = None
    try:
        while not procs.join(timeout=2):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"phase 14's {world} ranks did not finish")
    except Exception as e:   # a rank that fails fails the phase
        failure = f"{world} ranks: {type(e).__name__}: {str(e)[-2000:]}"
    finally:
        for p_ in procs.processes:
            if p_.is_alive():
                p_.kill()
            p_.join()
    ranks = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{world}_{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else {})
    if failure is None and not all(r.get("ok") for r in ranks):
        failure = f"{world} ranks: a rank did not finish: {ranks}"
    return ranks, failure


def phase14(dev, requests, smi):
    """Phase 14: MoE, hymba and xLSTM on a mesh, full width, seed 14, on
    gloo ranks on the one card (each collective staged through host
    memory).  (a) mixtral-8x22b, 2 layers, served device-resident on a
    (2, 1) mesh engine (each rank its data shard's two slots, a captured
    decode block a rank, the block's gather after it) against the
    single-device engine on phase 4's 8 requests (bf16 cache): drop-free,
    equal tokens, a request that differs passing only at a router near-tie
    at its first differing position (phase 9's rule, at most 2); at
    capacity factor 1.25 each rank counts its shard's rows (JAX's
    ``shard_map`` engine), so the differing tokens are printed, as phase 9
    prints its modes'; the drop-free engines again host-driven, each rank
    replaying one device's int8 values and routing on its lanes
    (``_lane_pins``, every code and route held to its own), its tokens
    equal to one device's.  (b) one QAT step of each of TRAIN14 on its mesh
    (``2d``) against the single-device step on the card, whose quantized
    activations, weight gammas and MoE routing each rank replays on its
    blocks: loss within 1e-5 relative, every gradient leaf within
    TRAIN_GRAD_RTOL of its largest, every parameter after AdamW within
    TRAIN_PARAM_LR_BOUND lr of the single-device AdamW's; hymba runs on
    (1, 2) (its mixer whole on each rank) and on (1, 5); mixtral also with
    3 experts on (1, 2) (each bank split inside each expert: every rank
    computes every expert on its columns, no rank holds a whole bank),
    its batch the first of 16 data seeds that drops a pair, else seed 14.  The single-device
    runs go first and alone (mixtral's step alone holds ~35 GB); what the
    ranks are compared with goes through ``build/phase14``.  The phase
    within PHASE14_S.  Returns the failures found."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.testing import pinned_quantizers, pinned_routing
    from repro_torch.training import loss_and_grads
    failures = []
    t_14 = time.perf_counter()
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase14")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    torch.cuda.empty_cache()
    # -- (a) the single-device engines --------------------------------------
    reqs = requests()
    plan = dict(prompts=[r.prompt.tolist() for r in reqs],
                news=[r.max_new_tokens for r in reqs])
    json.dump(plan, open(os.path.join(workdir, "serve.json"), "w"))
    mcfg = dataclasses.replace(get_config("mixtral-8x22b"),
                               n_layers=SERVE14["layers"])
    mpacked = transformer.init_packed_params(
        mcfg, torch.Generator(device=dev).manual_seed(SERVE14["seed"]))
    single = {}
    for label, cf in (("drop-free", float(mcfg.n_experts)),
                      ("cf 1.25", mcfg.capacity_factor)):
        toks, s, peak = _phase14_serve(
            dev, dataclasses.replace(mcfg, capacity_factor=cf), mpacked,
            plan["prompts"], plan["news"])
        single[label] = dict(tokens=toks, stats=s, peak_gib=peak / 2**30)
    # the drop-free engine host-driven, its int8 values and routing
    # recorded for the mesh's ranks to replay
    t_p = time.perf_counter()
    tape = {"int8": [], "routes": []}
    replayed, _, _ = _phase14_serve(
        dev, dataclasses.replace(mcfg, capacity_factor=float(
            mcfg.n_experts)), mpacked, plan["prompts"], plan["news"],
        pins=lambda eng: _phase16_pins(tape, False))
    torch.save(tape, os.path.join(workdir, "replay.pt"))
    tape_mib = sum(t.numel() * t.element_size() for q in tape["int8"]
                   for t in q) / 2**20
    del tape
    t_p = time.perf_counter() - t_p
    del mpacked
    torch.cuda.empty_cache()
    t_a1 = time.perf_counter() - t_14
    # -- (b) the single-device steps, one model at a time -------------------
    refs = {}
    for name, layers, shape, rows in TRAIN14:
        if name in refs:   # one single-device step judges every mesh
            continue
        t0 = time.perf_counter()
        moe = bool(_config14(name, layers).n_experts)
        data_seed = T14["seed"]
        if moe:   # the first batch whose routing drops a pair at 1.25
            for data_seed in range(T14["seed"], T14["seed"] + 16):
                cfg, ctx, full, batch = _phase14_train_setup(
                    dev, name, layers, rows, data_seed)
                with torch.no_grad():
                    _, drops = _moe_drops(lambda: transformer.forward_features(
                        cfg, full, batch["inputs"], ctx))
                if drops:
                    break
                del full
            if not drops and name == "mixtral-8x22b":
                failures.append(f"(b) {name}: no batch of 16 data seeds "
                                "drops a pair at capacity factor 1.25")
                continue
            if not drops:   # the split banks judged on a batch dropping none
                data_seed = T14["seed"]
                cfg, ctx, full, batch = _phase14_train_setup(
                    dev, name, layers, rows, data_seed)
        else:
            cfg, ctx, full, batch = _phase14_train_setup(dev, name, layers,
                                                         rows, data_seed)
        tape, routes = [], []
        with pinned_quantizers(tape, False, gammas=True), \
                (pinned_routing(routes, False) if moe
                 else contextlib.nullcontext()):
            (loss, grads), drops = _moe_drops(lambda: loss_and_grads(
                cfg, ctx, full, batch, T14["chunk"]))
        sq = sum(g.float().square().sum() for g in grads.values())
        peak = torch.cuda.max_memory_allocated()
        torch.save(dict(tape=tape, routes=routes, loss=loss.cpu(),
                        sq=sq.cpu(), data_seed=data_seed,
                        g={n: g.cpu() for n, g in grads.items()},
                        gmax={n: g.abs().max().item()
                              for n, g in grads.items()}),
                   os.path.join(workdir, f"{name}.pt"))
        refs[name] = dict(drops=drops, data_seed=data_seed,
                          tape_mb=sum(t.numel() * t.element_size()
                                      for t in tape) / 2**20,
                          s=time.perf_counter() - t0)
        log(f"  (b) {name} {layers} layers, batch {rows} x {T14['seq']} "
            f"(data seed {data_seed}): the single-device step on the card, "
            f"loss {float(loss):.7f}, (token, slot) pairs dropped {drops}, "
            f"tape {refs[name]['tape_mb']:.1f} MiB; "
            f"{refs[name]['s']:.1f} s")
        del full, grads, tape, routes, batch
        torch.cuda.empty_cache()
    t_b1 = time.perf_counter() - t_14 - t_a1
    # -- the ranks ------------------------------------------------------------
    t_r = time.perf_counter()
    ranks2, fail2 = _spawn14(2, workdir, PHASE14_RANK_S)
    ranks5, fail5 = _spawn14(5, workdir, PHASE14_RANK_S)
    failures += [f for f in (fail2, fail5) if f]
    t_ranks = time.perf_counter() - t_r
    # -- (a) judged ---------------------------------------------------------
    if ranks2 and "a" in ranks2[0]:
        mesh_a = ranks2[0]["a"]
        for label in ("drop-free", "cf 1.25"):
            one, two = single[label], mesh_a[label]
            differ = [i for i, (x, y) in enumerate(zip(one["tokens"],
                                                       two["tokens"]))
                      if x != y]
            for who, run in (("one device", one), ("(2, 1) mesh, rank 0",
                                                  two)):
                s = run["stats"]
                log(f"  (a) mixtral-8x22b {SERVE14['layers']} layers, "
                    f"{label}, {who}, device-resident: "
                    f"{s['total_new_tokens']} tokens, {s['tokens_per_s']:.1f}"
                    f" tok/s, decode {s['decode_tok_s']:.1f} tok/s, TTFT p50 "
                    f"{s['ttft_p50_s']:.4f} s p95 {s['ttft_p95_s']:.4f} s, "
                    f"graph captures {s['graph_captures']}, "
                    f"max_memory_allocated {run['peak_gib']:.3f} GiB; {smi}")
            log(f"  (a) {label}: requests whose tokens differ between the "
                f"mesh and one device: {differ}")
            if label == "cf 1.25":
                continue   # each shard's capacity is its own: printed
            if [r.get("a", {}).get(label, {}).get("tokens") for r in ranks2
                    ] != [two["tokens"]] * 2:
                failures.append("(a) the two ranks read different tokens")
            # every mesh token judged as phase 9 judges its bf16 engine: by
            # the chunked bf16 oracle, a request past the gap passing only
            # at a router near-tie at its first diverging position
            mfree = dataclasses.replace(mcfg, capacity_factor=float(
                mcfg.n_experts))
            mpacked = transformer.init_packed_params(
                mcfg, torch.Generator(device=dev).manual_seed(
                    SERVE14["seed"]))
            from repro_torch.serving import Request
            near_tie, worst = 0, []
            for i, toks in enumerate(two["tokens"]):
                r = Request(prompt=np.asarray(plan["prompts"][i]),
                            max_new_tokens=plan["news"][i])
                r.output = np.asarray(toks)
                gaps, margins = chunked_oracle(mfree, mpacked, r,
                                               torch.bfloat16, dev, 256)
                worst.append(round(max(gaps), 5))
                if max(gaps) > TOKEN_GAP:
                    j = next(j for j, g in enumerate(gaps) if g > 0)
                    log(f"  (a) mesh request {i}: first diverging position "
                        f"{j}, gap there {gaps[j]:.5f}, least router margin "
                        f"there {margins[j]:.3g}")
                    if margins[j] >= ROUTER_NEAR_TIE:
                        failures.append(f"(a) drop-free mesh request {i} off "
                                        f"the chunked oracle by {max(gaps)} "
                                        "with no router near-tie")
                    else:
                        near_tie += 1
            log(f"  (a) drop-free mesh tokens vs the chunked bf16 oracle: "
                f"largest gap per request {worst} (limit {TOKEN_GAP}); "
                f"passed at a router near-tie: {near_tie} (at most 2)")
            if near_tie > 2:
                failures.append(f"(a) {near_tie} requests passed only at "
                                "router near-ties")
            del mpacked
            torch.cuda.empty_cache()
    # -- (a) the drop-free replay: one device's int8 values and routing on
    # each rank's lanes, every code and route held to the rank's own -------
    if ranks2 and all("replay" in r for r in ranks2):
        for r_, rk in enumerate(ranks2):
            rp = rk["replay"]
            differ = [i for i, (x, y) in enumerate(zip(replayed,
                                                       rp["tokens"]))
                      if x != y]
            log(f"  (a) drop-free, host-driven, (2, 1) mesh rank {r_} "
                f"replaying one device's int8 values and routing on its "
                f"lanes (tape {tape_mib:.1f} MiB; {t_p:.1f} s on one device,"
                f" {rp['s']:.1f} s on the rank): requests whose tokens "
                f"differ from one device's {differ} (gate: none); "
                f"{rp['moved']}")
            if differ or len(rp["tokens"]) != len(replayed):
                failures.append(f"(a) replayed mesh rank {r_}: requests "
                                f"{differ} differ from one device's")
    else:
        failures.append("(a) no replayed drop-free mesh reading")
    # -- (b) judged ---------------------------------------------------------
    for ranks in (ranks2, ranks5):
        for name, layers, shape, rows in TRAIN14:
            got = [r.get("b", {}).get(name) for r in ranks]
            if math.prod(shape) != len(ranks) or name not in refs:
                continue
            if not all(got):
                failures.append(f"(b) {name}: no reading from every rank")
                continue
            b0 = got[0]
            log(f"  (b) {name} {layers} layers on {shape} 2d, {len(ranks)} "
                f"gloo ranks on the card, one step against the "
                f"single-device step (its quantized values, gammas"
                f"{' and routing' if refs[name]['drops'] else ''} replayed; "
                f"{refs[name]['drops']} pairs dropped): loss "
                f"{b0['loss']:.7f} vs {b0['loss_ref']:.7f} (rel "
                f"{b0['loss_rel']:.3g}, gate 1e-5); worst gradient leaf "
                f"{max(r['grad_worst'] for r in got):.3g} "
                f"({b0['grad_worst_leaf']}, gate {TRAIN_GRAD_RTOL}); "
                f"parameters after AdamW within "
                f"{max(r['param_err_lr'] for r in got):.3f} lr (gate "
                f"{TRAIN_PARAM_LR_BOUND}); s/step per rank "
                f"{[round(r['s_step'], 4) for r in got]}, tokens/s "
                f"{[round(r['tokens_s'], 1) for r in got]}, "
                f"max_memory_allocated per rank "
                f"{[round(r['peak_gib'], 3) for r in got]} GiB; "
                f"{[round(r['s'], 1) for r in got]} s; {smi}")
            for r in got:
                if not (r["loss_rel"] <= 1e-5
                        and r["grad_worst"] <= TRAIN_GRAD_RTOL
                        and r["param_err_lr"] <= TRAIN_PARAM_LR_BOUND):
                    failures.append(f"(b) {name}: {r}")
    shutil.rmtree(workdir, ignore_errors=True)
    took = time.perf_counter() - t_14
    log(f"phase 14: {took:.1f} s ((a) one device {t_a1:.1f} s, (b) one "
        f"device {t_b1:.1f} s, the ranks {t_ranks:.1f} s: "
        f"{[round(r.get('a_s', 0), 1) for r in ranks2]} s of (a))")
    if took > PHASE14_S:
        failures.append(f"phase 14 took {took:.1f} s (gate {PHASE14_S} s)")
    return failures


PHASE15_S = 90
# (a): the serve launcher's flags; (b): the dry run's cell on the card
SERVE15 = ["--full", "--n-requests", "8", "--max-new", "16"]
CELL15 = dict(arch="bitnet-0.73b", seq=128, batch=8, seed=15)
PEAK15_RTOL = 0.2
# The caching allocator rounds a request up to 512 B; a request past 1 MiB
# may take a cached free block whole when splitting it would leave no more
# than 1 MiB, so its block exceeds it by up to that.
ALLOC_BLOCK15 = 512
ALLOC_SMALL15 = 1 << 20


def _active_blocks() -> dict:
    """{address: size} of the caching allocator's live blocks."""
    return {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] == "active_allocated"}


def phase15(dev, smi):
    """Phase 15: the launchers on the card.  (a) ``launch.serve.main``
    with SERVE15: bitnet-0.73b at full width and depth, 8 requests of
    prompt lengths and tokens drawn as the JAX launcher draws them, every
    request OK with 16 tokens in the vocabulary, requests 0 and 1 judged by
    the packed-weight oracle on the engine's history (TOKEN_GAP), the
    engine's admission (flash_chunk_prefill) and decode
    (decode_attention) kernels and the oracle's prompt kernel
    (flash_prefill) launched; tok/s and TTFT p50/p90.  (b)
    ``launch.dryrun.build_cell`` of a "card" training cell (CELL15:
    ``ShapeConfig("card", 128, 8, "train")``) on a (1, 1) mesh, estimated
    on ``meta`` tensors (``dryrun.estimate``), then built on the card and
    its step run once: ``argument_bytes`` equal to the card's bytes of the
    same tensors, and the allocator's blocks made by the build exactly the
    arguments' storages, summing to what ``memory_allocated`` says the
    build holds, each its storage rounded up to ALLOC_BLOCK15 (plus at
    most ALLOC_SMALL15 for a storage past that); ``peak_bytes_est`` within PEAK15_RTOL of the step's
    ``max_memory_allocated`` (less what the card held before the cell was
    built), and the estimate's FLOPs equal to ``FlopCounterMode`` on the
    card's step.  The phase within PHASE15_S.  Returns (the kernels'
    launches in the phase, the failures found)."""
    import io
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    from repro_torch.serving import RequestStatus
    from repro_torch.serving.engine import reference_decode
    failures = []
    t_15 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    # -- (a) the serve launcher ----------------------------------------------
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        reqs = serve.main(SERVE15)
    t_serve = time.perf_counter() - t0
    serve_counts = kernels.launch_counts()
    for line in out.getvalue().splitlines():
        log(f"  (a) launch.serve: {line}")
    cfg = get_config("bitnet-0.73b")
    toks = [r.output.tolist() for r in reqs]
    ttft = [r.ttft_s for r in reqs]
    log(f"  (a) {len(reqs)} requests, prompt lengths "
        f"{[len(r.prompt) for r in reqs]}, tokens {toks}; TTFT p50 "
        f"{np.percentile(ttft, 50):.4f} s p90 {np.percentile(ttft, 90):.4f} "
        f"s; launcher call {t_serve:.1f} s (init, packing and serving); "
        f"launches {serve_counts}; {smi}")
    if not (len(reqs) == 8 and all(
            r.status == RequestStatus.OK and len(t) == 16
            and all(0 <= x < cfg.vocab_size for x in t)
            for r, t in zip(reqs, toks))):
        failures.append("(a) not every request OK with 16 tokens in the "
                        "vocabulary")
    packed = transformer.init_packed_params(
        cfg, torch.Generator(device=dev).manual_seed(0))   # the launcher's
    gaps = [max(reference_decode(cfg, packed, Ctx(), r.prompt, 16, 32 + 16,
                                 torch.bfloat16, follow=r.output)[1])
            for r in reqs[:2]]
    del packed
    torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    log(f"  (a) requests 0 and 1 against the packed oracle on their "
        f"history: largest gap {[round(g, 5) for g in gaps]} (limit "
        f"{TOKEN_GAP})")
    if max(gaps) > TOKEN_GAP:
        failures.append(f"(a) oracle gaps {gaps}")
    for name, n in (("flash_chunk_prefill", serve_counts),
                    ("decode_attention", serve_counts),
                    ("flash_prefill", counts)):
        if n.get(name, 0) <= 0:
            failures.append(f"(a) {name} did not launch")
    t_a = time.perf_counter() - t_15
    # -- (b) the dry run's cell, estimated, then run on the card ------------
    mesh = make_host_mesh(dev)
    shape = ShapeConfig("card", CELL15["seq"], CELL15["batch"], "train")
    t0 = time.perf_counter()
    est = dryrun.estimate(dryrun.build_cell(CELL15["arch"], shape, mesh))
    t_meta = time.perf_counter() - t0
    gc.collect()   # (a)'s engine gone before the reading starts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = _active_blocks()
    base = torch.cuda.memory_allocated()
    cell = dryrun.build_cell(CELL15["arch"], shape, mesh, device=dev,
                             seed=CELL15["seed"])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    # the allocator's blocks the build made, against the arguments' storages
    made = {a: n for a, n in _active_blocks().items() if a not in before}
    sizes = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
             for t in dryrun._flat(cell.args)}
    slack = {a: made.get(a, -1) - -(-n // ALLOC_BLOCK15) * ALLOC_BLOCK15
             for a, n in sizes.items()}
    blocks_ok = (made.keys() == sizes.keys()
                 and sum(made.values()) == held
                 and all(0 <= slack[a] <= (ALLOC_SMALL15 if n > ALLOC_SMALL15
                                           else 0)
                         for a, n in sizes.items()))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        _, _, metrics = cell.fn(*cell.args)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    flops = fc.get_total_flops()
    loss = float(metrics["loss"])
    mem = est["memory"]
    rel = (mem["peak_bytes_est"] - peak) / peak
    log(f"  (b) dry run cell {CELL15['arch']} train {CELL15['batch']} x "
        f"{CELL15['seq']} on a (1, 1) mesh, estimated on meta in "
        f"{t_meta:.1f} s: {json.dumps(est)}")
    log(f"  (b) on the card: argument bytes {cell.local_bytes} against the "
        f"estimate's {mem['argument_bytes']}; the allocator held {held} "
        f"in {len(made)} blocks made by the build, for {len(sizes)} "
        f"argument storages; blocks past their storage rounded up to "
        f"{ALLOC_BLOCK15} B: {sum(x > 0 for x in slack.values())}, "
        f"{sum(slack.values())} B in all, the most {max(slack.values())} B "
        f"(a large block's bound {ALLOC_SMALL15}); "
        f"max_memory_allocated for the step {peak} B ({peak / 2**30:.3f} "
        f"GiB) against peak_bytes_est {mem['peak_bytes_est']} "
        f"({mem['peak_bytes_est'] / 2**30:.3f} GiB): {rel:+.4f} (gate "
        f"+-{PEAK15_RTOL}); FlopCounterMode {flops} against the estimate's "
        f"{est['cost']['flops']:.0f}; loss {loss:.6f}; step {t_card:.2f} s; "
        f"{smi}")
    if cell.local_bytes != mem["argument_bytes"]:
        failures.append(f"(b) argument bytes {cell.local_bytes} != "
                        f"{mem['argument_bytes']}")
    if not blocks_ok:
        failures.append(f"(b) the allocator's {len(made)} new blocks "
                        f"({sum(made.values())} B, held {held}) are not the "
                        f"{len(sizes)} argument storages within its rounding")
    if abs(rel) > PEAK15_RTOL:
        failures.append(f"(b) peak estimate off by {rel:+.4f}")
    if flops != est["cost"]["flops"]:
        failures.append(f"(b) FLOPs {flops} != {est['cost']['flops']}")
    if not math.isfinite(loss):
        failures.append(f"(b) loss {loss}")
    del cell
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_15
    log(f"phase 15: {took:.1f} s ((a) {t_a:.1f} s, (b) {took - t_a:.1f} s); "
        f"launches {counts}")
    if took > PHASE15_S:
        failures.append(f"phase 15 took {took:.1f} s (gate {PHASE15_S} s)")
    return counts, failures


PHASE16_S = 90
# bitnet-0.73b at full width, 4 of its 24 layers (the cut is the run's
# time), batch 4, prompts of 64-128 tokens (the paper's range), a cache
# of 256 positions, f32 activations and cache, 16 decode steps
SERVE16 = dict(layers=4, batch=4, prompt=(64, 128), max_seq=256, steps=16,
               seed=16)
MESHES16 = ((1, 2), (2, 1))
PREFILL16_RTOL = 1e-4   # of the largest |logit|: the head's GEMM may pick
DECODE16_TOL = 2e-3     # another algorithm for half the columns
MARGIN16 = 1e-3         # a token may differ only below this top-2 margin
PHASE16_RANK_S = 60
# (c): the MoE and recurrent archs at full width, (arch, layers, meshes,
# cache positions), SERVE16's batch, seed and steps: mixtral's expert
# banks split on E (4 experts a rank on (1, 2), with sequence parallelism
# in its prefill) or whole on (2, 1); xLSTM's and hymba's scans on a
# rank's heads, their states whole in their heads; hymba's 25 heads and 5
# KV heads over 5 ranks, its 320-position cache split 5 ways.  The
# recurrent kinds take equal prompts of 128 tokens (JAX's prefill_step
# takes no lengths)
CASES16C = (("mixtral-8x22b", 2, ((1, 2), (2, 1)), 256),
            ("xlstm-350m", 4, ((1, 2),), 256),
            ("hymba-1.5b", 4, ((1, 5),), 320))
PHASE16C_S = 120
PHASE16C_RANK_S = 150
MOVED16_MAX = 64   # int8 codes a replayed call may move, each at a tie


def _phase16_inputs(dev, arch="bitnet-0.73b", layers=None):
    """(config, packed weights from seed 16, prompts (4, 128) int32, their
    lengths (4,) int32: 64-128 tokens right-padded, or None for a
    recurrent kind, whose prompts are all 128 long) on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    s = SERVE16
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=layers or s["layers"])
    gen = torch.Generator(device=dev if dev != "meta" else "cpu")
    packed = transformer.init_packed_params(cfg, gen.manual_seed(s["seed"]))
    g = torch.Generator().manual_seed(s["seed"])
    lengths = torch.randint(s["prompt"][0], s["prompt"][1] + 1,
                            (s["batch"],), generator=g, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (s["batch"], s["prompt"][1]),
                           generator=g, dtype=torch.int32)
    if cfg.block_kind != "attn":
        return cfg, packed, prompt.to(dev), None
    return cfg, packed, prompt.to(dev), lengths.to(dev)


def _phase16_cell(cfg, packed, prompt, lengths, mesh, dev,
                  max_seq=SERVE16["max_seq"]):
    """The partitioned prefill of (a) or (c) on ``mesh`` (a ``TrainMesh``
    or, for the dry run's estimate, a ``DryMesh`` on meta tensors): (its
    arguments: this rank's packed weights, batch rows, their lengths (or
    None) and cache block, the context)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    from repro_torch.runtime import sharding
    b = SERVE16["batch"]
    params = sharding.shard_params(mesh, packed, fsdp=False)
    cache = sharding.local_cache(mesh, transformer.init_cache(
        cfg, b, max_seq, torch.float32, dev), b)
    rows = sharding.batch_spec(mesh, b, 1)
    inp = mesh.local_part(prompt, rows).clone()
    lens = (None if lengths is None
            else mesh.local_part(lengths, rows[:1]).clone())
    ctx = Ctx(mode="packed", constrain=sharding.make_constrain(
        mesh, cfg, b, max_seq=max_seq))
    return params, inp, lens, cache, ctx


def _phase16_read(shape, cfg) -> int:
    """The ``kv_splits`` of the single-device run a mesh of ``shape`` is
    held to: a cache split on its sequence over "model" (each rank reads
    its shard as one split-K chunk) by split-K over as many chunks, else
    the decode kernel (0)."""
    return shape[1] if shape[1] > 1 and cfg.block_kind != "xlstm_pair" else 0


def _phase16_pins(tape, replay, rows=None, moved=None, diverged=None):
    """The pins of (c): every int8 quantization of the packed path and,
    for an MoE, every routing, recorded into ``tape`` ({"int8", "routes"})
    in call order or replayed from it (``testing.pinned_int8``,
    ``pinned_routing``).  A replay holds the rank's own int8 values,
    scales and experts to the recorded ones (a moved code one step at a
    rounding tie, at most MOVED16_MAX a call; a route moved only below
    the top-k margin ``testing.TIE``), listing what moved in ``moved``
    ({"int8", "routes"}), and raises otherwise; with ``diverged`` it only
    compares and notes the first call that differs."""
    from repro_torch.testing import pinned_int8, pinned_routing
    moved = moved or {"int8": None, "routes": None}
    stack = contextlib.ExitStack()
    stack.enter_context(pinned_int8(tape["int8"], replay, rows,
                                    moved["int8"], max_moved=MOVED16_MAX,
                                    diverged=diverged))
    stack.enter_context(pinned_routing(tape["routes"], replay, rows,
                                       moved["routes"], diverged=diverged))
    return stack


def _moved_line(moved) -> str:
    """What a replay moved (``_phase16_pins``' ``moved``), for the log."""
    from repro_torch.testing import TIE
    codes = moved["int8"]
    per_call = collections.Counter(m[0] for m in codes)
    tie = max((abs(m[3] - math.floor(m[3]) - 0.5) for m in codes),
              default=0.0)
    return (f"int8 codes the replay moved (call, row, column, this rank's "
            f"|x| / scale, its code, the recorded one), each one step at a "
            f"rounding tie: {len(codes)} in {len(per_call)} calls (at most "
            f"{max(per_call.values(), default=0)} a call, gate "
            f"{MOVED16_MAX}; the farthest {tie:.3g} from a half), the first "
            f"{codes[:6]}; tokens routed otherwise (call, token, top-k "
            f"margin, gate {TIE}): {moved['routes'][:8]}")


def _phase16_reference(cfg, packed, prompt, lengths, max_seq, kv_splits,
                       dev, tape=None) -> dict:
    """The single-device port on the card, greedy: {"prefill": logits,
    "decode": [16 steps' logits], "tokens": [17 greedy tokens]}, reading
    its cache by the decode kernel or by split-K over ``kv_splits``
    chunks; given ``tape``, its int8 values and routings recorded there
    (``_phase16_pins``)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import Ctx
    s = SERVE16
    ctx = Ctx(mode="packed", kv_splits=kv_splits)
    cache = transformer.init_cache(cfg, s["batch"], max_seq, torch.float32,
                                   dev)
    t = prompt.shape[1]
    with torch.no_grad(), (contextlib.nullcontext() if tape is None
                           else _phase16_pins(tape, False)):
        logits, _ = transformer.prefill_step(cfg, packed, prompt, ctx, cache,
                                             lengths)
        ref = {"prefill": logits, "decode": [],
               "tokens": [logits.argmax(-1)]}
        for i in range(s["steps"]):
            logits, _ = transformer.decode_step(
                cfg, packed, ref["tokens"][-1][:, None].to(torch.int32),
                ctx, cache, (t if lengths is None else lengths) + i)
            ref["decode"].append(logits)
            ref["tokens"].append(logits.argmax(-1))
    return ref


def _phase16_mesh_run(cfg, packed, prompt, lengths, shape, max_seq, ref,
                      dev, plain, tape=None, pin=True) -> dict:
    """This rank's partitioned prefill and 16 decode steps on a mesh of
    ``shape``, each step fed the single device's greedy token, against
    the single-device run ``ref``: the readings of one mesh (times,
    errors, the first differing token and its margin, peak, collective
    bytes, launches, plain versions called).  Given the single device's
    ``tape`` (``_phase16_pins``), this rank replays its int8 values and
    routings, each held to its own, and the readings list the codes and
    routes the replay moved ("moved"); without ``pin`` it runs free and
    only compares its own with the tape: "clean" is the number of its
    runs (the prefill, then each decode step) before the first call
    whose int8 values or routing differ from one device's."""
    from repro_torch import kernels
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.runtime.collectives import TrainMesh
    s = SERVE16
    mesh = TrainMesh(shape)
    params, inp, lens, cache, ctx = _phase16_cell(
        cfg, packed, prompt, lengths, mesh, dev, max_seq)
    args = (params, inp, cache) + (() if lens is None else (lens,))
    arg_bytes = dryrun._distinct_bytes(dryrun._flat(args))
    rows = ctx.constrain.batch
    mine = (lambda t: mesh.local_part(t, (rows,) + (None,) * (t.dim() - 1)))
    moved, diverged = {"int8": [], "routes": []}, []
    at = prompt.shape[1] if lens is None else lens
    with (contextlib.nullcontext() if tape is None else _phase16_pins(
            tape, True, mine if ctx.constrain.n_batch > 1 else None,
            moved, None if pin else diverged)):
        kernels.reset_launch_counts()
        plain["calls"] = 0
        mesh.reset_collective_bytes()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = transformer.prefill_step(cfg, params, inp, ctx,
                                                 cache, lens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        want = mine(ref["prefill"])
        r = {"arg_bytes": arg_bytes, "above": peak, "prefill_s": prefill_s,
             "prefill_rel": float((logits - want).abs().max()
                                  / want.abs().max()),
             "prefill_coll": mesh.reset_collective_bytes(),
             "decode_err": [], "first_diff": None, "step_s": [],
             "clean": int(not diverged)}
        for i in range(s["steps"]):
            tok = mine(ref["tokens"][i])[:, None]
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, _ = transformer.decode_step(cfg, params, tok, ctx,
                                                    cache, at + i)
            torch.cuda.synchronize()
            r["step_s"].append(time.perf_counter() - t0)
            want = mine(ref["decode"][i])
            r["decode_err"].append(float((logits - want).abs().max()))
            nxt = mine(ref["tokens"][i + 1])
            if r["first_diff"] is None and not torch.equal(
                    logits.argmax(-1), nxt):
                top2 = want.topk(2, dim=-1).values
                r["first_diff"] = [i, float((top2[:, 0] - top2[:, 1])
                                            .min())]
            r["clean"] += int(not diverged and r["clean"] == i + 1)
        r["decode_coll"] = mesh.reset_collective_bytes()
        r["launches"] = kernels.launch_counts()
        r["plain_calls"] = plain["calls"]
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["moved"], r["diverged"] = moved, diverged
    return r


def _phase16_estimate(rank):
    """The dry run's estimate (``launch.dryrun``: ``Census`` on ``meta``
    tensors) of (a)'s (1, 2) prefill on rank ``rank`` of a ``DryMesh``:
    (argument bytes, bytes above them at the peak)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.runtime.collectives import DryMesh
    with dryrun.MetaInit():
        cfg, packed, prompt, lengths = _phase16_inputs("meta")
    mesh = DryMesh((1, 2), rank=rank)
    params, inp, lens, cache, ctx = _phase16_cell(cfg, packed, prompt,
                                                  lengths, mesh, "meta")
    args = (params, inp, cache, lens)
    est = dryrun.estimate(dryrun.Cell(
        lambda p, x, c, n: transformer.prefill_step(cfg, p, x, ctx, c, n),
        args, mesh, dryrun._distinct_bytes(dryrun._flat(args))))
    mem = est["memory"]
    return mem["argument_bytes"], mem["peak_bytes_est"] - mem[
        "argument_bytes"]


def _phase16_rank(rank, world, port, workdir, device="cuda"):
    """One of phase 16's gloo ranks on the one card, against the
    single-device runs in ``workdir/ref.pt``: a world of 2 runs (a) on each
    mesh of MESHES16, then (c)'s meshes of 2 ranks; a world of 5, (c)'s
    (1, 5).  Writes its readings to ``workdir/rank{world}_{rank}.json``."""
    entered = time.time()
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_prefill import ref as fp_ref
    from repro_torch.kernels.tlmm import ref as tlmm_ref
    from repro_torch.kernels.tlmm_lut import ref as lut_ref
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    dev = torch.device(device, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {"rank": rank, "entered": entered, "meshes": {}, "c": {}}
    plain = {"calls": 0}   # every plain version a wrapper could take

    def counted(fn):
        def wrapper(*a, **k):
            plain["calls"] += 1
            return fn(*a, **k)
        return wrapper

    for mod in (tlmm_ref, lut_ref, fp_ref, da_ref):
        for name in dir(mod):
            if name.endswith("_ref") and callable(getattr(mod, name)):
                setattr(mod, name, counted(getattr(mod, name)))
    try:
        refs = torch.load(os.path.join(workdir, "ref.pt"),
                          map_location=dev.type)
        out["ready"] = time.time()
        if world == 2:   # -- (a) ---------------------------------------------
            cfg, packed, prompt, lengths = _phase16_inputs(dev)
            for shape in MESHES16:
                # a cache split on its sequence is read by split-K partials
                ref = refs["bitnet"]["splitk" if shape[1] > 1 else "kernel"]
                out["meshes"][str(shape)] = _phase16_mesh_run(
                    cfg, packed, prompt, lengths, shape, SERVE16["max_seq"],
                    ref, dev, plain)
                torch.cuda.empty_cache()
            del packed
            torch.cuda.empty_cache()
        t_c = time.time()
        for arch, layers, meshes, max_seq in CASES16C:   # -- (c) ----------
            shapes = [m for m in meshes if math.prod(m) == world]
            if not shapes:
                continue
            cfg, packed, prompt, lengths = _phase16_inputs(dev, arch, layers)
            for shape in shapes:
                k = _phase16_read(shape, cfg)
                tape = torch.load(os.path.join(workdir,
                                               f"tape {arch} {k}.pt"))
                run = functools.partial(_phase16_mesh_run, cfg, packed,
                                        prompt, lengths, shape, max_seq,
                                        refs[arch][k], dev, plain)
                out["c"][f"{arch} {shape}"] = {
                    "free": run(tape=tape, pin=False),
                    "pinned": run(tape=tape)}
                del tape
                torch.cuda.empty_cache()
            del packed
            torch.cuda.empty_cache()
        out["c_s"] = time.time() - t_c
        out["ok"] = True
    finally:
        out["done"] = time.time()
        with open(os.path.join(workdir, f"rank{world}_{rank}.json"),
                  "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def _spawn16(world, workdir, deadline_s):
    """Phase 16's ranks in a world of ``world``: (their readings, the
    failure of a rank that did not finish or None, the spawn's time on the
    wall: (spawned, joined))."""
    import torch.multiprocessing as mp
    spawned = time.time()
    procs = mp.spawn(_phase16_rank, args=(world, _free_port(), workdir),
                     nprocs=world, join=False)
    deadline = time.perf_counter() + deadline_s
    failure = None
    try:
        while not procs.join(timeout=1):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"phase 16's {world} ranks did not finish")
    except Exception as e:   # a rank that fails fails the phase
        failure = f"{world} ranks: {type(e).__name__}: {str(e)[-2000:]}"
    finally:
        for p_ in procs.processes:
            if p_.is_alive():
                p_.kill()
            p_.join()
    joined = time.time()
    ranks = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{world}_{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else {})
    if failure is None and not all(r.get("ok") for r in ranks):
        failure = f"{world} ranks: a rank did not finish: {ranks}"
    return ranks, failure, (spawned, joined)


def _phase16_judge(label, row, smi, counts, failures, flash=True,
                   free=False):
    """Print one rank's readings of one mesh and hold them to (a)'s gates,
    its launches added to ``counts``.  A ``free`` run of (c) is held to
    them only over its "clean" runs: the prefill and the decode steps
    before the first call whose int8 values or routing differ from one
    device's (at full width a code moved at a rounding tie moves the
    logits by far more than the gates)."""
    s = SERVE16
    step = sorted(row["step_s"])[len(row["step_s"]) // 2]
    if row["moved"]["int8"] or row["moved"]["routes"]:
        log(f"  {label}: {_moved_line(row['moved'])}")
    n = row["clean"] if free else s["steps"] + 1
    if free:
        log(f"  {label}: the first call differing from one device's "
            f"{row['diverged'][:1]}; gated over the first {n} of "
            f"{s['steps'] + 1} runs (the prefill, then each decode step)")
    dec = row["decode_err"][:max(n - 1, 0)]
    log(f"  {label}: prefill {row['prefill_s']:.4f} s "
        f"(logits within {row['prefill_rel']:.3g} of the largest, gate "
        f"{PREFILL16_RTOL}), a decode step {step:.4f} s (median of "
        f"{s['steps']}; logits within {max(row['decode_err']):.3g} "
        f"({max(dec, default=0.0):.3g} over the gated steps), gate "
        f"{DECODE16_TOL}; first token differing {row['first_diff']}), peak "
        f"{row['peak_gib']:.3f} GiB ({row['above']} B above the "
        f"{row['arg_bytes']} B of its arguments at the prefill); collective "
        f"bytes prefill "
        f"{ {k: v for k, v in row['prefill_coll'].items() if v} }, decode "
        f"({s['steps']} steps) "
        f"{ {k: v for k, v in row['decode_coll'].items() if v} }; launches "
        f"{row['launches']}, plain versions called {row['plain_calls']}; "
        f"{smi}")
    if n >= 1 and row["prefill_rel"] > PREFILL16_RTOL:
        failures.append(f"{label} prefill {row['prefill_rel']}")
    if dec and max(dec) > DECODE16_TOL:
        failures.append(f"{label} decode {dec}")
    if row["first_diff"] is not None and row["first_diff"][0] < n - 1 and \
            not row["first_diff"][1] < MARGIN16:
        failures.append(f"{label} token differs at {row['first_diff']}")
    if free:
        return
    for name, k in row["launches"].items():
        counts[name] = counts.get(name, 0) + k
    if not (row["launches"]["tlmm"] > 0 and row["plain_calls"] == 0
            and (row["launches"]["flash_prefill"] > 0 or not flash)):
        failures.append(f"{label} launches {row['launches']}, plain "
                        f"{row['plain_calls']}")


def phase16(dev, smi):
    """Phase 16: JAX's partitioned packed serving program (``prefill_step``
    and ``decode_step`` under ``Constrain(max_seq=)``: packed weights by
    ``shard_params``, the cache split on its sequence over "model" by
    ``cache_sharding``, the batch by ``batch_spec``) on gloo ranks on the
    one card.  (a) bitnet-0.73b at full width, SERVE16 (4 of 24 layers),
    on (1, 2) and on (2, 1), against the single-device port on the card
    reading its cache as the mesh's ranks do ((2, 1) by the decode kernel;
    (1, 2), whose shards each read their half of the sequence as one
    split-K chunk, by split-K over 2 chunks, ``Ctx(kv_splits=2)``; the gap
    between the two reads on one device is printed): prefill logits within
    PREFILL16_RTOL of their largest; 16 decode steps, each rank fed the
    single device's greedy token, logits within DECODE16_TOL, the rank's
    greedy token equal or else the first differing step's single-device
    top-2 margin below MARGIN16; each rank's launch counters show tlmm and
    flash_prefill launched and no plain version called.  (b) the dry run's
    estimate of (a)'s (1, 2) prefill on ``DryMesh((1, 2))``: its argument
    bytes equal each rank's bytes of the same tensors, its bytes above
    them within PEAK13_RTOL of the rank's ``max_memory_allocated`` above
    what it held before the prefill.  (c) CASES16C at full width, each
    against the single-device port reading as its ranks do: mixtral-8x22b
    2 layers on (1, 2) (expert-parallel, sequence parallelism in the
    prefill) and (2, 1), xlstm-350m 4 layers on (1, 2), hymba-1.5b 4 layers
    on (1, 5) (a 5-rank world; flash_prefill launched but for xLSTM).  Each
    runs free (printed: a few ULPs from another GEMM or head count move
    int8 codes at rounding ties, and at full width a moved code moves the
    logits by far more than (a)'s gates) and then replaying the single
    device's int8 values and MoE routing on its blocks
    (``testing.pinned_int8``, ``pinned_routing``), held to (a)'s gates; the
    codes the replay moved are printed.  Prints per rank the prefill's and
    a decode step's
    seconds, the peak and the collective bytes by kind.  (a) and (b)
    within PHASE16_S; (c) (its references, its part of the 2-rank world,
    the 5-rank world) within PHASE16C_S.  Returns (the ranks' launch counts
    summed, the failures)."""
    import shutil
    failures = []
    t_16 = time.perf_counter()
    s = SERVE16
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase16")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    # -- the single-device runs on the card, greedy --------------------------
    # (2, 1)'s ranks read their rows' cache with the decode kernel, as one
    # device does; (1, 2)'s ranks each read their half of the sequence as
    # one split-K chunk, so its single-device run reads by split-K over 2
    # chunks (Ctx.kv_splits), the same partials merged in the same order
    cfg, packed, prompt, lengths = _phase16_inputs(dev)
    refs = {"bitnet": {name: _phase16_reference(
        cfg, packed, prompt, lengths, s["max_seq"], kv_splits, dev)
        for name, kv_splits in (("kernel", 0), ("splitk", 2))}}
    one = refs["bitnet"]
    same, gap = 0, 0.0   # the two reads' logits while their tokens agree
    for i in range(s["steps"]):
        if not torch.equal(one["kernel"]["tokens"][i],
                           one["splitk"]["tokens"][i]):
            break
        same += 1
        gap = max(gap, float((one["kernel"]["decode"][i]
                              - one["splitk"]["decode"][i]).abs().max()))
    log(f"  one device: the decode kernel's read against split-K over 2 "
        f"chunks, logits within {gap:.3g} over the first {same} of "
        f"{s['steps']} steps (their greedy inputs equal there; ungated: a "
        f"read summed in another order moves int8 codes at full width)")
    del packed
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_16
    t_c = time.perf_counter()   # (c)'s references, each arch's reads,
    for arch, layers, meshes, max_seq in CASES16C:   # and their pins
        cfg, packed, prompt, lengths = _phase16_inputs(dev, arch, layers)
        refs[arch] = {}
        for k in sorted({_phase16_read(m, cfg) for m in meshes}):
            tape = {"int8": [], "routes": []}
            refs[arch][k] = _phase16_reference(cfg, packed, prompt, lengths,
                                               max_seq, k, dev, tape)
            torch.save(tape, os.path.join(workdir, f"tape {arch} {k}.pt"))
        del packed, tape
        torch.cuda.empty_cache()
    t_c_ref = time.perf_counter() - t_c
    torch.save(refs, os.path.join(workdir, "ref.pt"))
    del refs, one
    torch.cuda.empty_cache()
    # -- (a), then (c)'s meshes of 2, on two ranks; (c)'s (1, 5) on five ------
    t_r = time.perf_counter()
    ranks, fail2, (spawned, joined) = _spawn16(2, workdir, PHASE16_RANK_S
                                               + PHASE16C_RANK_S)
    t_ranks = time.perf_counter() - t_r
    t_5 = time.perf_counter()
    ranks5, fail5, _ = _spawn16(5, workdir, PHASE16C_RANK_S)
    t_5 = time.perf_counter() - t_5
    failures += [f"(a)/(c) {f}" for f in (fail2, fail5) if f]
    shutil.rmtree(workdir, ignore_errors=True)
    counts = {}
    if fail2:
        return counts, failures
    log(f"  the 2 ranks: spawn to entry "
        f"{[round(r['entered'] - spawned, 1) for r in ranks]} s, entry to "
        f"ready {[round(r['ready'] - r['entered'], 1) for r in ranks]} s, "
        f"ready to done {[round(r['done'] - r['ready'], 1) for r in ranks]}"
        f" s ((c) {[round(r['c_s'], 1) for r in ranks]} s), done to joined "
        f"{[round(joined - r['done'], 1) for r in ranks]} s")
    for shape in MESHES16:
        for r_, rank in enumerate(ranks):
            _phase16_judge(f"(a) {shape} rank {r_}",
                           rank["meshes"][str(shape)], smi, counts, failures)
    # -- (b) the dry run's estimate of the (1, 2) prefill --------------------
    t_e = time.perf_counter()
    for r_, rank in enumerate(ranks):
        row = rank["meshes"][str(MESHES16[0])]
        args, above = _phase16_estimate(r_)
        rel = (above - row["above"]) / row["above"]
        log(f"  (b) (1, 2) rank {r_}: the dry run's argument bytes {args} B "
            f"against the card's {row['arg_bytes']} B; bytes above them at "
            f"the peak {above} B against the card's {row['above']} B (rel "
            f"{rel:+.4f}, gate {PEAK13_RTOL}); {smi}")
        if args != row["arg_bytes"]:
            failures.append(f"(b) rank {r_} argument bytes {args} != "
                            f"{row['arg_bytes']}")
        if abs(rel) > PEAK13_RTOL:
            failures.append(f"(b) rank {r_} peak estimate off by {rel:+.4f}")
    t_e = time.perf_counter() - t_e
    # -- (c) judged -----------------------------------------------------------
    for arch, layers, meshes, max_seq in CASES16C:
        for shape in meshes:
            group = ranks if math.prod(shape) == 2 else ranks5
            for r_, rank in enumerate(group):
                row = rank.get("c", {}).get(f"{arch} {shape}")
                label = f"(c) {arch} {layers} layers {shape} rank {r_}"
                if row is None:
                    failures.append(f"{label}: no reading")
                    continue
                # free-running: gated up to its first moved int8 code or
                # route (a few ULPs move codes at rounding ties, and a
                # moved code moves the logits by a quantization step at
                # full width); the replay, each code held to its own, whole
                _phase16_judge(f"{label} free-running", row["free"], smi,
                               counts, failures, free=True)
                _phase16_judge(f"{label} replaying one device's int8 values"
                               f" and routing", row["pinned"], smi, counts,
                               failures, flash=arch != "xlstm-350m")
    t_c = t_c_ref + max(r["c_s"] for r in ranks) + t_5
    took = time.perf_counter() - t_16
    log(f"phase 16: {took:.1f} s ((a) and (b) {took - t_c:.1f} s: the single"
        f" device {t_ref:.1f} s, the 2 ranks {t_ranks:.1f} s less (c)'s "
        f"part, the estimate {t_e:.1f} s; (c) {t_c:.1f} s: its single-device"
        f" references {t_c_ref:.1f} s, its part of the 2 ranks "
        f"{max(r['c_s'] for r in ranks):.1f} s, the 5 ranks {t_5:.1f} s); "
        f"launches {counts}")
    if took - t_c > PHASE16_S:
        failures.append(f"phase 16 (a) and (b) took {took - t_c:.1f} s "
                        f"(gate {PHASE16_S} s)")
    if t_c > PHASE16C_S:
        failures.append(f"phase 16 (c) took {t_c:.1f} s (gate "
                        f"{PHASE16C_S} s)")
    return counts, failures


def main() -> int:
    try:
        return run()
    finally:   # phase 4f's NCCL group, on every path out
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def run() -> int:
    t_main = time.perf_counter()
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
    from repro_torch.kernels.decode_attention import plan as da_plan
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.flash_prefill import plan as fp_plan
    from repro_torch.kernels.flash_prefill import ref as fp_ref
    from repro_torch.kernels.rmsnorm_quant import ops as rq_ops
    from repro_torch.kernels.rmsnorm_quant import plan as rq_plan
    from repro_torch.kernels.rmsnorm_quant import ref as rq_ref
    from repro_torch.kernels.swiglu_quant import ops as sq_ops
    from repro_torch.kernels.swiglu_quant import plan as sq_plan
    from repro_torch.kernels.swiglu_quant import ref as sq_ref
    from repro_torch.kernels.tlmm import ops as tlmm_ops
    from repro_torch.kernels.tlmm import ref as tlmm_ref
    from repro_torch.kernels.tlmm_lut import ops as lut_ops
    from repro_torch.kernels.tlmm_lut import ref as lut_ref
    from repro_torch.models import attention, transformer
    from repro_torch.models.layers import Ctx
    from torch import nn
    from repro_torch.serving import (FaultInjector, Request, RequestStatus,
                                     ServingEngine)
    from repro_torch.serving.engine import reference_decode

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    log(f"card: {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}; top SM clock "
        f"{clock_mhz:.0f} MHz")

    log(f"-- phase 2 at {time.perf_counter() - t_main:.1f} s")
    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s)")
    for line in ptxas_summary(build.build_log):
        log("  ptxas:", line)
    for kernel in ("flash_attn_kernel", "decode_attn_kernel",
                   "rmsnorm_quant_kernel", "swiglu_quant_kernel"):
        spills = [line for line in ptxas_summary(build.build_log)
                  if kernel in line
                  and not re.search(r"(?<!\d)0 bytes spill stores", line)]
        log(f"  {kernel} instantiations spilling: {spills or 'none'}")
    lib = build.load()
    log("  flash_attn_kernel warps a block by head dim: " + "; ".join(
        f"d={d} {w} warps, {fp_plan.smem_bytes(d, w)} B"
        for d, w in fp_plan.WARPS.items()))
    log("  decode_attn_kernel warps a block by head dim: " + "; ".join(
        f"d={d} {w} warps, {da_plan.smem_bytes(d, 2, w)} B (bf16 rows)"
        for d, w in da_plan.PLAN.items()))
    log("  rmsnorm_quant_kernel warps a row (a block): " + "; ".join(
        f"d={d} {rq_plan.warps_per_row(d)}" for d in (1536, 1024))
        + "; swiglu_quant_kernel threads a row (a block): " + "; ".join(
            f"f={f} {sq_plan.threads(f)}"
            + (" staged" if sq_plan.staged(f) else "")
            for f in (4096, 2816)))
    log("  dynamic shared memory a block: tlmm mma " + ", ".join(
        f"g={g} {lib.tlmm_dynamic_smem(g, 64)} B" for g in (3, 5))
        + "; tlmm_lut " + ", ".join(
            f"g={g} rows={bm} {lib.tlmm_lut_dynamic_smem(g, bm)} B"
            for g in (3, 5) for bm in (2, 4, 8)))

    log(f"-- phase 3 at {time.perf_counter() - t_main:.1f} s")
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
            c["ms"] = ms
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

    # the oracle's decode shape (m = 1: reference_decode is unbatched) for
    # either kernel, outside the summed rows: device ms and bound per linear
    def decode_line(name, fn, g):
        parts, tot, tot_b = [], 0.0, 0.0
        for n, k in ((1536, 1536), (1536, 4096), (4096, 1536)):
            w = torch.randint(-1, 2, (n, k), generator=gen, device=dev,
                              dtype=torch.int8)
            codes = ternary.pack_ternary(w, g, bitlinear.ROW_MULTIPLE)
            a = torch.randint(-127, 128, (1, n), generator=gen, device=dev,
                              dtype=torch.int8)
            if not torch.equal(fn(a, codes, g),
                               tlmm_ref.tlmm_ref(a, codes, g, n)):
                raise AssertionError(f"{name} m=1 n={n} k={k}: kernel != plain")
            ms = device_ms(lambda a=a, c=codes: fn(a, c, g))
            b_ms, _ = bound_ms(n + codes.numel() + k * 4, 2.0 * n * k,
                               INT8_OPS_PER_S)
            parts.append(f"n={n} k={k} {ms:.4f} (bound {b_ms:.5f})")
            tot, tot_b = tot + ms, tot_b + b_ms
        log(f"  {name} m=1 g={g} (decode, not in the row): device_ms "
            f"{'; '.join(parts)}; sum {tot:.4f} (bound {tot_b:.5f})")

    decode_line("tlmm", lambda a, c, g: tlmm_ops.tlmm(a, c, g=g), 5)

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
    decode_line("tlmm_lut", lambda a, c, g: lut_ops.tlmm_lut(a, c, g=g), 5)
    # table reads: one per (row, group, column); per clock at the top SM clock
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in calls:
        g_, m_, n_, k_ = (int(x.split("=")[1]) for x in c["shape"].split())
        reads = m_ * k_ * -(-n_ // g_)
        log(f"  tlmm_lut {c['shape']}: {reads / 1e6:.1f} M table reads, "
            f"{reads / (c['ms'] * 1e-3) / sms / 1e6:.1f} per us an SM, "
            f"{reads / (c['ms'] * 1e-3) / sms / (clock_mhz * 1e6):.2f} per "
            f"clock an SM at {clock_mhz:.0f} MHz")
    # the paper's Table 4 on this card: decode-to-int8 against table lookup,
    # same codes, timed in turns (tlmm, lut, lut, tlmm) within this call
    for shape, lut_fn, tlmm_fn in table4:
        t1, l1, l2, t2 = (device_ms(f) for f in (tlmm_fn, lut_fn, lut_fn,
                                                 tlmm_fn))
        log(f"  table4 {shape}: tlmm_ms {(t1 + t2) / 2:.4f}  tlmm_lut_ms "
            f"{(l1 + l2) / 2:.4f}  lut/tlmm {(l1 + l2) / (t1 + t2):.2f}")

    # the launch floor: an empty kernel's device time, beside every bound
    stream = torch.cuda.current_stream().cuda_stream
    floor_ms = device_ms(lambda: build.check(
        build.load().repro_empty_launch(stream), "repro_empty_launch"))
    log(f"  launch floor: empty kernel device_ms {floor_ms:.4f} (stream held, "
        "host excluded)")

    # the scale's arithmetic: a CUDA tensor divided by a Python scalar is a
    # product by the scalar's f32 reciprocal (the JAX package's, jitted),
    # by a tensor the true quotient
    a = torch.rand(1 << 20, generator=gen, device=dev) * 64
    by_scalar, prod = a / 127.0, a * ternary.INV_127
    quot = a / torch.tensor(127.0, device=dev)
    log(f"  scale arithmetic: amax / 127.0 on the card differs from amax * "
        f"f32(1/127) in {int((by_scalar != prod).sum())} of {a.numel()} "
        f"values, from the quotient in {int((by_scalar != quot).sum())}")
    if not torch.equal(by_scalar, prod):
        raise AssertionError("amax / 127.0 on the card is not the product "
                             "by f32(1/127)")

    # rmsnorm_quant: the norm before an FFN (and before QKV) of one decode
    # tick (m = 4) and one admission chunk (m = 128), bf16 and f32 input
    def quant_err(name, got, want, exact):
        """Scales within rel 1e-6, codes at most one apart, or (exact)
        equal; returns the largest code difference."""
        (q, sc), (q_w, sc_w) = got, want
        rel = ((sc - sc_w).abs() / sc_w.abs()).max().item()
        diff = (q.int() - q_w.int()).abs()
        log(f"  {name}: scale max rel err {rel:.3g}, codes differing "
            f"{int((diff > 0).sum())} of {q.numel()}")
        if exact and not (torch.equal(q, q_w) and torch.equal(sc, sc_w)):
            raise AssertionError(f"{name}: kernel and plain version differ")
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
            got = rq_ops.rmsnorm_quant(x, w)
            err = quant_err(f"rmsnorm_quant {shape}", got,
                            rq_ref.rmsnorm_quant_ref(x, w), exact=False)
            quant_err(f"rmsnorm_quant {shape} vs the plain version in the "
                      "kernel's order", got, rq_ref.rmsnorm_quant_ref(
                          x, w, warps=rq_plan.warps_per_row(d)), exact=True)
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
                        sq_ref.swiglu_quant_ref(*args), exact=True)
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

    # rows past the serving shapes, outside the JSON rows: rmsnorm_quant past
    # one chunk a thread (d > 8192) and swiglu_quant past shared memory
    # (f > 29040, qwen2-72b's 29568) take the looping kernels; each is held
    # to its plain version (rmsnorm_quant in the kernel's order) bit for bit
    wide_lines = []
    for d_w in (8192 + 8, 16384):
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(4, d_w, generator=gen, device=dev) * 3).to(dt)
            w = 1 + 0.1 * torch.randn(d_w, generator=gen, device=dev)
            got = rq_ops.rmsnorm_quant(x, w)
            shape = f"x (4, {d_w}) {dt}"
            quant_err(f"rmsnorm_quant {shape} vs the plain version in the "
                      "kernel's order", got, rq_ref.rmsnorm_quant_ref(
                          x, w, warps=rq_plan.warps_per_row(d_w)), exact=True)
            quant_err(f"rmsnorm_quant {shape}", got,
                      rq_ref.rmsnorm_quant_ref(x, w), exact=False)
            ms = device_ms(lambda x=x, w=w: rq_ops.rmsnorm_quant(x, w))
            pms = device_ms(lambda x=x, w=w: rq_ref.rmsnorm_quant_ref(x, w),
                            iters=3)
            b_ms, _ = bound_ms(4 * d_w * (x.element_size() + 1) + d_w * 4,
                               8.0 * 4 * d_w, F32_FLOPS_PER_S)
            wide_lines.append(f"rmsnorm_quant {shape} device_ms {ms:.4f} "
                              f"plain_ms {pms:.4f} bound_ms {b_ms:.5f}")
    for f_w in (29568, 65536):
        for m in (4, 128):
            gate_i, up_i = (torch.randint(-3000, 3000, (m, f_w), generator=gen,
                                          device=dev, dtype=torch.int32)
                            for _ in range(2))
            gs = torch.rand(m, 1, generator=gen, device=dev) * 1e-3
            us = torch.rand(m, 1, generator=gen, device=dev) * 1e-3
            args = (gate_i, up_i, gs, us)
            shape = f"gate, up ({m}, {f_w}) int32"
            quant_err(f"swiglu_quant {shape}", sq_ops.swiglu_quant(*args),
                      sq_ref.swiglu_quant_ref(*args), exact=True)
            ms = device_ms(lambda a=args: sq_ops.swiglu_quant(*a))
            pms = device_ms(lambda a=args: sq_ref.swiglu_quant_ref(*a),
                            iters=3)
            b_ms, _ = bound_ms(m * f_w * 9 + m * 12, 12.0 * m * f_w,
                               F32_FLOPS_PER_S)
            wide_lines.append(f"swiglu_quant {shape} device_ms {ms:.4f} "
                              f"plain_ms {pms:.4f} bound_ms {b_ms:.5f}")
    log("  wide rows (looping kernels, not in the rows): "
        + "; ".join(wide_lines))

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
    # the prompt as the engine's 32-token chunks against an f32 cache that
    # holds its earlier rows (the rest NaN, never read): the prompt kernel's
    # bits, as keys fall to tiles and warps by absolute position alone
    cache_rows = 256
    for lo in range(0, s, 32):
        kc, vc = (torch.full((b, h, cache_rows, d), float("nan"), device=dev)
                  for _ in range(2))
        kc[:, :, :lo], vc[:, :, :lo] = k_[:, :, :lo], v[:, :, :lo]
        part = fp_ops.flash_chunk_prefill(
            q[:, :, lo:lo + 32], kc, vc, k_[:, :, lo:lo + 32],
            v[:, :, lo:lo + 32], torch.full((b,), lo, dtype=torch.int32,
                                            device=dev))
        if not torch.equal(part, got[:, :, lo:lo + 32]):
            raise AssertionError(f"flash: chunk at {lo} differs from the "
                                 "prompt kernel on f32 rows")
    log(f"  flash q ({b}, {h}, {s}, {d}): the prompt kernel equals the chunk "
        f"kernel fed its {s // 32} chunks of 32 (f32 cache), bit for bit")
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

    # the oracle's decode shape (one slot: reference_decode is unbatched),
    # outside the summed row: q (1, 24, 1, 64) against the 256-row bf16
    # cache above at lengths 77 and 200
    parts, tot, tot_b, tot_l = [], 0.0, 0.0, 0.0
    for n in (77, 200):
        one = torch.tensor([n], dtype=torch.int32, device=dev)
        args = (q[:1], kc[:1], vc[:1], one)
        err = (da_ops.decode_attention(*args)
               - da_ref.decode_attention_ref(*args)).abs().max().item()
        if not err <= ATTN_ATOL:
            raise AssertionError(f"decode, one slot of {n} keys: max_abs_err "
                                 f"{err} > {ATTN_ATOL}")
        ms = device_ms(lambda a=args: da_ops.decode_attention(*a))
        lms = device_ms(lambda n=n: sdpa(q[:1], kf[:1, :, :n], vf[:1, :, :n]))
        b_ms, _ = bound_ms(2 * h * d * 4 + n * h * d * 2 * 2, n * h * 4 * d,
                           F32_FLOPS_PER_S)
        parts.append(f"cache_len {n}: {ms:.4f} (library {lms:.4f}, bound "
                     f"{b_ms:.5f}, max_abs_err {err:.3g})")
        tot, tot_b, tot_l = tot + ms, tot_b + b_ms, tot_l + lms
    log(f"  decode_attention q (1, {h}, 1, {d}) vs bf16 (1, {h}, {S}, {d}) "
        f"(the oracle's, not in the row): device_ms {'; '.join(parts)}; sum "
        f"{tot:.4f} (library {tot_l:.4f}, bound {tot_b:.5f})")

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

    # bf16 queries (and fresh chunk K/V, as the model's at bf16
    # activations): each attention wrapper returns bf16, the bits of its f32
    # launch on the same exactly widened values rounded to bf16, within
    # ATTN_ATOL plus one bf16 ULP (2^-7 of the value) of its plain version
    # on the same bf16 inputs (which rounds its own f32 result).  The prompt
    # runs at phase 8's shape: q (1, 24, 128, 64) against bf16 K/V, 128 the
    # longest of its 64-128-token prompts.
    def bf16_inputs():
        def rnd(*shape, dtype=torch.bfloat16):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)

        qp, kp_, vp_ = (rnd(1, 128, h, d).transpose(1, 2) for _ in range(3))
        qc = rnd(4, 32, h, d).transpose(1, 2)
        kr_, vr_ = rnd(4, S, h, d), rnd(4, S, h, d)
        kn_, vn_ = (rnd(4, 32, h, d).transpose(1, 2) for _ in range(2))
        (kpool, bt_), (vpool, _) = (paged_copy(x, 16, noise)
                                    for x in (kr_, vr_))
        qd = rnd(4, 1, h, d).transpose(1, 2)
        ki_, vi_ = int8s((4, S, h, d)), int8s((4, S, h, d))
        (kip, bti), (vip, _) = paged_copy(ki_, 16, int8s), paged_copy(
            vi_, 16, int8s)
        (ksp, _), (vsp, _) = (paged_copy(unit_scales((4, S, h)), 16,
                                         unit_scales) for _ in range(2))
        kc_, vc_ = kr_.transpose(1, 2), vr_.transpose(1, 2)
        return {   # name -> (the wrapper on a query dtype, its plain version)
            "flash_prefill": (
                lambda dt: fp_ops.flash_prefill(qp.to(dt), kp_, vp_),
                lambda: fp_ref.flash_prefill_ref(qp, kp_, vp_)),
            "flash_chunk_prefill": (
                lambda dt: fp_ops.flash_chunk_prefill(
                    qc.to(dt), kc_, vc_, kn_.to(dt), vn_.to(dt), off),
                lambda: fp_ref.flash_chunk_prefill_ref(qc, kc_, vc_, kn_, vn_,
                                                       off)),
            "flash_chunk_prefill_paged": (
                lambda dt: fp_ops.flash_chunk_prefill_paged(
                    qc.to(dt), kpool, vpool, bt_, off, kn_.to(dt),
                    vn_.to(dt)),
                lambda: fp_ref.flash_chunk_prefill_paged_ref(
                    qc, kpool, vpool, bt_, off, kn_, vn_)),
            "decode_attention": (
                lambda dt: da_ops.decode_attention(qd.to(dt), kc_, vc_, cl),
                lambda: da_ref.decode_attention_ref(qd, kc_, vc_, cl)),
            "decode_attention_paged": (
                lambda dt: da_ops.decode_attention_paged(qd.to(dt), kpool,
                                                         vpool, bt_, cl),
                lambda: da_ref.paged_decode_attention_ref(qd, kpool, vpool,
                                                          bt_, cl)),
            "decode_attention_paged_quant": (
                lambda dt: da_ops.decode_attention_paged_quant(
                    qd.to(dt), kip, vip, ksp, vsp, bti, cl),
                lambda: da_ref.paged_decode_attention_quant_ref(
                    qd, kip, vip, ksp, vsp, bti, cl))}

    bf16_errs = []
    for name, (call, plain) in bf16_inputs().items():
        got = call(torch.bfloat16)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.equal(
                got, call(torch.float32).to(torch.bfloat16)):
            raise AssertionError(f"{name}: a bf16 query does not give the "
                                 "f32 launch's bits rounded to bf16")
        want = plain()
        gap = (got.float() - want.float()).abs()
        excess = (gap - ATTN_ATOL - 2 ** -7 * want.float().abs()).max().item()
        if want.dtype != torch.bfloat16 or not excess <= 0:
            raise AssertionError(f"{name}: bf16 output off its plain version "
                                 f"by {gap.max().item()} (more than "
                                 f"{ATTN_ATOL} + 2^-7 of the value by "
                                 f"{excess})")
        bf16_errs.append(f"{name} {gap.max().item():.3g}")
    log("  bf16 queries: the six attention wrappers return bf16, equal to "
        "their f32 launches rounded and within ATTN_ATOL + one bf16 ULP of "
        "their plain versions (max abs gap: " + ", ".join(bf16_errs) + ")")

    log(f"-- phase 4 at {time.perf_counter() - t_main:.1f} s")
    # -- 4. the serving engine at full width, SERVE_LAYERS deep (the cut is
    # the run's time: PERF.md section 4); phases 4-8 serve and judge it
    cfg = dataclasses.replace(get_config("bitnet-0.73b"),
                              n_layers=SERVE_LAYERS)
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

    def kv_mib(rows):   # bf16 K and V over every layer
        return rows * cfg.n_layers * cfg.kv_dim * 2 * 2 / 2**20

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sampled():
        return sampled_of(requests())

    def serve(label, prof=True, **kw):
        return serve_modes(cfg, packed, label, requests, max_seq=max_seq,
                           checks=DECODE_CHECK, prof=prof, **kw)

    def pool_ok(label, runs):
        """The 25-page pool in both modes: admission deferred, the peak
        within the pool, every page returned after the drain."""
        for mode in ("host", "device"):
            s = runs[mode]["stats"]
            if not (s["admissions_deferred_pages"] > 0
                    and 0 < s["kv_pages_peak"] <= 25
                    and s["kv_pages_in_use"] == 0):
                raise AssertionError(f"{label}, {mode}: pool accounting {s}")

    res = serve("contiguous bf16")
    engine, reqs = res["device"]["engine"], res["device"]["reqs"]
    sampled_reqs = res["device"]["sampled"]
    eng_counts, mem_contiguous = res["device"]["counts"], res["device"]["mem"]
    st = res["device"]["stats"]   # the 8 requests' window
    log(f"engine: bitnet-0.73b L={cfg.n_layers} d={cfg.d_model} slots=4 "
        f"max_seq={max_seq} chunk=32 block=8; {len(reqs)} requests, prompts "
        f"{[len(r.prompt) for r in reqs]}, max_new "
        f"{[r.max_new_tokens for r in reqs]}; admissions {st['admissions']} "
        f"(mid-flight {st['mid_flight_admissions']})")
    for r in reqs:
        if not (r.done and len(r.output) == r.max_new_tokens
                and ((r.output >= 0) & (r.output < cfg.vocab_size)).all()):
            raise AssertionError(f"engine output wrong: {r.output}")
    for counts in (res["host"]["counts"], eng_counts):
        for name in ("flash_chunk_prefill", "decode_attention"):
            if counts[name] <= 0:
                raise AssertionError(f"engine path did not launch {name}")

    # the engine again with an f32 cache (not counted: a check, not the path)
    reqs32 = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                           prefill_chunk=32, decode_block=8,
                           cache_dtype=torch.float32).run(requests())
    log(f"engine tokens, bf16 cache: {[r.output.tolist() for r in reqs]}")
    log(f"engine tokens, f32 cache:  {[r.output.tolist() for r in reqs32]}")
    log(f"distinct tokens: bf16 {len(set(np.concatenate([r.output for r in reqs])))}"
        f", f32 {len(set(np.concatenate([r.output for r in reqs32])))}")
    del engine, res   # the paged run's memory peak then holds one engine
    torch.cuda.empty_cache()

    log(f"-- phase 4b at {time.perf_counter() - t_main:.1f} s")
    # -- 4b. the paged engine: 25 usable pages of 16 tokens, 400 rows against
    # the contiguous cache's 4 x 256 = 1024.  Each request's worst case is at
    # most 10 pages, so none is refused, and 4 slots cannot all hold theirs:
    # admission must defer.
    pres = serve("paged bf16, 25 pages", paged=True, page_size=16,
                 kv_pages=26)
    pengine, preqs = pres["device"]["engine"], pres["device"]["reqs"]
    paged_counts, mem_paged = pres["device"]["counts"], pres["device"]["mem"]
    pst = pres["device"]["stats"]
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
    pool_ok("paged bf16", pres)
    for r, c in zip(preqs + pres["device"]["sampled"], reqs + sampled_reqs):
        if r.output.tolist() != c.output.tolist():
            raise AssertionError(f"paged tokens {r.output.tolist()} != "
                                 f"contiguous {c.output.tolist()}")
    for counts in (pres["host"]["counts"], paged_counts):
        for name in ("flash_chunk_prefill_paged", "decode_attention_paged"):
            if counts[name] <= 0:
                raise AssertionError(f"paged engine did not launch {name}")
    del pengine, pres

    log(f"-- phase 4c at {time.perf_counter() - t_main:.1f} s")
    # -- 4c. int8 KV, contiguous and paged (same pool), token for token
    def serve8(label, **kw):
        return serve_modes(cfg, packed, label, requests, max_seq=max_seq,
                           checks=DECODE_CHECK, kv_quant=True, **kw)

    res8 = serve8("contiguous int8 KV")
    pres8 = serve8("paged int8 KV, 25 pages", prof=False, paged=True,
                   page_size=16, kv_pages=26)
    reqs8, preqs8 = res8["device"]["reqs"], pres8["device"]["reqs"]

    def kv8_sum(mode):
        return {k: res8[mode]["counts"][k] + pres8[mode]["counts"][k]
                for k in eng_counts}

    kv8_counts = kv8_sum("device")
    log(f"engine tokens, int8 KV: {[r.output.tolist() for r in reqs8]}")
    for r, c in zip(preqs8 + pres8["device"]["sampled"],
                    reqs8 + res8["device"]["sampled"]):
        if r.output.tolist() != c.output.tolist():
            raise AssertionError(f"paged int8 tokens {r.output.tolist()} != "
                                 f"contiguous int8 {c.output.tolist()}")
    pool_ok("paged int8", pres8)
    for counts in (kv8_sum("host"), kv8_counts):
        for name in ("decode_attention_paged_quant", "flash_chunk_prefill",
                     "decode_attention"):
            if counts[name] <= 0:
                raise AssertionError(f"int8 KV engines did not launch {name}")
    del res8, pres8
    torch.cuda.empty_cache()

    log(f"-- phase 4d at {time.perf_counter() - t_main:.1f} s")
    # -- 4d. paged prefix sharing: 8 requests on one 64-token template with
    # 16-64-token tails, 16-token pages, against plain paged on the same
    # requests.  The template's pages are registered by the first admission
    # and granted to the next ones, whose prefill starts at token 64.
    def templated():
        r = np.random.default_rng(5)
        tpl = r.integers(0, cfg.vocab_size, size=64)
        return [Request(prompt=np.concatenate(
                    [tpl, r.integers(0, cfg.vocab_size,
                                     size=int(r.integers(16, 65)))]),
                        max_new_tokens=16 + 2 * i) for i in range(8)]

    shared_runs = {}
    for sharing in (False, True):
        eng = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                            prefill_chunk=32, decode_block=8, paged=True,
                            page_size=16, enable_prefix_sharing=sharing)
        eng.run(requests()[:2])                # warm-up, no template
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        sreqs = eng.run(templated())
        torch.cuda.synchronize()
        shared_runs[sharing] = (eng.stats, sreqs, kernels.launch_counts())
        engine_line(f"engine, paged bf16, templated, prefix sharing "
                    f"{'on ' if sharing else 'off'}", eng.stats)
        del eng
    (plain_st, plain_reqs, _), (sh_st, sh_reqs, shared_counts) = (
        shared_runs[False], shared_runs[True])
    log(f"prefix sharing: hits {sh_st['prefix_hits']} of "
        f"{sh_st['admissions']} admissions, prefill tokens skipped "
        f"{sh_st['prefill_tokens_skipped']}, per-request prefill chunks "
        f"{sh_st['prefill_chunk_rows']} (plain {plain_st['prefill_chunk_rows']})"
        f", waves {sh_st['prefill_chunks']} (plain "
        f"{plain_st['prefill_chunks']}), held for a pending prefix "
        f"{sh_st['admissions_held_for_prefix']}, CoW splits "
        f"{sh_st['kv_cow_splits']}, pages peak {sh_st['kv_pages_peak']} "
        f"(plain {plain_st['kv_pages_peak']}), cached after drain "
        f"{sh_st['kv_prefix_cached_pages']}")
    if not (sh_st["prefix_hits"] > 0 and sh_st["prefill_chunk_rows"]
            < plain_st["prefill_chunk_rows"]
            and sh_st["kv_pages_in_use"] == sh_st["kv_prefix_cached_pages"]):
        raise AssertionError(f"prefix sharing did not share: {sh_st}")
    for s, p in zip(sh_reqs, plain_reqs):
        if s.output.tolist() != p.output.tolist():
            raise AssertionError(f"shared-prefix tokens {s.output.tolist()} "
                                 f"!= plain paged {p.output.tolist()}")
    for name in ("flash_chunk_prefill_paged", "decode_attention_paged"):
        if shared_counts[name] <= 0:
            raise AssertionError(f"prefix-sharing engine did not launch "
                                 f"{name}")
    torch.cuda.empty_cache()

    log(f"-- phase 4e at {time.perf_counter() - t_main:.1f} s")
    t_4e = time.perf_counter()
    # -- 4e. robustness on the card: the device-resident engines with their
    # captured block under injected faults, held to the fault-free tokens
    # of phases 4 (contiguous) and 4d (paged with sharing).  Which lane is
    # live at which block depends only on the lengths, so the schedule is
    # the same on any weights.
    robust_counts = dict.fromkeys(eng_counts, 0)

    def count_robust():
        torch.cuda.synchronize()
        for k, v in kernels.launch_counts().items():
            robust_counts[k] += v

    def scenario(label, eng, rs, wall):
        s = eng.stats
        log(f"robustness {label}: {wall:.3f} s; statuses "
            f"{[r.status.value for r in rs]}; " + ", ".join(
                f"{k} {s[k]}" for k in (
                    "integrity_faults", "faults_injected", "sched_fallbacks",
                    "repromotions", "canary_probes", "degraded_blocks",
                    "watchdog_trips", "requests_retried", "retries_total",
                    "decode_blocks", "steady_state_blocks",
                    "steady_state_syncs_per_block"))
            + f"; graph captures in the engine's life "
              f"{eng.lifetime['graph_captures']}")

    def held_to(label, rs, fault_free, cut_short=()):
        """OK and DEGRADED requests emit the fault-free tokens; a request
        with a status in ``cut_short`` keeps a prefix of them."""
        for r, f in zip(rs, fault_free):
            got, want = r.output.tolist(), f.output.tolist()
            if r.status in (RequestStatus.OK, RequestStatus.DEGRADED):
                ok = got == want
            else:
                ok = r.status in cut_short and got == want[:len(got)]
            if not ok:
                raise AssertionError(f"{label}: {r.status} request "
                                     f"{got} against fault-free {want}")

    # (a) contiguous bf16: a corrupt readback of block 2 (lane 1), cancel()
    # from on_block at block 4, a NaN lane 0 at block 7 (a replay), the
    # last request's deadline 0 while it is queued, an invalid request
    fi = FaultInjector().corrupt_readback(2, lane=1).inject_nan(lane=0,
                                                                block=7)
    eng = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                        prefill_chunk=32, decode_block=8, fault_injector=fi)
    fi.armed = False
    eng.run(requests()[:2])   # warm-up: its first block is captured
    fi.armed = True
    ra = requests()
    ra[7].deadline_s = 0.0
    invalid = Request(prompt=np.array([cfg.vocab_size]), max_new_tokens=4)

    def cancel_at_4(engine, block):
        if block == 4:   # the last live request
            engine.cancel([r for r in ra
                           if r.ttft_s is not None and not r.done][-1])

    eng.on_block = cancel_at_4
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(ra + [invalid])
    wall = time.perf_counter() - t0
    count_robust()
    scenario("(a) contiguous bf16", eng, ra + [invalid], wall)
    want = {"ok": 4, "failed": 2, "cancelled": 1, "timeout": 1}
    got = {k: [r.status.value for r in ra].count(k) for k in want}
    if (got != want or invalid.status is not RequestStatus.REJECTED
            or ra[7].status is not RequestStatus.TIMEOUT
            or eng.stats["integrity_faults"] != 2
            or eng.stats["faults_injected"] != 2
            or eng.lifetime["graph_captures"] != 1):
        raise AssertionError(f"robustness (a): statuses {got}, "
                             f"{eng.stats}")
    held_to("robustness (a)", ra, reqs,
            (RequestStatus.FAILED, RequestStatus.CANCELLED,
             RequestStatus.TIMEOUT))

    # (b) the same engine: a dispatch outage past dispatch_retries at block
    # 2 degrades it; host-driven blocks, then the canary, then promotion
    # back to replays of the same graph, under the profiler
    class Readbacks(FaultInjector):
        """Counts the blocks read back: each launched its decode kernels,
        and a block whose dispatch failed after its retries is never read
        back (a degrade may also come from the watchdog, after a launch)."""
        n = 0

        def on_readback(self, blk, mask, bad_token):
            self.n += 1
            return super().on_readback(blk, mask, bad_token)

    eng.fault_injector = fi = Readbacks().dispatch_outage(
        2, eng.dispatch_retries + 1)
    trace = []   # (sched_fallbacks, repromotions) after each block
    eng.on_block = lambda e, b: trace.append(
        (e.stats["sched_fallbacks"], e.stats["repromotions"]))
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rb = eng.run(requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    count_robust()
    scenario("(b) contiguous bf16, outage", eng, rb, wall)
    replays = inside = 0
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == REPLAY:
            replays += 1
        elif is_launch(e.name):
            p = e.cpu_parent
            while p is not None and p.name != REPLAY:
                p = p.cpu_parent
            inside += p is not None
    before = sum(1 for f, _ in trace if f == 0)
    after = sum(1 for _, p in trace if p == 1)
    s = eng.stats
    log(f"  replayed blocks {replays} ({before} before the outage, {after} "
        f"after the promotion), launch calls inside them {inside}; decode "
        f"launches counted {launch_total(DECODE_COUNTERS)}, blocks read back {fi.n} of "
        f"{s['decode_blocks']}")
    if (s["sched_fallbacks"] != 1 or s["repromotions"] != 1
            or s["degraded_blocks"] < 1 or eng.lifetime["graph_captures"] != 1
            or s["steady_state_syncs_per_block"] != 0.0
            or s["steady_state_blocks"] < 1 or after < 1 or inside
            or replays != before + after
            or fi.n >= s["decode_blocks"]
            or launch_total(DECODE_COUNTERS) != fi.n * eng.decode_block * cfg.n_layers):
        raise AssertionError(f"robustness (b): replays {replays}, inside "
                             f"{inside}, trace {trace}, {s}")
    held_to("robustness (b)", rb, reqs)
    del eng
    torch.cuda.empty_cache()

    # (c) paged bf16 with prefix sharing on phase 4d's templated mix: the
    # first admission's page allocation fails (no retry for it), a NaN
    # lane 3 at block 3 retries once; audit() after every retirement
    fi = FaultInjector().fail_alloc(0).inject_nan(lane=3, block=3)
    eng = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                        prefill_chunk=32, decode_block=8, paged=True,
                        page_size=16, enable_prefix_sharing=True,
                        max_retries=1, retry_backoff_s=0.0,
                        audit_on_retire=True, fault_injector=fi)
    fi.armed = False
    eng.run(requests()[:2])   # warm-up, as in phase 4d
    fi.armed = True
    rc = templated()
    rc[0].max_retries = 0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(rc)
    wall = time.perf_counter() - t0
    count_robust()
    scenario("(c) paged bf16, prefix sharing", eng, rc, wall)
    s, audit = eng.stats, eng.audit()
    log(f"  audit after the drain {audit}; pages in use "
        f"{s['kv_pages_in_use']}, cached {s['kv_prefix_cached_pages']}, "
        f"prefix hits {s['prefix_hits']}")
    if (rc[0].status is not RequestStatus.FAILED or len(rc[0].output)
            or "allocation failed" not in rc[0].error
            or [r.retries for r in rc].count(1) != 1
            or any(r.status is not RequestStatus.OK for r in rc[1:])
            or s["integrity_faults"] != 1 or s["faults_injected"] != 2
            or s["retries_total"] != 1
            or audit["used_pages"] != audit["index_pages"]
            or s["kv_pages_in_use"] != s["kv_prefix_cached_pages"]):
        raise AssertionError(f"robustness (c): {[r.status for r in rc]}, "
                             f"{s}, {audit}")
    held_to("robustness (c)", rc, sh_reqs, (RequestStatus.FAILED,))
    del eng
    torch.cuda.empty_cache()
    log(f"robustness phase: {time.perf_counter() - t_4e:.1f} s; launches "
        f"{robust_counts}")
    for name in ("flash_chunk_prefill", "flash_chunk_prefill_paged",
                 "decode_attention", "decode_attention_paged"):
        if robust_counts[name] <= 0:
            raise AssertionError(f"robustness phase did not launch {name}")

    log(f"-- phase 4f at {time.perf_counter() - t_main:.1f} s")
    t_4f = time.perf_counter()
    # -- 4f. split-K decode and the mesh engine: the device-resident engines
    # with kv_splits=4 (every decode read split-K, plain PyTorch inside the
    # captured block, as the JAX engine's kv_splits overrides its Pallas
    # decode kernels), contiguous bf16 and paged bf16 on 25 pages, held to
    # phase 4's tokens (a differing token to the oracle's gap rule of phase
    # 5); then a (1, 1) DeviceMesh engine in an NCCL world of one, whose
    # captured block holds its gather collective; then the Fig. 6b prompt
    # attention baselines of the oracle against its kernel.
    ctx = Ctx()
    splitk_counts = dict.fromkeys(eng_counts, 0)
    splitk_gaps = []

    def splitk_engine(label, **kw):
        eng = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                            prefill_chunk=32, decode_block=8, kv_splits=4,
                            **kw)
        eng.run(requests()[:2])          # warm-up: eager block, capture
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rs = eng.run(requests())
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k, v in counts.items():
            splitk_counts[k] += v
        engine_line(f"engine, {label}, split-K 4", eng.stats)
        log(f"  launches ({label}, split-K): {counts}")
        if not (eng.ctx.kv_splits == 4 and eng._graph is not None
                and eng.lifetime["graph_captures"] == 1
                and eng.stats["steady_state_syncs_per_block"] == 0.0):
            raise AssertionError(f"{label} split-K: ctx {eng.ctx}, graph "
                                 f"{eng._graph}, lifetime {eng.lifetime}, "
                                 f"stats {eng.stats}")
        diff = 0
        for r, want in zip(rs, reqs):
            got = r.output.tolist()
            n = sum(a != b_ for a, b_ in zip(got, want.output.tolist()))
            if n or len(got) != len(want.output):
                diff += max(n, 1)
                _, g_r = reference_decode(cfg, packed, ctx, r.prompt,
                                          len(got), max_seq, torch.bfloat16,
                                          follow=r.output)
                splitk_gaps.append(max(g_r))
                if max(g_r) > TOKEN_GAP:
                    raise AssertionError(
                        f"{label} split-K tokens {got} off the oracle's "
                        f"choice by {max(g_r)} (phase 4: "
                        f"{want.output.tolist()})")
        log(f"  {label}, split-K 4: {diff} tokens differ from phase 4's "
            f"kv_splits=0 tokens (oracle gaps of the requests that differ: "
            f"{[round(g, 5) for g in splitk_gaps]}, limit {TOKEN_GAP})")
        return eng, counts

    eng, c_sk = splitk_engine("contiguous bf16")
    # a profiled window: every block after the capture one replay, no
    # kernel launch call inside it
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(requests()[:4])
        torch.cuda.synchronize()
    replays = inside = 0
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == REPLAY:
            replays += 1
        elif is_launch(e.name):
            p = e.cpu_parent
            while p is not None and p.name != REPLAY:
                p = p.cpu_parent
            inside += p is not None
    log(f"  profile, contiguous bf16 split-K: replayed blocks {replays}, "
        f"launch calls inside them {inside}, graph captures in the engine's "
        f"life {eng.lifetime['graph_captures']}")
    if inside or not replays or eng.lifetime["graph_captures"] != 1:
        raise AssertionError(f"split-K profile: {replays} replays, {inside} "
                             f"launch calls inside, "
                             f"{eng.lifetime['graph_captures']} captures")
    del eng
    eng, p_sk = splitk_engine("paged bf16, 25 pages", paged=True,
                              page_size=16, kv_pages=26)
    del eng
    torch.cuda.empty_cache()
    for label, counts, chunk in (("contiguous", c_sk, "flash_chunk_prefill"),
                                 ("paged", p_sk,
                                  "flash_chunk_prefill_paged")):
        if any(counts[k] for k in DECODE_COUNTERS) or counts[chunk] <= 0:
            raise AssertionError(f"split-K {label} engine: decode kernels "
                                 f"launched or {chunk} did not: {counts}")

    # plain split-K at phase 3's decode shape beside the decode kernel
    gen4 = torch.Generator(device=dev).manual_seed(4)
    q4 = torch.randn(4, 1, 24, 64, generator=gen4, device=dev).transpose(1, 2)
    k4, v4 = (torch.randn(4, 256, 24, 64, generator=gen4, device=dev
                          ).to(torch.bfloat16).transpose(1, 2)
              for _ in range(2))
    cl4 = torch.tensor([1, 77, 200, 256], dtype=torch.int32, device=dev)
    want4 = da_ref.decode_attention_ref(q4, k4, v4, cl4)
    err4 = (da_ops.decode_attention_splitk(q4, k4, v4, cl4, num_splits=4)
            - want4).abs().max().item()
    if not err4 <= ATTN_ATOL:
        raise AssertionError(f"split-K: max_abs_err {err4} > {ATTN_ATOL}")
    sk_ms = device_ms(lambda: da_ops.decode_attention_splitk(
        q4, k4, v4, cl4, num_splits=4), iters=3)
    b8_ms = device_ms(lambda: da_ops.decode_attention(q4, k4, v4, cl4))
    log(f"  split-K decode (plain PyTorch, K = 4) q (4, 24, 1, 64) vs bf16 "
        f"(4, 24, 256, 64), cache_len {cl4.tolist()}: device_ms "
        f"{sk_ms:.4f}, max_abs_err {err4:.3g}; decode_attention (B8) on the "
        f"same: device_ms {b8_ms:.4f}")

    # the (1, 1) mesh engine in an NCCL world of one
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = init_device_mesh("cuda", (1, 1),
                            mesh_dim_names=("data", "model"))
    eng = ServingEngine(cfg, packed, max_seq=max_seq, batch_slots=4,
                        prefill_chunk=32, decode_block=8, mesh=mesh)
    eng.run(requests()[:2])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    mreqs = eng.run(requests())
    torch.cuda.synchronize()
    for k, v in kernels.launch_counts().items():
        splitk_counts[k] += v
    engine_line("engine, contiguous bf16, mesh (1, 1)", eng.stats)
    if [r.output.tolist() for r in mreqs] != [r.output.tolist()
                                               for r in reqs]:
        raise AssertionError("mesh (1, 1) tokens differ from the "
                             "single-device engine's")
    if not (eng._graph is not None and eng.mesh_shape == (1, 1)
            and eng.stats["steady_state_syncs_per_block"] == 0.0):
        raise AssertionError(f"mesh (1, 1): {eng.stats}")
    log(f"  mesh (1, 1), NCCL world of one: tokens == single-device "
        f"engine's; graph launches a replay {eng._graph.launches}")
    del eng
    # the group stays up for phase 11's data-parallel step; main() ends it
    torch.cuda.empty_cache()

    # the Fig. 6b baselines: the live-tile and the every-tile scans (plain
    # PyTorch) against the flash prefill kernel, first as attention at
    # phase 3's prompt shape, then as the oracle's prompt attention.  The
    # logits are held like phase 5's other softmax orders: a ULP of
    # attention can move an int8 activation code by one in 12 layers
    # (section 2 of PERF.md), so 2e-3 is counted, 0.15 the limit.
    qa, ka, va = (torch.randn(1, 24, 128, 64, generator=gen4, device=dev)
                  for _ in range(3))
    flash = fp_ops.flash_prefill(qa, ka, va)
    attn_err = {}
    for attn, fn in (("skip", attention.attention_skip),
                     ("naive", attention.attention_naive)):
        attn_err[attn] = (fn(qa, ka, va, q_chunk=32, kv_chunk=32)
                          - flash).abs().max().item()
    log(f"  attention q (1, 24, 128, 64), 32-token tiles, against the flash "
        f"kernel: max_abs_err {attn_err} (tolerance {ATTN_ATOL})")
    if max(attn_err.values()) > ATTN_ATOL:
        raise AssertionError(f"attention baselines: {attn_err}")
    diffs = {"skip": [], "naive": []}
    for r in reqs:
        prompt = torch.as_tensor(r.prompt, device=dev)[None]
        outs = {a: transformer.prefill_step(
            cfg, packed, prompt, Ctx(attn=a, attn_q_chunk=32,
                                     attn_kv_chunk=32),
            transformer.init_cache(cfg, 1, max_seq, torch.float32, dev))[0]
            for a in ("kernel", "skip", "naive")}
        if not all(torch.isfinite(o).all() for o in outs.values()):
            raise AssertionError("Ctx.attn logits not finite")
        for a in diffs:
            diffs[a].append((outs[a] - outs["kernel"]).abs().max().item())
    log(f"  prefill_step, Ctx(attn=...) against attn='kernel' at f32, 32-"
        f"token tiles, per prompt: max |diff| "
        f"{ {a: [round(x, 6) for x in d] for a, d in diffs.items()} }; "
        f"within {LOGIT_TOL_EXACT}: "
        f"{ {a: sum(x <= LOGIT_TOL_EXACT for x in d) for a, d in diffs.items()} }"
        f" of {len(reqs)} (limit {LOGIT_TOL_PERTURBED})")
    if max(max(d) for d in diffs.values()) > LOGIT_TOL_PERTURBED:
        raise AssertionError(f"attention baselines' logits: {diffs}")
    log(f"split-K and mesh phase: {time.perf_counter() - t_4f:.1f} s")

    log(f"-- phase 5 at {time.perf_counter() - t_main:.1f} s")
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
    for dt, run, mc, mp in ((torch.float32, reqs32, cfg, packed),
                            (torch.bfloat16, reqs, cfg, packed),
                            ("int8 KV", reqs8, cfg, packed)):
        gaps = []
        for r in run:
            # int8 KV is judged against the bf16-cache oracle: its rounding
            # is a perturbation of the same kind as the bf16 cache's
            ref_toks, g_r = reference_decode(
                mc, mp, ctx, r.prompt, len(r.output), max_seq,
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

    log(f"-- phase 6 at {time.perf_counter() - t_main:.1f} s")
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

    # one layer at qwen2-72b's width (d 8192, f 29568): swiglu_quant on its
    # looping path, against the same dataflow on the plain versions
    qcfg = get_config("qwen2-72b")
    qd, qf = qcfg.d_model, qcfg.d_ff
    wide_mlp = nn.ModuleDict({
        n: bitlinear.pack(bitlinear.init(gen, a, b), qcfg.group_size)
        for n, (a, b) in (("gate", (qd, qf)), ("up", (qd, qf)),
                          ("down", (qf, qd)))})
    wide_w = torch.ones(qd, device=dev)
    wide_cpu = copy.deepcopy(wide_mlp).cpu()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    worst_wide = 0.0
    for m in (4, 128):
        x = torch.randn(m, qd, generator=gen, device=dev)
        y = fused_block.fused_ffn_packed(wide_mlp, wide_w, x)
        plain = fused_block.fused_ffn_packed(wide_cpu, wide_w.cpu(), x.cpu())
        if not (torch.isfinite(y).all() and y.shape == x.shape):
            raise AssertionError("wide fused FFN output not finite or of the "
                                 "wrong shape")
        diff = (y.cpu() - plain).abs().max().item() / plain.std().item()
        worst_wide = max(worst_wide, diff)
    torch.cuda.synchronize()
    ffn_wide_counts = kernels.launch_counts()
    log(f"fused FFN at qwen2-72b's width (d {qd}, f {qf}, one layer, m 4 and "
        f"128): max |fused - plain dataflow| {worst_wide:.3g} x std (limit "
        f"{FFN_PLAIN_TOL}); launches {ffn_wide_counts}")
    if worst_wide > FFN_PLAIN_TOL:
        failures.append(f"wide fused FFN differs from its plain dataflow by "
                        f"{worst_wide} x std")
    if ffn_wide_counts["swiglu_quant"] != 2 or \
            ffn_wide_counts["rmsnorm_quant"] != 2:
        failures.append(f"wide fused FFN launches {ffn_wide_counts}")
    del wide_mlp, wide_cpu

    log(f"-- phase 7 at {time.perf_counter() - t_main:.1f} s")
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

    log(f"-- phase 8 at {time.perf_counter() - t_main:.1f} s")
    # -- 8. bf16 activations: the oracle at Ctx(act_dtype=bfloat16) ---------
    # two requests at full depth with a bf16 cache: every kernel launches on
    # bf16 queries, the logits are finite and the tokens in the vocabulary;
    # each token's gap to the f32-activation oracle's choice on the same
    # history is logged (a diagnostic: bf16 rounds every activation)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    bf16_logits = []
    bf16_toks = [reference_decode(cfg, packed, Ctx(act_dtype=torch.bfloat16),
                                  r.prompt, len(r.output), max_seq,
                                  torch.bfloat16, logits=bf16_logits)[0]
                 for r in lut_reqs]
    torch.cuda.synchronize()
    bf16_counts = kernels.launch_counts()
    log(f"bf16 oracle launches: {bf16_counts}")
    gaps = [max(reference_decode(cfg, packed, Ctx(), r.prompt, len(t),
                                 max_seq, torch.bfloat16, follow=t)[1])
            for r, t in zip(lut_reqs, bf16_toks)]
    log(f"bf16 oracle tokens: {bf16_toks}; gap to the f32-activation "
        f"oracle's choice per request {[round(g, 5) for g in gaps]}")
    for name in ("tlmm", "flash_prefill", "decode_attention"):
        if bf16_counts[name] <= 0:
            failures.append(f"bf16 oracle did not launch {name}")
    if not all(torch.isfinite(x).all() and x.shape == (cfg.vocab_size,)
               for x in bf16_logits) or not all(
            0 <= tok < cfg.vocab_size for t in bf16_toks for tok in t):
        failures.append("bf16 oracle logits not finite or tokens out of "
                        "range")
    if failures:
        raise AssertionError("; ".join(failures))

    log(f"-- phase 9 at {time.perf_counter() - t_main:.1f} s")
    p9_counts, p9_failures = phase9(dev, gen, requests, max_seq)
    failures += p9_failures
    for name in ("tlmm", "flash_prefill", "flash_chunk_prefill",
                 "decode_attention"):
        if p9_counts.get(name, 0) <= 0:
            failures.append(f"phase 9 did not launch {name}")
    if failures:
        raise AssertionError("; ".join(failures))

    log(f"-- phase 10 at {time.perf_counter() - t_main:.1f} s")
    p10_counts, p10_failures = phase10(dev, gen, max_seq)
    failures += p10_failures
    for name in ("tlmm", "flash_prefill", "decode_attention"):
        if p10_counts.get(name, 0) <= 0:
            failures.append(f"phase 10 did not launch {name}")
    if failures:
        raise AssertionError("; ".join(failures))

    log(f"-- phase 11 at {time.perf_counter() - t_main:.1f} s")
    p11_counts, p11_failures = phase11(dev, requests, max_seq, smi)
    failures += p11_failures
    if failures:
        raise AssertionError("; ".join(failures))

    log(f"-- phase 12 at {time.perf_counter() - t_main:.1f} s")
    p12_counts, p12_failures = phase12(dev, requests, max_seq, smi)
    failures += p12_failures
    if failures:
        raise AssertionError("; ".join(failures))

    log(f"-- phase 13 at {time.perf_counter() - t_main:.1f} s")
    kernels.reset_launch_counts()
    failures += phase13(dev, smi)
    if any(kernels.launch_counts().values()):
        failures.append(f"phase 13 launched a port kernel: "
                        f"{kernels.launch_counts()}")
    if failures:
        raise AssertionError("; ".join(failures))

    log(f"-- phase 14 at {time.perf_counter() - t_main:.1f} s")
    kernels.reset_launch_counts()
    failures += phase14(dev, requests, smi)
    p14_counts = kernels.launch_counts()   # the single-device engines
    if p14_counts.get("tlmm", 0) <= 0:
        failures.append("phase 14 did not launch tlmm")
    if failures:
        raise AssertionError("; ".join(failures))

    log(f"-- phase 15 at {time.perf_counter() - t_main:.1f} s")
    p15_counts, p15_failures = phase15(dev, smi)
    failures += p15_failures
    if failures:
        raise AssertionError("; ".join(failures))

    log(f"-- phase 16 at {time.perf_counter() - t_main:.1f} s")
    p16_counts, p16_failures = phase16(dev, smi)
    failures += p16_failures
    if failures:
        raise AssertionError("; ".join(failures))

    for row in rows:   # each path's launches, counted around that path alone
        row["launches"] = sum(c.get(row["name"], 0) for c in (
            eng_counts, paged_counts, kv8_counts, shared_counts,
            robust_counts, splitk_counts, ora_counts, ffn_counts, lut_counts,
            bf16_counts, ffn_wide_counts, p9_counts, p10_counts, p11_counts,
            p12_counts, p14_counts, p15_counts, p16_counts))

    took = time.perf_counter() - t_main
    log(f"-- all phases done at {took:.1f} s")
    if took > ALL_PHASES_S:
        raise AssertionError(f"all phases took {took:.1f} s (gate "
                             f"{ALL_PHASES_S} s)")
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
