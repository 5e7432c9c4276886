"""Time the decode attention kernel under other launch plans.

    python3 tools/decode_plan_sweep.py

On a CUDA card: for each head dim the kernel takes (32, 64, 128) and each
warp count W a block in 1, 2, 4, 6, 8 that fits there
(``repro_torch/kernels/decode_attention/plan.py``), holds the
contiguous, paged and paged int8 decode kernels (page sizes 16 and 5) to
their plain versions at ``chip_smoke.py``'s phase-3 shapes (4 slots, 24
heads, a 256-row bf16 cache, lengths 1, 77, 200, 256; head dim varied), the
paged ones bit for bit to the contiguous one on the same rows, and times
each with ``chip_smoke.device_ms``, with the oracle's single slot (lengths 77
and 200) apart, and one slot of 2000 keys in a 2048-row cache (a long
context, where a slot's tiles outnumber a block's warps) apart again.
Prints one line per warp count: each shape's device microseconds, the sum of the
phase-3 shapes, the sum of the single-slot ones and the long slot; then,
per head dim, the library calls' times.  ``plan.PLAN`` holds, for each head
dim, the warp count with the least phase-3 plus single-slot time; rerun
this after changing the kernel.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARPS = (1, 2, 4, 6, 8)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from repro_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.load()
    for d in (32, 64, 128):
        sweep(d)
    return 0


def sweep(d: int) -> None:
    """The sweep's lines at head dim d."""
    from chip_smoke import ATTN_ATOL, device_ms
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import plan
    from repro_torch.kernels.decode_attention import ref as da_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(d)
    b, h, S = 4, 24, 256

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def pooled(rows, ps, fill):
        n = -(-S // ps)
        perm = torch.randperm(b * n, generator=torch.Generator().manual_seed(ps))
        bt = (perm + 1).reshape(b, n).to(torch.int32).to(dev)
        pool = fill((1 + b * n, ps) + tuple(rows.shape[2:]))
        pad = torch.cat([rows, fill((b, n * ps - S) + tuple(rows.shape[2:]))],
                        dim=1)
        pool[bt.long()] = pad.reshape((b, n, ps) + tuple(rows.shape[2:]))
        return pool, bt

    def junk(shape):
        return (randn(*shape) * 100).to(torch.bfloat16)

    def ints(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.05

    cl = torch.tensor([1, 77, 200, 256], dtype=torch.int32, device=dev)
    q = randn(b, 1, h, d).transpose(1, 2)
    kr, vr = (randn(b, S, h, d).to(torch.bfloat16) for _ in range(2))
    kc, vc = kr.transpose(1, 2), vr.transpose(1, 2)
    ki, vi = ints((b, S, h, d)), ints((b, S, h, d))
    ks, vs = scales((b, S, h)), scales((b, S, h))
    kd, vd = (da_ref.dequant_bf16(x, y).transpose(1, 2)
              for x, y in ((ki, ks), (vi, vs)))

    # (label, kernel call, plain result, the contiguous call it must equal)
    contiguous = lambda: da_ops.decode_attention(q, kc, vc, cl)  # noqa: E731
    cases = [("contiguous", contiguous,
              da_ref.decode_attention_ref(q, kc, vc, cl), None)]
    for ps in (16, 5):
        (kp, bt), (vp, _) = pooled(kr, ps, junk), pooled(vr, ps, junk)
        args = (q, kp, vp, bt, cl)
        cases.append((f"paged {ps}",
                      lambda a=args: da_ops.decode_attention_paged(*a),
                      da_ref.paged_decode_attention_ref(*args), contiguous))
    for ps in (16, 5):
        (kp, bt), (vp, _) = pooled(ki, ps, ints), pooled(vi, ps, ints)
        (ksp, _), (vsp, _) = pooled(ks, ps, scales), pooled(vs, ps, scales)
        args = (q, kp, vp, ksp, vsp, bt, cl)
        cases.append((
            f"int8 {ps}",
            lambda a=args: da_ops.decode_attention_paged_quant(*a),
            da_ref.paged_decode_attention_quant_ref(*args),
            lambda: da_ops.decode_attention(q, kd, vd, cl)))
    singles = []
    for n in (77, 200):
        one = torch.tensor([n], dtype=torch.int32, device=dev)
        args = (q[:1], kc[:1], vc[:1], one)
        singles.append((f"one slot {n}",
                        lambda a=args: da_ops.decode_attention(*a),
                        da_ref.decode_attention_ref(*args), None))
    kl, vl = (randn(1, 2048, h, d).to(torch.bfloat16).transpose(1, 2)
              for _ in range(2))
    args = (q[:1], kl, vl, torch.tensor([2000], dtype=torch.int32,
                                        device=dev))
    long_slot = [("long slot 2000",
                  lambda a=args: da_ops.decode_attention(*a),
                  da_ref.decode_attention_ref(*args), None)]

    saved = plan.PLAN[d]
    try:
        for warps in WARPS:
            try:
                plan.check_plan(d, warps)
            except ValueError:
                continue
            plan.PLAN[d] = warps
            sums, parts = [0.0, 0.0, 0.0], []
            for i, group in enumerate((cases, singles, long_slot)):
                for label, fn, want, same in group:
                    got = fn()
                    err = (got - want).abs().max().item()
                    if not err <= ATTN_ATOL:
                        raise AssertionError(f"d={d} {warps} warps {label}: "
                                             f"max_abs_err {err}")
                    if same is not None and not torch.equal(got, same()):
                        raise AssertionError(f"d={d} {warps} warps {label}: "
                                             "differs from the contiguous "
                                             "kernel")
                    ms = device_ms(fn)
                    sums[i] += ms
                    parts.append(f"{label} {ms * 1e3:.1f}")
            print(f"d={d} {warps} warps: us {'; '.join(parts)}; phase-3 sum "
                  f"{sums[0]:.4f} ms, one-slot sum {sums[1]:.4f} ms, long "
                  f"slot {sums[2]:.4f} ms", flush=True)
    finally:
        plan.PLAN[d] = saved

    sdpa = torch.nn.functional.scaled_dot_product_attention
    kf, vf = kc.float(), vc.float()
    mask = (torch.arange(S, device=dev)[None, :] < cl[:, None])[:, None, None]
    one_slot = sum(device_ms(lambda n=n: sdpa(q[:1], kf[:1, :, :n],
                                              vf[:1, :, :n]))
                   for n in (77, 200))
    kfl, vfl = kl[:, :, :2000].float(), vl[:, :, :2000].float()
    print(f"d={d} library: 4 slots {device_ms(lambda: sdpa(q, kf, vf, attn_mask=mask)) * 1e3:.1f} us; "
          f"one-slot sum {one_slot * 1e3:.1f} us; long slot "
          f"{device_ms(lambda: sdpa(q[:1], kfl, vfl)) * 1e3:.1f} us", flush=True)


if __name__ == "__main__":
    sys.exit(main())
