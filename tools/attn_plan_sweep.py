"""Time the prompt and chunk attention kernel under other launch plans.

    python3 tools/attn_plan_sweep.py

On a CUDA card: for each head dim the kernel takes (32, 64, 128) and each
number of warps a block (1-8) that ``flash_attn_kernel`` takes there
(``repro_torch/kernels/flash_prefill/plan.py``), holds the prompt, chunk and
paged chunk kernels (page sizes 16 and 5) to their plain versions at
``chip_smoke.py``'s phase-3 shapes (head dim varied), the paged one bit for
bit to the contiguous one, and times each with ``chip_smoke.device_ms``.
Prints one line per plan: its dynamic shared memory, each shape's device
microseconds and their sum; then, per head dim, the library calls' times.
``plan.WARPS`` holds the fastest warp count of each head dim; rerun this
after changing the kernel.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_plan_sweep: no CUDA device", file=sys.stderr)
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
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.flash_prefill import plan
    from repro_torch.kernels.flash_prefill import ref as fp_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(d)
    h = 24

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # (label, kernel call, plain result, contiguous result or None)
    cases = []
    q, k, v = (randn(1, 128, h, d).transpose(1, 2) for _ in range(3))
    cases.append(("prompt", lambda: fp_ops.flash_prefill(q, k, v),
                  fp_ref.flash_prefill_ref(q, k, v), None))
    b, t, S = 4, 32, 256
    off = torch.tensor([0, 37, 100, 224], dtype=torch.int32, device=dev)
    qc = randn(b, t, h, d).transpose(1, 2)
    kr, vr = (randn(b, S, h, d).to(torch.bfloat16) for _ in range(2))
    kn, vn = (randn(b, t, h, d).transpose(1, 2) for _ in range(2))
    kc, vc = kr.transpose(1, 2), vr.transpose(1, 2)
    chunk = lambda: fp_ops.flash_chunk_prefill(qc, kc, vc, kn, vn, off)  # noqa: E731
    cases.append(("chunk", chunk, fp_ref.flash_chunk_prefill_ref(
        qc, kc, vc, kn, vn, off), None))
    for ps in (16, 5):
        n = -(-S // ps)
        perm = torch.randperm(b * n, generator=torch.Generator().manual_seed(ps))
        bt = (perm + 1).reshape(b, n).to(torch.int32).to(dev)
        pools = []
        for rows in (kr, vr):
            pool = (randn(1 + b * n, ps, h, d) * 100).to(torch.bfloat16)
            pad = torch.cat([rows, torch.zeros(b, n * ps - S, h, d, device=dev,
                                               dtype=rows.dtype)], dim=1)
            pool[bt.long()] = pad.reshape(b, n, ps, h, d)
            pools.append(pool)
        args = (qc, pools[0], pools[1], bt, off, kn, vn)
        cases.append((f"paged {ps}",
                      lambda a=args: fp_ops.flash_chunk_prefill_paged(*a),
                      fp_ref.flash_chunk_prefill_paged_ref(*args), chunk))

    saved = plan.WARPS[d]
    try:
        for warps in range(1, plan.MAX_WARPS + 1):
            smem = plan.smem_bytes(d, warps)
            if smem > plan.MAX_SMEM:
                continue
            plan.WARPS[d] = warps
            total, parts = 0.0, []
            for label, fn, want, contiguous in cases:
                got = fn()
                err = (got - want).abs().max().item()
                if not err <= ATTN_ATOL:
                    raise AssertionError(f"d={d} warps {warps} {label}: "
                                         f"max_abs_err {err}")
                if contiguous is not None and not torch.equal(got,
                                                              contiguous()):
                    raise AssertionError(f"d={d} warps {warps} {label}: "
                                         "paged != contiguous")
                ms = device_ms(fn)
                total += ms
                parts.append(f"{label} {ms * 1e3:.1f}")
            print(f"d={d} warps {warps}: smem {smem} B; us "
                  f"{'; '.join(parts)}; sum {total:.4f} ms", flush=True)
    finally:
        plan.WARPS[d] = saved

    sdpa = torch.nn.functional.scaled_dot_product_attention
    kf, vf = (fp_ref.overlay_chunk(x, y, off) for x, y in ((kc, kn), (vc, vn)))
    qpos = off[:, None].long() + torch.arange(t, device=dev)
    cmask = (torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None]
             )[:, None]
    print(f"d={d} library: prompt {device_ms(lambda: sdpa(q, k, v, is_causal=True)) * 1e3:.1f} us; "
          f"chunk {device_ms(lambda: sdpa(qc, kf, vf, attn_mask=cmask)) * 1e3:.1f} us",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
