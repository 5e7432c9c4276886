"""Time the RMS-MAX and SwiGLU requant kernels across row widths.

    python3 tools/norm_quant_plan_sweep.py

On a CUDA card, with ``chip_smoke.device_ms`` (device time per call, the
stream held), at m = 1, 4 and 128 rows:

- ``rmsnorm_quant`` at d = 1024 (qwen1.5-0.5b), 1536 (bitnet-0.73b) and
  2048 to 8192 (the widest row the kernel takes), x bf16 and f32 with an
  f32 weight: one block a row of ``plan.warps_per_row(d)`` warps
  (``kernels/rmsnorm_quant/plan.py``), every call held bit for bit to the
  plain version summing in the kernel's order;
- ``swiglu_quant`` at f = 2816 and 4096 (the port's models), 8192 (the
  widest row kept in registers), 8196 (the narrowest staged in shared
  memory), 11008, 14336 and 28672 (7B, 8B and 70B models' FFNs): one block
  a row of ``plan.threads(f)`` threads (``kernels/swiglu_quant/plan.py``),
  every call bit for bit the plain version.

One line per (kernel, width): the layout, each shape's microseconds and
their sum.  Prints the card's name and power limit first and the empty
kernel's time (the launch floor) last.  Rerun after changing either
kernel.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (1, 4, 128)
NORM_WIDTHS = (1024, 1536, 2048, 4096, 8192)
FFN_WIDTHS = (2816, 4096, 8192, 8196, 11008, 14336, 28672)


def main() -> int:
    if not torch.cuda.is_available():
        print("norm_quant_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from chip_smoke import device_ms
    from repro_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.load()
    for d in NORM_WIDTHS:
        time_rmsnorm(d, device_ms)
    for f in FFN_WIDTHS:
        time_swiglu(f, device_ms)
    stream = torch.cuda.current_stream().cuda_stream
    floor = device_ms(lambda: build.check(
        build.load().repro_empty_launch(stream), "repro_empty_launch"))
    print(f"launch floor: empty kernel {floor * 1e3:.2f} us", flush=True)
    return 0


def time_rmsnorm(d: int, device_ms) -> None:
    from repro_torch.kernels.rmsnorm_quant import kernel, plan, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(d)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    warps = plan.warps_per_row(d)
    parts, total = [], 0.0
    for m in ROWS:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(m, d, generator=gen, device=dev) * 3).to(dt)
            want = ref.rmsnorm_quant_ref(x, w, warps=warps)
            got = kernel.rmsnorm_quant_cuda(x, w, eps=1e-5)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"rmsnorm_quant d={d} m={m} {dt}: "
                                     "differs from its replay")
            ms = device_ms(lambda x=x: kernel.rmsnorm_quant_cuda(x, w,
                                                                 eps=1e-5))
            total += ms
            parts.append(f"m={m} {str(dt)[6:]} {ms * 1e3:.2f}")
    print(f"rmsnorm_quant d={d} warps={warps}: us {'; '.join(parts)}; "
          f"sum {total:.4f} ms", flush=True)


def time_swiglu(f: int, device_ms) -> None:
    from repro_torch.kernels.swiglu_quant import kernel, plan, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(f)
    parts, total = [], 0.0
    for m in ROWS:
        gate, up = (torch.randint(-3000, 3000, (m, f), generator=gen,
                                  device=dev, dtype=torch.int32)
                    for _ in range(2))
        gs, us = (torch.rand(m, generator=gen, device=dev) * 1e-3
                  for _ in range(2))
        want = ref.swiglu_quant_ref(gate, up, gs[:, None], us[:, None])
        got = kernel.swiglu_quant_cuda(gate, up, gs, us)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"swiglu_quant f={f} m={m}: differs from "
                                 "the plain version")
        ms = device_ms(lambda a=(gate, up, gs, us):
                       kernel.swiglu_quant_cuda(*a))
        total += ms
        parts.append(f"m={m} {ms * 1e3:.2f}")
    layout = "shared memory" if plan.staged(f) else "registers"
    print(f"swiglu_quant f={f} {plan.threads(f)} threads {layout}: us "
          f"{'; '.join(parts)}; sum {total:.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
