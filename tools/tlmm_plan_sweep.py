"""Time the ternary matmul kernels under other launch-plan targets.

    python3 tools/tlmm_plan_sweep.py

On a CUDA card: for each setting of the block targets in
``repro_torch/kernels/tlmm/plan.py`` (``*_BLOCKS_PER_SM``, ``*_MIN_PER``),
times ``tlmm`` and ``tlmm_lut`` at ``chip_smoke.py``'s phase-3 shapes (g = 5
and 3; m = 4 and 128, plus m = 1) with ``chip_smoke.device_ms``, after
checking each result against ``tlmm_ref``.  Prints one line per setting:
the summed device ms and each shape's microseconds.  The plan's own values
are the ones these lines chose; rerun it after changing either kernel.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("tlmm_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from chip_smoke import device_ms
    from repro_torch.core import bitlinear, ternary
    from repro_torch.kernels.tlmm import ops as tlmm_ops
    from repro_torch.kernels.tlmm import plan
    from repro_torch.kernels.tlmm import ref as tlmm_ref
    from repro_torch.kernels.tlmm_lut import ops as lut_ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for g in (5, 3):
        for m in (1, 4, 128):
            for n, k in ((1536, 1536), (1536, 4096), (4096, 1536)):
                w = torch.randint(-1, 2, (n, k), generator=gen, device=dev,
                                  dtype=torch.int8)
                codes = ternary.pack_ternary(w, g, bitlinear.ROW_MULTIPLE)
                a = torch.randint(-127, 128, (m, n), generator=gen,
                                  device=dev, dtype=torch.int8)
                cases.append((g, m, a, codes, tlmm_ref.tlmm_ref(a, codes, g,
                                                                n)))

    def run(label, fn, ms):
        total, parts = 0.0, []
        for g, m, a, codes, want in cases:
            if m not in ms:
                continue
            if not torch.equal(fn(a, codes, g), want):
                raise AssertionError(f"{label}: g={g} m={m} wrong")
            t = device_ms(lambda: fn(a, codes, g))
            total += t
            parts.append(f"{t * 1e3:.1f}")
        print(f"{label}: sum {total:.4f} ms; us per shape {parts}",
              flush=True)

    tlmm = lambda a, c, g: tlmm_ops.tlmm(a, c, g=g)   # noqa: E731
    lut = lambda a, c, g: lut_ops.tlmm_lut(a, c, g=g)  # noqa: E731
    saved = {k: getattr(plan, k) for k in (
        "MMA_BLOCKS_PER_SM", "DECODE_BLOCKS_PER_SM", "DECODE_MIN_PER",
        "LUT_BLOCKS_PER_SM", "LUT_MIN_PER")}
    try:
        for x in (1, 2, 3, 4):
            plan.MMA_BLOCKS_PER_SM = x
            run(f"tlmm mma, MMA_BLOCKS_PER_SM {x}", tlmm, (128,))
        plan.MMA_BLOCKS_PER_SM = saved["MMA_BLOCKS_PER_SM"]
        for x in (1, 2, 4):
            for mp in (8, 16, 32):
                plan.DECODE_BLOCKS_PER_SM, plan.DECODE_MIN_PER = x, mp
                run(f"tlmm dp4a, DECODE_BLOCKS_PER_SM {x} DECODE_MIN_PER "
                    f"{mp}", tlmm, (1, 4))
        plan.DECODE_BLOCKS_PER_SM = saved["DECODE_BLOCKS_PER_SM"]
        plan.DECODE_MIN_PER = saved["DECODE_MIN_PER"]
        for x in (2, 3, 4):
            for mp in (4, 8):
                plan.LUT_BLOCKS_PER_SM, plan.LUT_MIN_PER = x, mp
                run(f"tlmm_lut, LUT_BLOCKS_PER_SM {x} LUT_MIN_PER {mp}", lut,
                    (1, 4, 128))
    finally:
        for k, v in saved.items():
            setattr(plan, k, v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
