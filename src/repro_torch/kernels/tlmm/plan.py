"""Launch plans of the two ternary matmul kernels (``csrc/tlmm.cu``,
``csrc/tlmm_lut.cu``): which tile a block owns and how the reduction is
split over blocks.

Pure Python on purpose: the CPU tests replay a plan's partition and check
that it covers every (row, column, group) once.  The kernels read the same
fields (``rows``, ``cols``, ``per``, ``split``) and map ``blockIdx`` to a
tile exactly as ``Plan.blocks`` does.  Partial sums of a split reduction
meet in a zeroed int32 output through integer atomics, exact in any order
(weights are -1, 0 or 1 and |sum| <= n * 128 < 2^31).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

# tlmm, decode regime (m <= DECODE_MAX_M): the __dp4a kernel, 128 columns a
# block (4 a thread, one warp wide), its 8 warps sharing a split's code rows
DECODE_MAX_M = 16
DECODE_ROWS = (1, 4, 8, 16)      # row bounds the kernel is instantiated for
DECODE_COLS = 128
DECODE_MIN_PER = 16              # code rows a split owns at least
DECODE_BLOCKS_PER_SM = 2         # blocks in flight the split aims for
# tlmm, prefill regime (m > DECODE_MAX_M): the int8 mma.sync kernel on 64 x 64
# tiles, walking the reduction in steps of MMA_STEP code rows
MMA_ROWS = 64
MMA_COLS = 64
MMA_STEP = 32
MMA_BLOCKS_PER_SM = 2
# tlmm_lut: BM rows' tables side by side (2 int16 entries a 32-bit word),
# 1024 columns a block (4 a thread), at least LUT_MIN_PER groups a split
LUT_ROWS = (2, 4, 8)
LUT_COLS = 1024
LUT_MIN_PER = 8
LUT_BLOCKS_PER_SM = 3


@dataclass(frozen=True)
class Plan:
    """A grid of (ceil(k / cols), ceil(m / rows), split) blocks; block
    (x, y, z) owns activation rows [y * rows, (y + 1) * rows), output
    columns [x * cols, (x + 1) * cols) and code rows (groups)
    [z * per, (z + 1) * per), each cut at m, k and n_groups."""
    kernel: str      # "dp4a", "mma" (tlmm) or "lut" (tlmm_lut)
    m: int
    k: int
    n_groups: int    # ceil(n / g): the code rows the reduction reads
    rows: int
    cols: int
    per: int
    split: int

    @property
    def grid(self) -> tuple:
        return (-(-self.k // self.cols), -(-self.m // self.rows), self.split)

    @property
    def atomic(self) -> bool:
        """Blocks add into a zeroed output (else each stores its tile)."""
        return self.split > 1

    def blocks(self):
        """(row_lo, row_hi, col_lo, col_hi, group_lo, group_hi) of every
        block, z slowest, as the kernels' blockIdx reads them."""
        gx, gy, gz = self.grid
        for z in range(gz):
            for y in range(gy):
                for x in range(gx):
                    yield (y * self.rows, min(self.m, (y + 1) * self.rows),
                           x * self.cols, min(self.k, (x + 1) * self.cols),
                           z * self.per,
                           min(self.n_groups, (z + 1) * self.per))


def _split(n_groups: int, tiles: int, blocks: int, min_per: int,
           step: int = 1) -> tuple:
    """(per, split): split the groups until some ``blocks`` blocks are in
    flight, each owning at least min_per groups, per a multiple of step; no
    split is empty, and no groups give no split."""
    if n_groups == 0:
        return step, 0
    want = max(1, -(-blocks // tiles))
    most = max(1, n_groups // max(min_per, step))
    split = min(want, most)
    per = -(-n_groups // split)
    per = -(-per // step) * step
    return per, -(-n_groups // per)


def plan_tlmm(m: int, n: int, k: int, g: int, sms: int) -> Plan:
    """Plan of ``tlmm`` for (m, n) activations against (>= n/g, k) codes
    (n: the reduction length)."""
    n_groups = -(-n // g)
    if m <= DECODE_MAX_M:
        rows = next(r for r in DECODE_ROWS if r >= m)
        per, split = _split(n_groups, -(-k // DECODE_COLS),
                            DECODE_BLOCKS_PER_SM * sms, DECODE_MIN_PER)
        return Plan("dp4a", m, k, n_groups, rows, DECODE_COLS, per, split)
    tiles = -(-k // MMA_COLS) * -(-m // MMA_ROWS)
    per, split = _split(n_groups, tiles, MMA_BLOCKS_PER_SM * sms, MMA_STEP,
                        MMA_STEP)
    return Plan("mma", m, k, n_groups, MMA_ROWS, MMA_COLS, per, split)


def plan_tlmm_lut(m: int, n: int, k: int, g: int, sms: int) -> Plan:
    """Plan of ``tlmm_lut`` (same operands as ``plan_tlmm``)."""
    n_groups = -(-n // g)
    rows = next((r for r in LUT_ROWS if r >= m), LUT_ROWS[-1])
    tiles = -(-k // LUT_COLS) * -(-m // rows)
    per, split = _split(n_groups, tiles, LUT_BLOCKS_PER_SM * sms,
                        LUT_MIN_PER)
    return Plan("lut", m, k, n_groups, rows, LUT_COLS, per, split)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count, read once per device."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count
