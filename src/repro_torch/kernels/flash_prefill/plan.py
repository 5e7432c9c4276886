"""Launch plan of the prompt and chunk attention kernel
(``csrc/flash_prefill.cu`` ``flash_attn_kernel``) and the partition of keys
it walks.

Pure Python on purpose: the CPU tests replay the partition and check that
every live (query row, key) pair is visited by exactly one warp, and that a
prompt and any chunking of it give each pair the same key tile and warp.
The kernel maps ``blockIdx`` and its warp index to tiles exactly as
:func:`block_tiles` and :func:`warp_tiles` do.

A block owns ``BQ`` query rows of one (batch row, head): the m16 of the
tensor-core instruction, every row in every warp.  Keys are cut into tiles of
``BK`` at absolute positions (tile ``kt`` holds keys
``[kt * BK, (kt + 1) * BK)``), and warp ``w`` of ``warps`` takes the tiles
with ``kt % warps == w``, each warp keeping its own online softmax state;
the warps merge once, by log-sum-exp, in warp order.
"""

from __future__ import annotations

BQ = 16                      # query rows a block
BK = 16                      # keys a tile
MAX_WARPS = 8
MAX_SMEM = 232448            # dynamic shared memory a block may take (H100)

# head dim -> warps a block, each the fastest of 1-8 warps in
# tools/attn_plan_sweep.py at chip_smoke.py's phase-3 shapes
WARPS = {32: 8, 64: 8, 128: 4}


def smem_bytes(d: int, warps: int) -> int:
    """Dynamic shared memory of a block, as ``smem_bytes`` in the kernel's
    source computes it: the query tile's TF32 high and low parts, then per
    warp its tile's row sources (a K and a V pointer a key) and its K and V
    tile of f32 rows padded to d + 4 floats."""
    row = (d + 4) * 4
    return 2 * BQ * row + warps * (2 * BK * 8 + 2 * BK * row)


def check_warps(d: int, warps: int) -> None:
    """Raise on a warp count the kernel does not take at head dim d."""
    if not (1 <= warps <= MAX_WARPS and smem_bytes(d, warps) <= MAX_SMEM):
        raise ValueError(f"flash attention: {warps} warps a block at head "
                         f"dim {d} is not a plan the kernel takes")


def block_tiles(q_row0: int, t: int, S: int, offset: int,
                window: int | None = None) -> range:
    """The key tiles the block whose first query row is chunk row ``q_row0``
    walks: from the tile of the window's first key of that row to the tile
    of the causal frontier of its last row, cut at the cache's ``S`` rows
    and the chunk's last live key ``offset + t``."""
    q_start = offset + q_row0
    k_end = min(S, offset + t, q_start + BQ)
    k_begin = max(0, q_start - window + 1) if window else 0
    return range(k_begin // BK, -(-k_end // BK))


def warp_tiles(tiles: range, warp: int, warps: int) -> range:
    """The tiles of ``tiles`` that warp ``warp`` walks, in its order."""
    first = tiles.start + (warp - tiles.start % warps) % warps
    return range(first, tiles.stop, warps)


def live(qpos: int, key: int, S: int, window: int | None = None) -> bool:
    """Whether the query at absolute position ``qpos`` attends ``key``."""
    return key < S and key <= qpos and (not window or key > qpos - window)
