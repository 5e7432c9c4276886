"""Launch plan of the decode attention kernel (``csrc/decode_attention.cu``
``decode_attn_kernel``) and the partition of keys it walks.

Pure Python on purpose: the CPU tests replay the partition and check that
every live key of every slot is visited by exactly one warp, and that the
visit does not depend on the batch, the cache's row count, the page size
or the other slots' lengths.  The kernel maps its warp index to tiles
exactly as :func:`slot_tiles` and :func:`unit_tiles` do.

Each (slot, head) is served by one block of ``W`` warps.  Keys are cut into
tiles of ``TK`` (one key a lane) at absolute positions: tile ``kt`` holds
keys ``[kt * TK, (kt + 1) * TK)``.  Warp ``w`` takes the tiles with
``kt % W == w`` in increasing order, with its own online softmax state, and
the warps merge in warp order.  ``W`` is a constant of the head dim:
nothing else moves a key to another warp or changes a merge.
"""

from __future__ import annotations

TK = 32                      # keys a tile: one a lane
MAX_WARPS = 8                # the kernel's __launch_bounds__
MAX_SMEM = 232448            # dynamic shared memory a block may take (H100)
KV_BYTES = (4, 2, 1)         # the element sizes the kernel reads: f32, bf16, int8

# head dim -> warps a block W: at each head dim the W with the least time
# summed over chip_smoke.py's phase-3 decode shapes and the oracle's
# single-slot shape, of W in 1, 2, 4, 8 where the block fits, as timed by
# tools/decode_plan_sweep.py on an H100 at 700 W (the sweep table in
# PERF.md).  At d = 128 f32 rows leave room for at most 6 warps.
PLAN = {32: 8, 64: 8, 128: 4}


def smem_bytes(d: int, kv_bytes: int, warps: int) -> int:
    """Dynamic shared memory of a block, as ``smem_bytes`` in the kernel's
    source computes it: the query (f32), then per warp a K and a V tile of
    rows in their own type, each row padded by 16 bytes (32 lanes reading
    16 bytes of 32 rows meet 32 banks), the tile's row sources (a K and a V
    pointer a key), its V scales and its probabilities; then each warp's
    (acc, m, l)."""
    row = d * kv_bytes + 16
    per_warp = 2 * TK * row + 2 * TK * 8 + 2 * TK * 4
    return d * 4 + warps * per_warp + warps * (d + 2) * 4


def check_plan(d: int, warps: int) -> None:
    """Raise on a warp count the kernel does not take at head dim d (for
    any of the element types it reads)."""
    if not (1 <= warps <= MAX_WARPS
            and all(smem_bytes(d, kb, warps) <= MAX_SMEM for kb in KV_BYTES)):
        raise ValueError(f"decode attention: {warps} warps at head dim {d} "
                         "is not a plan the kernel takes")


def slot_tiles(cache_len: int, S: int, window: int | None = None) -> range:
    """The key tiles a (slot, head) walks: from the tile of the window's
    first key to the tile of the last live key, min(cache_len, S) - 1."""
    n_keys = min(cache_len, S)
    lo = max(0, cache_len - window) if window is not None else 0
    return range(lo // TK, -(-n_keys // TK))


def unit_tiles(tiles: range, warp: int, warps: int) -> range:
    """The tiles of ``tiles`` that warp ``warp`` of ``warps`` walks, in its
    order."""
    first = tiles.start + (warp - tiles.start % warps) % warps
    return range(first, tiles.stop, warps)


def live(key: int, cache_len: int, S: int, window: int | None = None) -> bool:
    """Whether a slot of live length ``cache_len`` attends ``key``."""
    lo = max(0, cache_len - window) if window is not None else 0
    return lo <= key < min(cache_len, S)
