"""Launch plan of the fused SwiGLU dequant/requant kernel
(``csrc/swiglu_quant.cu`` ``swiglu_quant_kernel``) and the partition of a
row it walks.

One block serves a row of f values, cut into chunks of ``CHUNK`` (one
16-byte load of int32): thread t of T holds chunks t, t + T, ...  A thread
computes its values' h once and keeps them in registers, or, where a row
needs more than ``KMAX`` chunks a thread at ``MAX_THREADS`` threads, in
shared memory; the block meets in one maximum and each thread quantizes
its own values.  A maximum does not depend on its order and every value's
arithmetic is its own, so the layout changes no bit.

The layout follows f alone, as the C launch computes it (:func:`threads`,
:func:`staged`, :func:`looped`): rows up to ``MAX_REGISTER_F`` (8192)
values stay in registers, rows up to :data:`MAX_F` (29040) are staged,
wider ones (qwen2-72b's 29568) are looped: the same partition read from
global memory twice, h and the maximum, then h again and the codes.  ``THREADS`` = 512 a block took the least time at f = 4096 and
2816, m = 1, 4 and 128, on an H100 at 700 W (PERF.md, the sweep table of
``tools/norm_quant_plan_sweep.py``), against 128-1024 threads, the
shared-memory path and a row split over a thread-block cluster of 2, 4 or
8 blocks.

Pure Python on purpose: the CPU tests replay the partition and check that
every value of a row is visited exactly once.
"""

from __future__ import annotations

CHUNK = 4                 # int32 values a 16-byte load
THREADS = 512             # a block, while KMAX chunks a thread do
MAX_THREADS = 1024        # the kernel's __launch_bounds__
KMAX = 2                  # chunks a thread holds in registers
MAX_SMEM = 232448         # shared memory a block may take (H100)
STATIC_SMEM = 4 * (MAX_THREADS // 32)   # the block maximum's exchange
MAX_REGISTER_F = CHUNK * KMAX * MAX_THREADS
MAX_F = CHUNK * ((MAX_SMEM - STATIC_SMEM) // (2 * 16))


def n_chunks(f: int) -> int:
    return -(-f // CHUNK)


def threads(f: int) -> int:
    """Threads a block: one a chunk up to THREADS, whole warps; a row that
    would then need more than KMAX chunks a thread takes up to
    MAX_THREADS."""
    n = n_chunks(f)
    t = min(THREADS, 32 * -(-n // 32))
    if -(-n // t) > KMAX:
        t = min(MAX_THREADS, 32 * -(-n // (32 * KMAX)))
    return t


def looped(f: int) -> bool:
    """Whether a row is too wide for shared memory and is read twice."""
    return f > MAX_F


def staged(f: int) -> bool:
    """Whether a row stays in shared memory, not registers."""
    return -(-n_chunks(f) // threads(f)) > KMAX and not looped(f)


def smem_bytes(f: int) -> int:
    """Dynamic shared memory of a block on the shared-memory path: its
    gate and up chunks, 16 bytes each."""
    return 2 * 16 * n_chunks(f)


def check(f: int) -> None:
    """Raise on a row width the kernel does not take (an empty row)."""
    if f < 1:
        raise ValueError(f"swiglu_quant: rows of {f} values; the kernel "
                         f"takes f > 0")


def vector_ok(ptrs, row_bytes, f: int) -> bool:
    """Whether every chunk of gate and up starts on 16 bytes (their data
    pointers and row strides in bytes), so the kernel may read them 16
    bytes at a time and store 4 codes at once; else its scalar
    instantiation reads and writes the same chunks value by value."""
    return (f % CHUNK == 0 and all(p % 16 == 0 for p in ptrs)
            and all(s % 16 == 0 for s in row_bytes))


def thread_chunks(f: int, t: int) -> list:
    """The chunks thread t holds, in its order."""
    return list(range(t, n_chunks(f), threads(f)))
