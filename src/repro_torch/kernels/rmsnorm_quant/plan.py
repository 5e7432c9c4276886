"""Launch plan of the fused RMSNorm + int8 quant kernel
(``csrc/rmsnorm_quant.cu`` ``rmsnorm_quant_kernel``) and the order of the
sum of squares it fixes.

A row of d values is cut into chunks of ``CHUNK`` consecutive values (16
bytes of bf16, 32 of f32) and served by one block of ``32 * warps``
threads, ``warps`` = :func:`warps_per_row` (d): thread t holds chunk t in
registers, squares and sums its values in order (every product rounded
before it is added), each warp sums its lanes by an xor butterfly (offsets
16, 8, 4, 2, 1) and the block adds the warps' sums in warp order.  The
warps are a function of d, so a row's scale and codes are the same bits
whatever m is and whether x is read by vector or scalar loads.
:func:`sum_of_squares` replays that order in torch, for any warps a row
with chunks t, t + T, ... to thread t (T threads); the kernel's f32
additions give the same bits as torch's.

One chunk a thread and one row a block took the least time at every
shape ``tools/norm_quant_plan_sweep.py`` timed with other warps a row
(more chunks a thread) and rows a block, on an H100 at 700 W (PERF.md).
Rows wider than ``MAX_D`` (more chunks than the kernel's 1024 threads) go
to the kernel's LOOP instantiation: 32 warps, thread t walking chunks t,
t + 1024, ... in order (:func:`looped`); the same replay covers it.

Pure Python apart from the replay, which imports torch when called.
"""

from __future__ import annotations

CHUNK = 8                 # values a chunk: one 16-byte bf16 load, two f32
MAX_THREADS = 1024        # the kernel's __launch_bounds__
MAX_D = CHUNK * MAX_THREADS


def n_chunks(d: int) -> int:
    return -(-d // CHUNK)


def looped(d: int) -> bool:
    """Whether a row takes the kernel's LOOP instantiation (more than one
    chunk a thread)."""
    return d > MAX_D


def warps_per_row(d: int) -> int:
    """Warps of the block that serves a row: one chunk a thread, or all 32
    for a looped row.  Raises for an empty row."""
    if d < 1:
        raise ValueError(f"rmsnorm_quant: rows of {d} values; the kernel "
                         f"takes d > 0")
    return min(-(-n_chunks(d) // 32), MAX_THREADS // 32)


def vector_ok(x_ptr: int, x_row_bytes: int, w_ptr: int, d: int) -> bool:
    """Whether every chunk of every row (and of w) starts on 16 bytes, so
    the kernel may read them with 16-byte loads; else its scalar
    instantiation reads the same chunks value by value."""
    return (d % CHUNK == 0 and x_ptr % 16 == 0 and x_row_bytes % 16 == 0
            and w_ptr % 16 == 0)


def thread_chunks(d: int, warps: int, t: int) -> list:
    """The chunks thread t of a row of ``warps`` warps holds, in its
    summation order (one, t, for the plan's warps on a row that is not
    looped)."""
    return list(range(t, n_chunks(d), 32 * warps))


def sum_of_squares(xf, warps: int):
    """(m, d) f32 -> (m, 1) f32: each row's sum of squares in the kernel's
    order for ``warps`` warps a row."""
    import torch
    m, d = xf.shape
    T = 32 * warps
    per = -(-n_chunks(d) // T)            # chunks a thread, padded with 0s
    sq = xf * xf
    sq = torch.nn.functional.pad(sq, (0, per * T * CHUNK - d))
    sq = sq.reshape(m, per, T, CHUNK)     # chunk k * T + t -> [:, k, t]
    acc = torch.zeros((m, T), dtype=torch.float32, device=xf.device)
    for k in range(per):                  # a thread's chunks, in order
        for j in range(CHUNK):
            acc = acc + sq[:, k, :, j]
    acc = acc.reshape(m, warps, 32)
    lane = torch.arange(32, device=xf.device)
    for o in (16, 8, 4, 2, 1):            # the xor butterfly of a warp
        acc = acc + acc[:, :, lane ^ o]
    total = acc[:, 0, :1]
    for w in range(1, warps):             # the warps' sums in warp order
        total = total + acc[:, w, :1]
    return total
