"""Public wrappers of the decode attention kernels (counterparts of
``repro/kernels/decode_attention/ops.py::decode_attention``,
``::decode_attention_paged`` and ``::decode_attention_paged_quant``).  The
kernels stop at each slot's live length, so the cache is never padded; a
CUDA tensor launches the kernel, a CPU tensor takes the plain version.

The split-K functions below (``splitk_partials``, ``splitk_combine``,
``validate_num_splits``, ``decode_attention_splitk``,
``decode_attention_splitk_sharded``, and ``shard_decode``, the read of a
cache split on its sequence over a mesh axis) are the counterparts of the
JAX package's flash-decoding, which is plain ``jnp`` there, not a Pallas
kernel.  They are plain PyTorch here too, on either device, by design: no
kernel of the port is behind them.  Their one contract is bitwise: the
partials of chunks [i, i + n) equal those rows of one call over all K
chunks, because every chunk is computed by a program of the same shape on
a fresh contiguous copy (a loop over chunks, never one batched product
whose kernel, and so summation order, could change with the batch
extent), and the combine sums over the whole K-long chunk axis in chunk
order.  So a rank of a ``torch.distributed`` group that computes its own
run of chunks and all-gathers the partials in rank order gets the bits of
the single-device call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import on_card, per_row
from repro_torch.kernels.decode_attention import kernel, ref
from repro_torch.runtime import sharding

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len, *, window: int | None = None) -> torch.Tensor:
    """Single-token GQA attention against a partially filled cache.
    q: (b, h, 1, d); k, v: (b, kv_h, S, d); cache_len: int or (b,) live
    lengths (ragged continuous batch); with ``window``, only the last
    ``window`` live positions of each row are attended, and on a bf16
    cache the probabilities are rounded to bf16 before P.V: the JAX
    model's windowed contiguous read (its XLA decode, the Pallas kernel
    taking no window)."""
    cl = per_row(cache_len, q)
    if on_card(q, "decode_attention"):
        return kernel.decode_attention_cuda(q, k, v, cl, window=window)
    if window is not None and v.dtype == torch.bfloat16:
        return ref.decode_attention_rounded_ref(q, k, v, cl, window=window)
    return ref.decode_attention_ref(q, k, v, cl, window=window)


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           cache_len, *, window: int | None = None
                           ) -> torch.Tensor:
    """Single-token GQA attention against a paged cache.  q: (b, h, 1, d);
    k_pool, v_pool: (P, ps, kv_h, d), the page pool every slot shares;
    block_tables: (b, n_pages) int32 page ids (dead entries name the null
    page 0); cache_len: int or (b,) live lengths."""
    cl = per_row(cache_len, q)
    if on_card(q, "decode_attention_paged"):
        return kernel.decode_attention_paged_cuda(q, k_pool, v_pool,
                                                  block_tables, cl,
                                                  window=window)
    return ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tables, cl,
                                          window=window)


def decode_attention_paged_quant(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 k_scale_pool: torch.Tensor,
                                 v_scale_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 cache_len, *, window: int | None = None
                                 ) -> torch.Tensor:
    """As :func:`decode_attention_paged` on int8 pools with their
    (P, ps, kv_h) f32 per-(token, head) scale planes; values dequantize
    through bf16, as the contiguous int8 cache's decode read."""
    cl = per_row(cache_len, q)
    if on_card(q, "decode_attention_paged_quant"):
        return kernel.decode_attention_paged_quant_cuda(
            q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, cl,
            window=window)
    return ref.paged_decode_attention_quant_ref(
        q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, cl,
        window=window)


# ---------------------------------------------------------------------------
# Split-K (flash-decoding), plain PyTorch
# ---------------------------------------------------------------------------

def splitk_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache_len, *, n_splits: int, chunk: int, split0: int = 0,
                    window: int | None = None):
    """Per-chunk partial-softmax pieces ``(m, l, acc)`` of ``n_splits`` KV
    chunks starting at global chunk index ``split0``.

    q: (b, h, 1, d); k, v: (b, kv_h, n_splits * chunk, d), the local run of
    the (padded) sequence; cache_len: int or (b,) live lengths (keys at
    global positions >= cache_len, or before cache_len - window, are
    masked).  Returns m, l: (b, h, n_splits, 1, 1) f32 and acc:
    (b, h, n_splits, 1, d) f32, the chunk axis at position 2.  GQA is
    computed grouped: each chunk's query group of a KV head multiplies
    that head's rows, no KV head is repeated."""
    b, h, _, d = q.shape
    kv_h = k.shape[1]
    g = h // kv_h
    scale = 1.0 / float(d) ** 0.5
    # contiguous operands: the same layout, so the same product, whatever
    # view of the cache (or of a gathered query) a caller passes
    qf = q.to(torch.float32).reshape(b, kv_h, g, d).contiguous()
    cl = torch.as_tensor(cache_len, device=q.device).long().reshape(-1)
    cl = cl.expand(b)[:, None]                                     # (b, 1)
    offs = torch.arange(chunk, device=q.device)
    ms, ls, accs = [], [], []
    for c in range(n_splits):
        lo = c * chunk
        # fresh contiguous copies: the same program on the same layout for
        # every chunk, wherever the chunk sits in the sequence
        kc = k[:, :, lo:lo + chunk].to(
            torch.float32, copy=True, memory_format=torch.contiguous_format)
        vc = v[:, :, lo:lo + chunk].to(
            torch.float32, copy=True, memory_format=torch.contiguous_format)
        pos = (split0 + c) * chunk + offs                          # (chunk,)
        mask = pos[None, :] < cl                                   # (b, chunk)
        if window is not None:
            mask = mask & (pos[None, :] >= cl - window)
        mask = mask[:, None, None, :]                     # (b, 1, 1, chunk)
        sc = torch.matmul(qf, kc.transpose(-1, -2)) * scale  # (b,kv_h,g,chunk)
        sc = torch.where(mask, sc, NEG_INF)
        mi = sc.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(sc - mi), 0.0)
        ls.append(p.sum(dim=-1, keepdim=True).reshape(b, h, 1, 1))
        ms.append(mi.reshape(b, h, 1, 1))
        accs.append(torch.matmul(p, vc).reshape(b, h, 1, d))
    return (torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2))


def _chunk_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the chunk axis (2) one chunk after another, in chunk order:
    the same additions whatever layout the chunk axis came in."""
    out = x[:, :, 0]
    for c in range(1, x.shape[2]):
        out = out + x[:, :, c]
    return out


def splitk_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   dtype) -> torch.Tensor:
    """Merge per-chunk partials over the chunk axis (2): the global max,
    each chunk's numerator and denominator rescaled to it and summed in
    chunk order, normalized.  (b, h, K, 1, ·) pieces -> (b, h, 1, d) in
    ``dtype``."""
    m_g = m.amax(dim=2, keepdim=True)
    alpha = torch.exp(m - m_g)
    l_g = _chunk_sum(l * alpha)                                  # (b,h,1,1)
    acc_g = _chunk_sum(acc * alpha)                              # (b,h,1,d)
    return (acc_g / l_g.clamp_min(1e-30)).to(dtype)


def validate_num_splits(num_splits: int, axis_size: int, *,
                        axis_name: str = "model") -> None:
    """Each rank of a group splitting the chunks must own an equal
    contiguous run of them: fail loudly instead of a silent shape
    mismatch.  The JAX package's messages."""
    if num_splits < 1:
        raise ValueError(f"num_splits must be >= 1, got {num_splits}")
    if axis_size and num_splits % axis_size:
        raise ValueError(
            f"num_splits={num_splits} is not a multiple of the "
            f"'{axis_name}' mesh axis size {axis_size}: each device must "
            f"own an equal run of KV chunks.  Pass num_splits as a "
            f"multiple of {axis_size} (e.g. num_splits="
            f"{axis_size * max(1, -(-num_splits // axis_size))}).")


def _pad_seq(k: torch.Tensor, v: torch.Tensor, n_splits: int):
    """Pad the sequence axis (2) up to a multiple of ``n_splits`` with zero
    rows (masked by the live length); returns (k, v, chunk)."""
    s = k.shape[2]
    chunk = -(-s // n_splits)
    pad = n_splits * chunk - s
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    return k, v, chunk


def decode_attention_splitk(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, cache_len, *, n_splits: int = 4,
                            num_splits: int | None = None,
                            mesh_axis_size: int | None = None
                            ) -> torch.Tensor:
    """Flash-decoding: the KV sequence cut into chunks, per-chunk partial
    softmax pieces, one combine.  q: (b, h, 1, d); k, v: (b, kv_h, s, d).

    ``n_splits`` is advisory: when it does not divide ``s``, a nearby split
    count that does is taken while it keeps at least half the requested
    chunks, else the tail is padded (and masked).  ``num_splits`` is exact:
    the chunk count as given, the tail padded — what a group of ranks needs.
    ``mesh_axis_size`` validates the count against such a group."""
    s = k.shape[2]
    if num_splits is not None:
        n_splits = int(num_splits)
        validate_num_splits(n_splits, mesh_axis_size or 0)
    else:
        if mesh_axis_size:
            validate_num_splits(n_splits, mesh_axis_size)
            if s % n_splits:
                raise ValueError(
                    f"KV length {s} is not divisible by n_splits="
                    f"{n_splits} under a mesh axis of size "
                    f"{mesh_axis_size}; pass num_splits= explicitly to "
                    f"pin the chunk count (the tail is padded + masked).")
        if s % n_splits:
            cand, floor = n_splits, max(1, n_splits // 2)
            while cand > floor and s % cand:
                cand -= 1
            if s % cand == 0:
                n_splits = cand
    k, v, chunk = _pad_seq(k, v, n_splits)
    m, l, acc = splitk_partials(q, k, v, cache_len, n_splits=n_splits,
                                chunk=chunk)
    return splitk_combine(m, l, acc, q.dtype)


def gather_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                    group) -> tuple:
    """All-gather a rank's (b, h, n_local, 1, ·) partials over ``group``
    along the chunk axis, in the group's rank order: one collective of the
    three packed side by side.  Returns the (b, h, size * n_local, 1, ·)
    pieces, every rank the same bits."""
    d = acc.shape[-1]
    size = dist.get_world_size(group)
    packed = torch.cat([m, l, acc], dim=-1).movedim(2, 0).contiguous()
    out = packed.new_empty((size * packed.shape[0],) + packed.shape[1:])
    sharding.all_gather_rows(out, packed, group)
    out = out.movedim(0, 2)
    return out[..., :1], out[..., 1:2], out[..., 2:2 + d]


def shard_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len, *, mesh, axis, window: int | None = None
                 ) -> torch.Tensor:
    """The decode read of a cache split on its sequence over ``axis`` of
    a mesh (``runtime.collectives``; JAX's partitioned program, whose
    read is XLA, not Pallas): q (b, h, 1, d), every head; k, v (b, kv_h,
    S / n, d), this rank's shard, at global positions [i S / n,
    (i + 1) S / n).  Each rank computes its shard's partials as one
    split-K chunk (``split0`` = its index, so keys at or past
    ``cache_len`` and outside the window are masked at their global
    positions), the (m, l, acc) triples are all-gathered over ``axis`` in
    index order (one collective, counted on a ``DryMesh``) and every rank
    runs the same combine.  A shard with no live key (a prompt shorter
    than S / n) gives m = NEG_INF, l = 0, acc = 0, which the combine
    weights by exp(NEG_INF - max) = 0: no NaN while any shard is live."""
    m, l, acc = splitk_partials(q, k, v, cache_len, n_splits=1,
                                chunk=k.shape[2], split0=mesh.index(axis),
                                window=window)
    if mesh.axis_size(axis) > 1:
        d = acc.shape[-1]
        packed = mesh.all_gather(torch.cat([m, l, acc], dim=-1), axis, 2)
        m, l, acc = packed[..., :1], packed[..., 1:2], packed[..., 2:2 + d]
    return splitk_combine(m, l, acc, q.dtype)


def splitk_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cache_len, *, kv_splits: int, window: int | None = None,
                  group=None, group_size: int = 1) -> torch.Tensor:
    """The split-K decode body the model runs, on one device or over a
    group (the JAX model's ``_decode_attention_splitk_xla``): pad the tail
    to ``kv_splits`` chunks, slice this rank's contiguous run of
    kv_splits / group_size chunks, compute their partials, all-gather them
    in rank order, combine.  Bit for bit the single-device result."""
    K = int(kv_splits)
    k, v, chunk = _pad_seq(k, v, K)
    if group is not None and group_size > 1:
        validate_num_splits(K, group_size)
        n_local = K // group_size
        i = dist.get_rank(group)
        lo, hi = i * n_local * chunk, (i + 1) * n_local * chunk
        m, l, acc = splitk_partials(
            q, k[:, :, lo:hi], v[:, :, lo:hi], cache_len, n_splits=n_local,
            chunk=chunk, split0=i * n_local, window=window)
        m, l, acc = gather_partials(m, l, acc, group)
    else:
        m, l, acc = splitk_partials(q, k, v, cache_len, n_splits=K,
                                    chunk=chunk, window=window)
    return splitk_combine(m, l, acc, q.dtype)


def decode_attention_splitk_sharded(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, cache_len, *, group,
                                    num_splits: int | None = None
                                    ) -> torch.Tensor:
    """Flash-decoding over the ranks of ``group`` (JAX's mesh axis): the KV
    rows are whole on every rank, each rank computes its own contiguous run
    of num_splits / size chunks and the partials are all-gathered in rank
    order before every rank runs the same combine.  Bit for bit equal to
    ``decode_attention_splitk(..., num_splits=K)`` on one device.
    ``num_splits`` defaults to the group size."""
    ax = dist.get_world_size(group)
    n_splits = int(num_splits) if num_splits else max(ax, 1)
    validate_num_splits(n_splits, ax)
    return splitk_decode(q, k, v, cache_len, kv_splits=n_splits, group=group,
                         group_size=ax)
