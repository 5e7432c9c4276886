"""INT8 error-feedback gradient compression for the cross-replica
reduction, the port's copy of ``repro/optim/compression.py`` on
``torch.distributed``.

Per-tensor absmax int8 with an error-feedback accumulator: what the int8
round trip loses is added back into the next step's gradient.  The scale
is ``amax * f32(1/127)``, the arithmetic of the reference's jitted step
(XLA's rewrite of ``/ 127.0``) and of ATen's division on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core.ternary import INV_127


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp_min(x.abs().max(), 1e-12)
    scale = amax * INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EF round: (grad + carried error) -> int8 -> back; new error."""
    gf = g.float() + err
    q, scale = _quant(gf)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def compressed_psum(grads: dict, errs: dict, group=None
                    ) -> Tuple[dict, dict]:
    """All-reduce int8-compressed gradients over ``group``, leaf by leaf
    the reference's ``compressed_psum``: each rank quantizes grad + error
    with its own scale; the int32 sums of the codes and the f32 sum of the
    scales cross the group (each in one all-reduce over every leaf, which
    sums element by element as one a leaf would); the result is
    ``q_sum * (scale_sum / n) / n`` with n the group's size, and the new
    error what this rank's round trip lost."""
    names = list(grads)
    qs, scales, new_errs = [], [], {}
    for n in names:
        gf = grads[n].float() + errs[n]
        q, scale = _quant(gf)
        new_errs[n] = gf - q.float() * scale
        qs.append(q.to(torch.int32).reshape(-1))
        scales.append(scale.reshape(1))
    q_sum = torch.cat(qs)
    scale_sum = torch.cat(scales)
    dist.all_reduce(q_sum, group=group)
    dist.all_reduce(scale_sum, group=group)
    size = torch.tensor(float(dist.get_world_size(group)),
                        dtype=torch.float32, device=q_sum.device)
    out, lo = {}, 0
    for i, n in enumerate(names):
        g = grads[n]
        part = q_sum[lo:lo + g.numel()].reshape(g.shape)
        lo += g.numel()
        reduced = part.float() * (scale_sum[i] / size)
        out[n] = (reduced / size).to(g.dtype)
    return out, new_errs


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for n, t in params.items()}
