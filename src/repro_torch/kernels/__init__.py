"""Hand-written Hopper (sm_90a) kernels of the port.

Each kernel package holds
  kernel.py — the launch of the CUDA kernel (sources in ``repro_torch/csrc``)
              through the ctypes-loaded library, with its launch counter;
  ops.py    — the public wrapper: the JAX wrapper's padding and dtype
              contract, and the choice between kernel and plain version;
  ref.py    — the plain PyTorch version of the same function.

The choice is made by where the tensor lies, never by a setting: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain
version.  Counterpart of ``repro/kernels`` and its ``default_interpret()``.
"""

import torch


def on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what} has no path for device {x.device}")
    return False


def per_row(value, q: torch.Tensor) -> torch.Tensor:
    """An int or (b,) lengths/offsets -> a contiguous (b,) int32 tensor on
    q's device, b = q.shape[0]."""
    x = torch.as_tensor(value, dtype=torch.int32, device=q.device)
    return x.reshape(-1).expand(q.shape[0]).contiguous()


def launch_counters() -> dict:
    """name -> the wrapper function whose ``launches`` attribute counts the
    launches of that kernel in this process."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_prefill import kernel as fp
    from repro_torch.kernels.rmsnorm_quant import kernel as rq
    from repro_torch.kernels.swiglu_quant import kernel as sq
    from repro_torch.kernels.tlmm import kernel as tl
    from repro_torch.kernels.tlmm_lut import kernel as lut
    return {"tlmm": tl.tlmm_cuda, "tlmm_lut": lut.tlmm_lut_cuda,
            "rmsnorm_quant": rq.rmsnorm_quant_cuda,
            "swiglu_quant": sq.swiglu_quant_cuda,
            "flash_prefill": fp.flash_prefill_cuda,
            "flash_chunk_prefill": fp.flash_chunk_prefill_cuda,
            "flash_chunk_prefill_paged": fp.flash_chunk_prefill_paged_cuda,
            "decode_attention": da.decode_attention_cuda,
            "decode_attention_paged": da.decode_attention_paged_cuda,
            "decode_attention_paged_quant":
                da.decode_attention_paged_quant_cuda}


def reset_launch_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def take_captured_launches(before: dict) -> dict:
    """name -> the launches the wrappers counted since ``before`` (a
    :func:`launch_counts` snapshot) while a CUDA stream capture recorded
    them.  A capture runs nothing, so they are taken back off the counters;
    each replay of the graph adds them (:func:`add_launches`)."""
    counters = launch_counters()
    out = {}
    for name, fn in counters.items():
        if fn.launches != before[name]:
            out[name] = fn.launches - before[name]
            fn.launches = before[name]
    return out


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a captured graph."""
    counters = launch_counters()
    for name, n in counts.items():
        counters[name].launches += n
