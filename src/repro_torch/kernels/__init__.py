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


def launch_counters() -> dict:
    """name -> the wrapper function whose ``launches`` attribute counts the
    launches of that kernel in this process."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_prefill import kernel as fp
    from repro_torch.kernels.tlmm import kernel as tl
    return {"tlmm": tl.tlmm_cuda, "flash_prefill": fp.flash_prefill_cuda,
            "flash_chunk_prefill": fp.flash_chunk_prefill_cuda,
            "decode_attention": da.decode_attention_cuda}


def reset_launch_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}
