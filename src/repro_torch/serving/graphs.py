"""The device-resident decode block as one captured CUDA graph.

Counterpart of the JAX engine's jit of its fused decode block
(``repro/serving/engine.py`` ``_decode_block_dev``: one ``jax.jit`` over a
``lax.scan`` of ``decode_block`` ticks).  PyTorch runs eagerly, so a block
of ticks costs the host one launch per op; here the block is recorded once
into a ``torch.cuda.CUDAGraph`` and every later block is one replay.

What the recorded function may touch is fixed: it reads and writes tensors
that live as long as the engine (the scheduler state, the KV cache, the
device block table, the pre-decoded weights), in place, and returns its
outputs, which the graph's memory pool keeps at fixed addresses — each
replay overwrites them.  Nothing in it reads a host value.  The engine
keeps those tensors for its whole life: a degrade to host-driven blocks
stops the replays, a promotion writes the host mirror into the same tensors
and replays the same graph again; only rebuilding the cache drops the graph.

A capture records launches and runs none, so what the kernel wrappers'
launch counters count during it is taken back
(``kernels.take_captured_launches``); each replay adds the launches the
graph holds (``kernels.add_launches``).

Under a mesh the block holds NCCL collectives (the gather of its outputs
over the mesh's ``data`` axis, the split-K partials over ``model``), which
the graph records with the rest.  A communicator is created at its first
collective, which a capture must not be: the eager first block issues
every one of them on the engine's stream before the capture.
"""

from __future__ import annotations

import torch

from repro_torch import kernels


class CapturedBlock:
    """``fn()`` captured into one CUDA graph on ``stream``.  The caller has
    run ``fn`` eagerly on the same stream first: that run warms cuBLAS on
    the stream, sets the kernels' one-time attributes and creates the NCCL
    communicators of its collectives, which a capture must not be the
    first to do.  A failed capture raises.  ``collectives`` captures in
    the thread-local mode: the process group's watchdog thread polls its
    events during the capture, which the global mode forbids."""

    def __init__(self, fn, stream: torch.cuda.Stream, *,
                 collectives: bool = False):
        self.graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        mode = "thread_local" if collectives else "global"
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode=mode):
            self.outputs = fn()
        self.launches = kernels.take_captured_launches(before)

    def replay(self):
        """Launch the graph on the current stream and return its outputs
        (valid until the next replay)."""
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.outputs
