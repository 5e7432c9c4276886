"""Launching the port's multi-rank tests: gloo ranks started by
``python -m torch.distributed.run --standalone`` on a script written to a
test's ``tmp_path`` (a spawned process must import its script, which a
``python -c`` string is not).  ``PROLOGUE`` builds the reduced
qwen1.5-0.5b in the port alone (no JAX: every rank builds it in well under
a second) and a runner whose requests mix greedy and sampled ones, the
counterpart of ``tests/test_multidevice.py``'s prologue.

A launch runs in a process group of its own under a timeout; on expiry
the whole group (the launcher and every rank) is killed and the test
fails with the ranks' stderr.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

PROLOGUE = '''
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)

from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.serving import (FaultInjector, Request, RequestStatus,
                                 ServingEngine)

dist.init_process_group("gloo")
RANK, WORLD = dist.get_rank(), dist.get_world_size()

cfg = get_config("qwen1.5-0.5b").reduced()
packed = transformer.pack_params(
    cfg, transformer.init_params(cfg, torch.Generator().manual_seed(1)))


def mesh_of(shape):
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def run_engine(prompts, max_new=5, temps=True, **kw):
    kw.setdefault("max_seq", 32)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("decode_block", 4)
    eng = ServingEngine(cfg, packed, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=max_new,
                    temperature=(0.7 if temps and i % 2 else 0.0))
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.output.tolist() for r in reqs], eng


PROMPTS = [np.asarray([1, 2, 3, 4, 5], np.int32),
           np.asarray([9, 8, 7], np.int32),
           np.asarray([4, 4, 2, 1, 1, 3, 2, 5, 6], np.int32),
           np.asarray([2, 7, 1], np.int32)]


def finish(sentinel):
    dist.barrier()
    if RANK == 0:
        print(sentinel, flush=True)
    dist.destroy_process_group()
'''


def launch(tmp_path, body: str, nproc: int, sentinel: str,
           timeout: float = 180.0) -> str:
    """Run ``PROLOGUE + body`` on ``nproc`` gloo ranks; returns stdout.
    Fails unless every rank exits 0 and rank 0 printed ``sentinel``."""
    script = tmp_path / f"ranks_{nproc}_{sentinel.lower()}.py"
    script.write_text(PROLOGUE + body)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", str(script)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{nproc} ranks did not finish in {timeout} s\n"
                    f"--- stdout ---\n{out[-4000:]}\n"
                    f"--- stderr ---\n{err[-8000:]}")
    assert proc.returncode == 0 and sentinel in out, (
        f"--- stdout ---\n{out[-4000:]}\n--- stderr ---\n{err[-8000:]}")
    return out
