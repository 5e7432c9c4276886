"""Fault-tolerant checkpointing: atomic, async, keep-N — the port's copy of
``repro/checkpoint/manager.py`` for the port's trees.

A tree is any nesting of dicts, lists, tuples and named tuples (the
``AdamWState``) over tensors, with ``nn.Module``s (a parameter
``ModuleDict``) standing for their state dicts.  Leaves are saved as one
``.npz`` a step in a device-independent layout, bf16 as uint16 views (npz
holds no bfloat16).  The JAX contract:
  * writes are atomic: a tmp directory, then ``os.replace``, then the
    ``latest`` marker, written last (itself by tmp file and replace), so a
    crash mid-write never leaves ``latest`` naming a torn checkpoint;
  * ``save`` snapshots to host memory at once and writes in a background
    thread unless ``blocking``; ``wait`` joins it (``save`` and
    ``restore`` wait first);
  * ``keep_n`` keeps the newest complete steps;
  * ``install_sigterm_handler`` flips a flag the train loop polls, to save
    a last checkpoint and leave.
Reading the JAX package's checkpoints is not supported.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import signal
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn


def _flatten(tree, out: list) -> None:
    if isinstance(tree, nn.Module):
        _flatten(dict(tree.state_dict()), out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _flatten(x, out)
    else:
        out.append(tree)


def _unflatten(like, leaves):
    """A tree shaped like ``like`` taking its leaves in order from the
    iterator ``leaves``; a module is copied and loaded, a tensor takes the
    dtype and device of ``like``'s."""
    if isinstance(like, nn.Module):
        state = _unflatten(dict(like.state_dict()), leaves)
        module = copy.deepcopy(like)
        module.load_state_dict(state)
        return module
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    a = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)
    return a


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf that owns its memory (a CPU tensor's
    ``.cpu()`` is the tensor itself, so every branch copies): the training
    step updates masters and moments in place after an async save."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16).copy()
        return x.numpy().copy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot now, write in the background (unless blocking)."""
        self.wait()
        leaves = []
        _flatten(tree, leaves)
        dtypes = [str(x.dtype).replace("torch.", "") for x in leaves]
        # after this the caller may change its tensors freely
        storable = [_to_host(x) for x in leaves]

        def _write():
            step_dir = os.path.join(self.directory, f"step_{step:010d}")
            tmp_dir = step_dir + ".tmp"
            os.makedirs(tmp_dir, exist_ok=True)
            np.savez(os.path.join(tmp_dir, "arrays.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(storable)})
            with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
                json.dump({"step": step, "n_leaves": len(storable),
                           "dtypes": dtypes}, f)
            if os.path.exists(step_dir):
                shutil.rmtree(step_dir)
            os.replace(tmp_dir, step_dir)
            self._write_latest(step)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write_latest(self, step: int) -> None:
        tmp = os.path.join(self.directory, "latest.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.directory, "latest"))

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "latest")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, step: Optional[int], like: Any) -> Any:
        """The checkpoint of ``step`` (the latest when None) in the
        structure of ``like``, each tensor on ``like``'s device."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        step_dir = os.path.join(self.directory, f"step_{step:010d}")
        data = np.load(os.path.join(step_dir, "arrays.npz"))
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta = json.load(f)
        arrays = []
        for i in range(meta["n_leaves"]):
            a = data[f"leaf_{i}"]
            if meta["dtypes"][i] == "bfloat16":
                a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                arrays.append(a.float().numpy())
            else:
                arrays.append(a)
        return _unflatten(like, iter(arrays))


# ---------------------------------------------------------------------------
# Preemption handling
# ---------------------------------------------------------------------------

class PreemptionFlag:
    def __init__(self):
        self._flag = threading.Event()

    def set(self, *_args):
        self._flag.set()

    def __bool__(self):
        return self._flag.is_set()


def install_sigterm_handler() -> PreemptionFlag:
    flag = PreemptionFlag()
    signal.signal(signal.SIGTERM, flag.set)
    return flag
