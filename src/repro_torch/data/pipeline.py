"""Deterministic, host-shardable synthetic LM data: the port's copy of
``repro/data/pipeline.py``.

A seeded Markov-ish token stream (with probability ``structure`` the next
token is ``(31 * prev + 7) % vocab``, else uniform), drawn with numpy
exactly as the JAX package draws it, so a batch is bit for bit the
reference's; for ``frontend="embed"`` configs the inputs are synthetic
frame/patch embeddings.  Batches come as torch tensors on ``device``.
``make_batch_specs`` gives a batch's shapes and dtypes as tensors on the
``meta`` device (the dry run's input; JAX's ``ShapeDtypeStruct``s).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    cfg: ModelConfig
    batch: int                    # per-host batch
    seq_len: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    structure: float = 0.8        # P(next = f(prev)); rest uniform
    device: str | torch.device = "cuda"

    def batch_at(self, step: int) -> dict:
        """The batch of a global step (replayable on restart) as tensors on
        ``device``: labels (b, s) int32, inputs (b, s) int32 token ids or
        (b, s, d_model) f32 embeddings."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        v = self.cfg.vocab_size
        b, s = self.batch, self.seq_len
        a, c = 31, 7
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        flips = rng.random((b, s)) < self.structure
        rand = rng.integers(0, v, size=(b, s))
        for t in range(s):
            nxt = (a * toks[:, t] + c) % v
            toks[:, t + 1] = np.where(flips[:, t], nxt, rand[:, t])
        batch = {"labels": toks[:, 1:]}
        if self.cfg.frontend == "token":
            batch["inputs"] = toks[:, :-1]
        else:
            emb_rng = np.random.default_rng(self.seed * 77 + step)
            batch["inputs"] = emb_rng.standard_normal(
                (b, s, self.cfg.d_model), dtype=np.float32) * 0.02
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for k, a in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "meta") -> dict:
    """Stand-ins for one training batch: {"inputs": (b, s) int32 ids, or
    (b, s, d_model) ``dtype`` embeddings; "labels": (b, s) int32}, empty
    tensors on ``device`` (``meta``: shapes and dtypes, no storage)."""
    if cfg.frontend == "token":
        inputs = torch.empty((global_batch, seq_len), dtype=torch.int32,
                             device=device)
    else:
        inputs = torch.empty((global_batch, seq_len, cfg.d_model),
                             dtype=dtype, device=device)
    return {"inputs": inputs,
            "labels": torch.empty((global_batch, seq_len), dtype=torch.int32,
                                  device=device)}
