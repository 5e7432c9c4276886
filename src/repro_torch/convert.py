"""Carry packed weights across from the JAX package.

``from_jax_packed`` takes the pytree that ``repro.models.transformer.
pack_params`` returns (layer leaves stacked along a leading L axis), with
every leaf already converted to a numpy array by the caller, and builds the
port's packed parameters — so both packages compute on the same codes,
gammas, biases, norms and embeddings.  ``packed_from_jax`` does the same for
one packed linear (``repro.core.bitlinear.pack``'s dict).  This module never
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitlinear import Linear, PackedLinear
from repro_torch.models.layers import Embedding, RMSNorm
from repro_torch.models.transformer import require_attn


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def packed_from_jax(d: dict, g: int, device: str | torch.device = "cuda"
                    ) -> PackedLinear:
    """One packed linear, {"codes", "gamma"[, "b"]} as numpy arrays, packed
    with group g -> the port's PackedLinear on ``device``."""
    return PackedLinear(_tensor(d["codes"], device),
                        _tensor(d["gamma"], device),
                        _tensor(d["b"], device) if "b" in d else None, g=g)


def from_jax_packed(cfg: ModelConfig, tree: dict,
                    device: str | torch.device = "cuda") -> nn.ModuleDict:
    require_attn(cfg)

    def t(a):
        return _tensor(a, device)

    def packed(d, i):
        return packed_from_jax({k: v[i] for k, v in d.items()},
                               cfg.group_size, device)

    lay = tree["layers"]
    blocks = nn.ModuleList()
    for i in range(cfg.n_layers):
        blocks.append(nn.ModuleDict({
            "ln1": RMSNorm(t(lay["ln1"]["w"][i])),
            "ln2": RMSNorm(t(lay["ln2"]["w"][i])),
            "attn": nn.ModuleDict({n: packed(lay["attn"][n], i)
                                   for n in ("q", "k", "v", "o")}),
            "mlp": nn.ModuleDict({n: packed(lay["mlp"][n], i)
                                  for n in ("gate", "up", "down")}),
        }))
    params = nn.ModuleDict({
        "layers": blocks,
        "final_norm": RMSNorm(t(tree["final_norm"]["w"])),
        "embed": Embedding(t(tree["embed"]["tok"])),
    })
    if "lm_head" in tree:
        head = tree["lm_head"]
        params["lm_head"] = Linear(t(head["w"]),
                                   t(head["b"]) if "b" in head else None)
    return params
