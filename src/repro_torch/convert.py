"""Carry packed weights across from the JAX package.

``from_jax_packed`` takes the pytree that ``repro.models.transformer.
pack_params`` returns (layer leaves stacked along a leading L axis), with
every leaf already converted to a numpy array by the caller, and builds the
port's packed parameters — so both packages compute on the same codes,
gammas, biases, norms, routers, expert banks (``{gate,up,down}_{codes,
gamma}`` stacked (L, E, ...)), hymba's SSM (packed ``in_proj``,
``bc_proj``, ``dt_proj``, ``out_proj``; dense ``conv_w``, ``conv_b``,
``A_log``, ``D``, ``dt_bias``), an xLSTM pair's mLSTM (``qkv``, ``gates``,
``ogate``, ``out``) and sLSTM (``wx``, ``out``; dense ``r``), stacked over
``n_layers // 2`` pairs, embeddings and LM heads.  ``packed_from_jax`` does the same for
one packed linear (``repro.core.bitlinear.pack``'s dict).

``from_jax_params`` takes the float master tree of ``transformer.
init_params`` (norms, Q/K/V/O with their biases, the SwiGLU ``mlp`` or the
MoE router and banks, hymba's ``ssm``, an xLSTM pair's ``mlstm`` and
``slstm``; embedding, LM head) and builds the port's master parameters;
``named_from_jax`` flattens any tree shaped like it (gradients, AdamW
moments) to the port's buffer names, so ``adamw_state_from_jax`` carries an
optimizer state across.  This module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitlinear import Linear, PackedLinear
from repro_torch.models import ssm, xlstm
from repro_torch.models.layers import MoE, Embedding, Params, RMSNorm
from repro_torch.models.transformer import n_scan_layers
from repro_torch.optim.adamw import AdamWState


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
    def t(a):
        return _tensor(a, device)

    def packed(d, i):
        return packed_from_jax({k: v[i] for k, v in d.items()},
                               cfg.group_size, device)

    def dense(d, i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        return Linear(t(pick(d["w"])), t(pick(d["b"])) if "b" in d else None)

    def sub(d, i, linears):
        """One sub-layer: its packed linears and, as they are, the rest."""
        return Params(**{n: packed(v, i) if n in linears else t(v[i])
                         for n, v in d.items()})

    lay = tree["layers"]
    blocks = nn.ModuleList()
    for i in range(n_scan_layers(cfg)):
        block = nn.ModuleDict({
            "ln1": RMSNorm(t(lay["ln1"]["w"][i])),
            "ln2": RMSNorm(t(lay["ln2"]["w"][i]))})
        if "mlstm" in lay:
            block["mlstm"] = sub(lay["mlstm"], i, xlstm.MLSTM_LINEARS)
            block["slstm"] = sub(lay["slstm"], i, xlstm.SLSTM_LINEARS)
            blocks.append(block)
            continue
        block["attn"] = nn.ModuleDict({n: packed(lay["attn"][n], i)
                                       for n in ("q", "k", "v", "o")})
        if "ssm" in lay:
            block["ssm"] = sub(lay["ssm"], i, ssm.LINEARS)
        if "moe" in lay:
            m = lay["moe"]
            block["moe"] = MoE(dense(m["router"], i), {
                f"{n}_{part}": t(m[f"{n}_{part}"][i])
                for n in MoE.BANKS for part in ("codes", "gamma")},
                g=cfg.group_size)
        if "mlp" in lay:
            block["mlp"] = nn.ModuleDict({n: packed(lay["mlp"][n], i)
                                          for n in ("gate", "up", "down")})
        blocks.append(block)
    params = nn.ModuleDict({
        "layers": blocks,
        "final_norm": RMSNorm(t(tree["final_norm"]["w"])),
    })
    if "embed" in tree:
        params["embed"] = Embedding(t(tree["embed"]["tok"]))
    if "lm_head" in tree:
        params["lm_head"] = dense(tree["lm_head"])
    return params


def named_from_jax(cfg: ModelConfig, tree: dict,
                   device: str | torch.device = "cuda") -> dict:
    """A tree shaped like the JAX master params (numpy leaves; layer leaves
    stacked on axis 0, as JAX's scan holds them) -> {port buffer name:
    tensor}, e.g. ``layers.3.attn.q.w`` for ``tree["layers"]["attn"]["q"]
    ["w"][3]``."""
    out = {}

    def walk(d, path, layer):
        for k, v in d.items():
            name = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                walk(v, name, layer)
            elif layer is None:
                out[name] = _tensor(v, device)
            else:
                out[name.replace("layers.", f"layers.{layer}.", 1)] = (
                    _tensor(v[layer], device))

    for i in range(n_scan_layers(cfg)):
        walk({"layers": tree["layers"]}, "", i)
    walk({k: v for k, v in tree.items() if k != "layers"}, "", None)
    return out


def from_jax_params(cfg: ModelConfig, tree: dict,
                    device: str | torch.device = "cuda") -> nn.ModuleDict:
    """The JAX float master tree (numpy leaves) -> the port's master
    parameters on ``device``, shaped as ``transformer.init_params`` draws
    them, for every block kind."""
    named = named_from_jax(cfg, tree, device)

    def lin(prefix):
        return Linear(named[f"{prefix}.w"], named.get(f"{prefix}.b"))

    def sub(prefix, linears, dense):
        """One sub-layer: its master linears, then its dense tensors."""
        return Params(**{n: lin(f"{prefix}.{n}") for n in linears},
                      **{n: named[f"{prefix}.{n}"] for n in dense})

    blocks = nn.ModuleList()
    for i in range(n_scan_layers(cfg)):
        pre = f"layers.{i}"
        block = nn.ModuleDict({"ln1": RMSNorm(named[f"{pre}.ln1.w"])})
        if cfg.block_kind == "xlstm_pair":
            block["mlstm"] = sub(f"{pre}.mlstm", xlstm.MLSTM_LINEARS, ())
            block["ln2"] = RMSNorm(named[f"{pre}.ln2.w"])
            block["slstm"] = sub(f"{pre}.slstm", xlstm.SLSTM_LINEARS, ("r",))
            blocks.append(block)
            continue
        block["ln2"] = RMSNorm(named[f"{pre}.ln2.w"])
        block["attn"] = nn.ModuleDict({n: lin(f"{pre}.attn.{n}")
                                       for n in ("q", "k", "v", "o")})
        if cfg.block_kind == "hymba":
            block["ssm"] = sub(f"{pre}.ssm", ssm.LINEARS, ssm.DENSE)
        if f"{pre}.moe.gate_w" in named:
            block["moe"] = MoE(lin(f"{pre}.moe.router"), {
                f"{n}_w": named[f"{pre}.moe.{n}_w"] for n in MoE.BANKS})
        elif f"{pre}.mlp.gate.w" in named:
            block["mlp"] = nn.ModuleDict({n: lin(f"{pre}.mlp.{n}")
                                          for n in ("gate", "up", "down")})
        blocks.append(block)
    params = nn.ModuleDict({"layers": blocks,
                            "final_norm": RMSNorm(named["final_norm.w"])})
    if "embed.tok" in named:
        params["embed"] = Embedding(named["embed.tok"])
    if "lm_head.w" in named:
        params["lm_head"] = lin("lm_head")
    return params


def adamw_state_from_jax(cfg: ModelConfig, state,
                         device: str | torch.device = "cuda") -> AdamWState:
    """A JAX ``AdamWState`` (numpy leaves) -> the port's: the step count
    and the moments keyed by the port's buffer names."""
    return AdamWState(
        step=torch.as_tensor(np.asarray(state.step), dtype=torch.int32,
                             device=device),
        m=named_from_jax(cfg, state.m, device),
        v=named_from_jax(cfg, state.v, device))
