"""Decoder-only model for ``block_kind="attn"``: parameters and the three
serving entry points.

Counterpart of ``repro/models/transformer.py`` (attention blocks,
contiguous caches):

  * ``prefill_step``  — full prompt -> last-token logits + filled KV cache
  * ``prefill_chunk`` — one admission wave: per-slot prompt chunks written
    in place at per-row offsets of the shared multi-slot cache, each
    attending its already-written prefix
  * ``decode_step``   — one token per row + cache + live lengths -> next
    logits

Parameters are an ``nn.ModuleDict`` shaped like the JAX pytree —
``layers`` (one ``ModuleDict`` per layer instead of a stacked axis),
``final_norm``, ``embed`` and, untied, ``lm_head`` — whose leaves are the
modules of ``core.bitlinear`` and ``models.layers``.  The KV cache keeps the
JAX layout, ``{"k", "v"}`` of shape (L, b, S, kv_h, hd), and is updated IN
PLACE: every entry point returns the cache dict it was given.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bitlinear
from repro_torch.models import attention, layers
from repro_torch.models.layers import Ctx, Embedding, RMSNorm


def require_attn(cfg: ModelConfig) -> None:
    if cfg.block_kind != "attn" or cfg.n_experts or not cfg.d_ff:
        raise NotImplementedError(
            f"the port serves dense attention-block models; {cfg.name} has "
            f"block_kind={cfg.block_kind!r}, n_experts={cfg.n_experts}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator) -> nn.ModuleDict:
    """Random float master weights, drawn from ``generator`` on its device
    (normal/sqrt(n_in) linears, zero biases, unit norms, 0.02 embeddings)."""
    require_attn(cfg)
    dev = generator.device

    def lin(n_in, n_out, bias=False):
        return bitlinear.init(generator, n_in, n_out, bias=bias)

    def norm():
        return RMSNorm(torch.ones(cfg.d_model, device=dev))

    blocks = nn.ModuleList()
    for _ in range(cfg.n_layers):
        blocks.append(nn.ModuleDict({
            "ln1": norm(), "ln2": norm(),
            "attn": nn.ModuleDict({
                "q": lin(cfg.d_model, cfg.q_dim, cfg.qkv_bias),
                "k": lin(cfg.d_model, cfg.kv_dim, cfg.qkv_bias),
                "v": lin(cfg.d_model, cfg.kv_dim, cfg.qkv_bias),
                "o": lin(cfg.q_dim, cfg.d_model)}),
            "mlp": nn.ModuleDict({
                "gate": lin(cfg.d_model, cfg.d_ff),
                "up": lin(cfg.d_model, cfg.d_ff),
                "down": lin(cfg.d_ff, cfg.d_model)}),
        }))
    params = nn.ModuleDict({
        "layers": blocks, "final_norm": norm(),
        "embed": Embedding(torch.randn((cfg.vocab_size, cfg.d_model),
                                       generator=generator, device=dev) * 0.02),
    })
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(cfg.d_model, cfg.vocab_size)
    return params


def pack_params(cfg: ModelConfig, params: nn.ModuleDict) -> nn.ModuleDict:
    """Offline stage: base-3 pack every ternary linear (norms, embedding
    and the dense LM head are shared with ``params``)."""
    g = cfg.group_size
    blocks = nn.ModuleList()
    for p in params["layers"]:
        blocks.append(nn.ModuleDict({
            "ln1": p["ln1"], "ln2": p["ln2"],
            "attn": nn.ModuleDict({n: bitlinear.pack(m, g)
                                   for n, m in p["attn"].items()}),
            "mlp": nn.ModuleDict({n: bitlinear.pack(m, g)
                                  for n, m in p["mlp"].items()}),
        }))
    out = nn.ModuleDict({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = blocks
    return out


def predecode_packed(cfg: ModelConfig, params: nn.ModuleDict) -> nn.ModuleDict:
    """Decode every layer's packed codes into dense ternary matrices, fusing
    Q|K|V and gate|up into one matrix each (one activation quant and one
    GEMM per projection group).  Outputs equal the packed path's exactly
    (see ``bitlinear.predecode``)."""
    blocks = nn.ModuleList()
    for p in params["layers"]:
        a, m = p["attn"], p["mlp"]
        blocks.append(nn.ModuleDict({
            "ln1": p["ln1"], "ln2": p["ln2"],
            "attn": nn.ModuleDict({
                "qkv": bitlinear.predecode_fused([a["q"], a["k"], a["v"]]),
                "o": bitlinear.predecode(a["o"])}),
            "mlp": nn.ModuleDict({
                "gateup": bitlinear.predecode_fused([m["gate"], m["up"]]),
                "down": bitlinear.predecode(m["down"])}),
        }))
    out = nn.ModuleDict({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = blocks
    return out


def param_device(params: nn.ModuleDict) -> torch.device:
    return params["final_norm"].w.device


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Attention sub-layer and block
# ---------------------------------------------------------------------------

def _attn_apply(cfg: ModelConfig, ctx: Ctx, p: nn.ModuleDict,
                x: torch.Tensor, cache: dict | None, positions: torch.Tensor,
                phase: str, cache_len=None, chunk_mask=None) -> torch.Tensor:
    b, t, _ = x.shape
    if "qkv" in p:   # fused projection (pre-decoded serving hot path)
        q, k, v = layers.linear_apply(p["qkv"], x, ctx).split(
            [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        q = layers.linear_apply(p["q"], x, ctx)
        k = layers.linear_apply(p["k"], x, ctx)
        v = layers.linear_apply(p["v"], x, ctx)
    q = q.reshape(b, t, cfg.n_heads, cfg.hd)
    k = k.reshape(b, t, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.hd)
    angles = layers.rope_angles(positions, cfg.hd, cfg.rope_theta)
    q = layers.apply_rope(q, angles, cfg.rope_style)
    k = layers.apply_rope(k, angles, cfg.rope_style)
    qt = q.transpose(1, 2)
    if phase == "full":
        if cache is not None:   # prefill: persist KV
            attention.update_kv_cache(cache["k"], cache["v"], k, v, 0)
        o = attention.prefill_attention(
            qt, k.transpose(1, 2), v.transpose(1, 2), window=cfg.swa_window,
            impl=ctx.attn_impl)
    elif phase == "chunk":
        # admission wave: rows with chunk_mask write their chunk's KV into
        # their own cache row at offset cache_len[i]; masked rows keep their
        # row and produce don't-care outputs.  Attention reads the cache in
        # place (in its dtype) with the chunk's own span taken from its
        # fresh full-precision K/V — the JAX model's cast-and-overlay,
        # without copying the cache — so within-chunk numerics match
        # monolithic prefill.
        offsets = cache_len
        attention.write_rows(cache["k"], k, offsets, chunk_mask)
        attention.write_rows(cache["v"], v, offsets, chunk_mask)
        o = attention.chunk_prefill_attention(
            qt, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
            k.transpose(1, 2), v.transpose(1, 2), offsets,
            window=cfg.swa_window, impl=ctx.attn_impl)
    else:   # decode step, t == 1
        attention.update_kv_cache(cache["k"], cache["v"], k, v, cache_len)
        o = attention.decode_attention(
            qt, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
            cache_len + 1, window=cfg.swa_window, impl=ctx.attn_impl)
    o = o.transpose(1, 2).reshape(b, t, cfg.q_dim)
    return layers.linear_apply(p["o"], o, ctx)


def _block_apply(cfg, ctx, x, p, cache, positions, phase, cache_len=None,
                 chunk_mask=None):
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + _attn_apply(cfg, ctx, p["attn"], h, cache, positions, phase,
                        cache_len, chunk_mask)
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + layers.mlp_apply(p["mlp"], h, ctx)


def _run_layers(cfg, ctx, params, x, cache, positions, phase, cache_len=None,
                chunk_mask=None):
    for i, p in enumerate(params["layers"]):
        layer_cache = (None if cache is None
                       else {"k": cache["k"][i], "v": cache["v"][i]})
        x = _block_apply(cfg, ctx, x, p, layer_cache, positions, phase,
                         cache_len, chunk_mask)
    return x


def _embed_in(params, inputs, ctx):
    return layers.embed_apply(params["embed"], inputs).to(ctx.act_dtype)


def _lm_head(cfg, params, x, ctx):
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", x,
                            params["embed"].tok.to(x.dtype))
    return layers.linear_apply(params["lm_head"], x, ctx)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def prefill_step(cfg: ModelConfig, params: nn.ModuleDict,
                 inputs: torch.Tensor, ctx: Ctx, cache: dict,
                 lengths: torch.Tensor | None = None):
    """Prompt (b, s) -> (last-token logits (b, vocab), cache).  With
    ``lengths`` ((b,) int) row i's logits are taken at position
    lengths[i] - 1 of a right-padded batch."""
    x = _embed_in(params, inputs, ctx)
    b, s = inputs.shape
    positions = torch.arange(s, device=x.device)
    x = _run_layers(cfg, ctx, params, x, cache, positions, "full")
    if lengths is None:
        last = x[:, -1:]
    else:
        idx = torch.as_tensor(lengths, device=x.device).long() - 1
        last = x[torch.arange(b, device=x.device), idx][:, None]
    return _lm_head(cfg, params, last, ctx)[:, 0], cache


def prefill_chunk(cfg: ModelConfig, params: nn.ModuleDict,
                  inputs: torch.Tensor, ctx: Ctx, cache: dict, *, offsets,
                  admit_mask, last_index):
    """One admission wave -> (logits (b, vocab), cache).

    ``inputs`` (b, C) holds one prompt chunk per cache row; row i with
    ``admit_mask[i]`` sits at absolute positions offsets[i] + [0, C), writes
    its chunk KV there in place and attends its row's [0, offsets[i])
    prefix plus its own causal triangle.  Masked rows leave their cache row
    untouched.  ``last_index[i]`` is the chunk-local index of row i's last
    real prompt token, whose logits are returned."""
    require_attn(cfg)
    x = _embed_in(params, inputs, ctx)
    b, c = inputs.shape
    dev = x.device
    offsets = torch.as_tensor(offsets, dtype=torch.int32, device=dev)
    admit = torch.as_tensor(admit_mask, dtype=torch.bool, device=dev)
    positions = offsets[:, None] + torch.arange(c, device=dev)
    x = _run_layers(cfg, ctx, params, x, cache, positions, "chunk", offsets,
                    admit)
    idx = torch.as_tensor(last_index, device=dev).long()
    last = x[torch.arange(b, device=dev), idx][:, None]
    return _lm_head(cfg, params, last, ctx)[:, 0], cache


def decode_step(cfg: ModelConfig, params: nn.ModuleDict,
                inputs: torch.Tensor, ctx: Ctx, cache: dict, cache_len):
    """One token per row (b, 1) + cache + live lengths -> (logits
    (b, vocab), cache).  ``cache_len`` is an int or a (b,) tensor: row i
    writes its KV at cache_len[i], rotates by that position and attends its
    own [0, cache_len[i]] prefix."""
    x = _embed_in(params, inputs, ctx)
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    positions = cl[..., None] + torch.arange(1, device=x.device)
    x = _run_layers(cfg, ctx, params, x, cache, positions, "step", cl)
    return _lm_head(cfg, params, x, ctx)[:, 0], cache
