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
JAX layouts: contiguous ``{"k", "v"}`` of shape (L, b, S, kv_h, hd)
(``init_cache``), or a page pool of shape (L, num_pages, page_size, kv_h,
hd) read through a (b, n_pages) block table (``init_paged_cache``,
``page_table=`` of ``prefill_chunk`` and ``decode_step``); with int8 KV
(``kv_quant=True``) the K/V planes are int8 and ``{"k_scale", "v_scale"}``
hold their per-(token, head) f32 scales, the same shapes without hd.  The
cache is updated IN PLACE: every entry point returns the cache dict it was
given.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bitlinear
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import dequant_bf16
from repro_torch.kernels.flash_prefill import ops as fp_ops
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

def _kv_planes(rows: tuple, hd: int, dtype, kv_quant: bool, device) -> dict:
    kv_dtype = torch.int8 if kv_quant else dtype
    cache = {"k": torch.zeros(rows + (hd,), dtype=kv_dtype, device=device),
             "v": torch.zeros(rows + (hd,), dtype=kv_dtype, device=device)}
    if kv_quant:   # per-(token, head) absmax scales of the int8 planes
        cache["k_scale"] = torch.zeros(rows, dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(rows, dtype=torch.float32,
                                       device=device)
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda", *,
               kv_quant: bool = False) -> dict:
    """Contiguous cache: K/V (L, batch, max_len, kv_h, hd) in ``dtype``, or
    int8 with (L, batch, max_len, kv_h) f32 scale planes (``kv_quant``)."""
    return _kv_planes((cfg.n_layers, batch, max_len, cfg.n_kv_heads), cfg.hd,
                      dtype, kv_quant, device)


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cuda", *,
                     kv_quant: bool = False) -> dict:
    """Paged cache: a pool of ``num_pages`` pages of ``page_size`` tokens,
    K/V (L, num_pages, page_size, kv_h, hd), shared by every slot through
    block tables (``attention.paged_update_kv_cache``); page 0 is the null
    page.  With ``kv_quant`` the pools are int8 and the scale planes
    (L, num_pages, page_size, kv_h) ride the same page axis."""
    require_attn(cfg)
    return _kv_planes((cfg.n_layers, num_pages, page_size, cfg.n_kv_heads),
                      cfg.hd, dtype, kv_quant, device)


# ---------------------------------------------------------------------------
# Attention sub-layer and block
# ---------------------------------------------------------------------------

def q_kv(x: torch.Tensor):
    """(b, t, kv_h, hd) -> int8 values and (b, t, kv_h) f32 scales: per
    (token, head) absmax / 127 (floored at 1e-5 / 127), round half to even,
    clip to +-127 — the JAX model's int8 KV quantizer."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-5) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _attn_apply(cfg: ModelConfig, ctx: Ctx, p: nn.ModuleDict,
                x: torch.Tensor, cache: dict | None, positions: torch.Tensor,
                phase: str, cache_len=None, chunk_mask=None,
                page_table=None) -> torch.Tensor:
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
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    window = cfg.swa_window
    quant = cache is not None and "k_scale" in cache
    if quant:
        (kw, ks), (vw, vs) = q_kv(k), q_kv(v)   # what the cache stores
    else:
        kw, vw = k, v
    if phase == "full":
        if cache is not None:   # prefill: persist KV
            attention.update_kv_cache(cache["k"], cache["v"], kw, vw, 0)
            if quant:
                attention.update_kv_cache(cache["k_scale"], cache["v_scale"],
                                          ks, vs, 0)
        o = fp_ops.flash_prefill(qt, kt, vt, window=window)
    elif phase == "chunk":
        # admission wave: rows with chunk_mask write their chunk's KV at
        # offset cache_len[i] of their own row (contiguous) or through their
        # block-table row (paged; masked rows write the null page); masked
        # rows' outputs are don't-care.  Attention reads the prefix from the
        # cache and the chunk's own span from its fresh full-precision K/V —
        # the JAX model's cast-and-overlay, without copying the cache — so
        # within-chunk numerics match monolithic prefill.  An int8 cache is
        # read dequantized to f32, f32(int8) * f32(scale), as in JAX.
        offsets = cache_len
        if page_table is not None:
            attention.paged_update_kv_cache(cache["k"], cache["v"], kw, vw,
                                            page_table, offsets, chunk_mask)
            if quant:
                attention.paged_update_kv_scales(
                    cache["k_scale"], cache["v_scale"], ks, vs, page_table,
                    offsets, chunk_mask)
                o = attention.paged_chunk_prefill_attention_quant(
                    qt, cache["k"], cache["v"], cache["k_scale"],
                    cache["v_scale"], page_table, offsets, kt, vt,
                    window=window)
            else:
                o = fp_ops.flash_chunk_prefill_paged(
                    qt, cache["k"], cache["v"], page_table, offsets, kt, vt,
                    window=window)
        else:
            for name, new in (("k", kw), ("v", vw)) + (
                    (("k_scale", ks), ("v_scale", vs)) if quant else ()):
                attention.write_rows(cache[name], new, offsets, chunk_mask)
            k_read, v_read = cache["k"], cache["v"]
            if quant:
                k_read = k_read.to(k.dtype) * cache["k_scale"][..., None]
                v_read = v_read.to(v.dtype) * cache["v_scale"][..., None]
            o = fp_ops.flash_chunk_prefill(
                qt, k_read.transpose(1, 2), v_read.transpose(1, 2), kt, vt,
                offsets, window=window)
    else:   # decode step, t == 1
        if page_table is not None:
            # a lane parked at max_seq writes the null page when max_seq is
            # a whole number of pages, else its final page's slack row
            attention.paged_update_kv_cache(cache["k"], cache["v"], kw, vw,
                                            page_table, cache_len)
            if quant:
                attention.paged_update_kv_scales(
                    cache["k_scale"], cache["v_scale"], ks, vs, page_table,
                    cache_len)
                o = da_ops.decode_attention_paged_quant(
                    qt, cache["k"], cache["v"], cache["k_scale"],
                    cache["v_scale"], page_table, cache_len + 1,
                    window=window)
            else:
                o = da_ops.decode_attention_paged(
                    qt, cache["k"], cache["v"], page_table, cache_len + 1,
                    window=window)
        else:
            attention.update_kv_cache(cache["k"], cache["v"], kw, vw,
                                      cache_len)
            k_read, v_read = cache["k"], cache["v"]
            if quant:
                # the JAX model's read: a bf16 dequantized copy of the rows,
                # f32(int8) * f32(bf16(scale)) rounded to bf16, for the
                # decode kernel (not fused here)
                attention.update_kv_cache(cache["k_scale"], cache["v_scale"],
                                          ks, vs, cache_len)
                k_read = dequant_bf16(k_read, cache["k_scale"])
                v_read = dequant_bf16(v_read, cache["v_scale"])
            o = da_ops.decode_attention(
                qt, k_read.transpose(1, 2), v_read.transpose(1, 2),
                cache_len + 1, window=window)
    o = o.transpose(1, 2).reshape(b, t, cfg.q_dim)
    return layers.linear_apply(p["o"], o, ctx)


def _block_apply(cfg, ctx, x, p, cache, positions, phase, cache_len=None,
                 chunk_mask=None, page_table=None):
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + _attn_apply(cfg, ctx, p["attn"], h, cache, positions, phase,
                        cache_len, chunk_mask, page_table)
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + layers.mlp_apply(p["mlp"], h, ctx)


def _run_layers(cfg, ctx, params, x, cache, positions, phase, cache_len=None,
                chunk_mask=None, page_table=None):
    for i, p in enumerate(params["layers"]):
        layer_cache = (None if cache is None
                       else {name: plane[i] for name, plane in cache.items()})
        x = _block_apply(cfg, ctx, x, p, layer_cache, positions, phase,
                         cache_len, chunk_mask, page_table)
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
                  admit_mask, last_index, page_table=None):
    """One admission wave -> (logits (b, vocab), cache).

    ``inputs`` (b, C) holds one prompt chunk per cache row; row i with
    ``admit_mask[i]`` sits at absolute positions offsets[i] + [0, C), writes
    its chunk KV there in place and attends its row's [0, offsets[i])
    prefix plus its own causal triangle.  Masked rows leave their cache row
    untouched.  ``last_index[i]`` is the chunk-local index of row i's last
    real prompt token, whose logits are returned.  With ``page_table``
    ((b, n_pages) int32) the cache is a page pool (``init_paged_cache``):
    row i's positions resolve through its table row, and masked rows'
    writes land in the null page."""
    require_attn(cfg)
    x = _embed_in(params, inputs, ctx)
    b, c = inputs.shape
    dev = x.device
    offsets = torch.as_tensor(offsets, dtype=torch.int32, device=dev)
    admit = torch.as_tensor(admit_mask, dtype=torch.bool, device=dev)
    positions = offsets[:, None] + torch.arange(c, device=dev)
    x = _run_layers(cfg, ctx, params, x, cache, positions, "chunk", offsets,
                    admit, page_table)
    idx = torch.as_tensor(last_index, device=dev).long()
    last = x[torch.arange(b, device=dev), idx][:, None]
    return _lm_head(cfg, params, last, ctx)[:, 0], cache


def decode_step(cfg: ModelConfig, params: nn.ModuleDict,
                inputs: torch.Tensor, ctx: Ctx, cache: dict, cache_len,
                page_table=None):
    """One token per row (b, 1) + cache + live lengths -> (logits
    (b, vocab), cache).  ``cache_len`` is an int or a (b,) tensor: row i
    writes its KV at cache_len[i], rotates by that position and attends its
    own [0, cache_len[i]] prefix.  With ``page_table`` ((b, n_pages) int32)
    the cache is a page pool and row i appends through its table row."""
    x = _embed_in(params, inputs, ctx)
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    positions = cl[..., None] + torch.arange(1, device=x.device)
    x = _run_layers(cfg, ctx, params, x, cache, positions, "step", cl,
                    page_table=page_table)
    return _lm_head(cfg, params, x, ctx)[:, 0], cache
