"""Decoder-only model for every block kind: ``attn`` (dense SwiGLU or
top-k MoE FFN; token ids or, ``frontend="embed"``, precomputed embeddings
in), ``hymba`` (attention and SSM heads in parallel, averaged, then the
FFN) and ``xlstm_pair`` (an mLSTM and an sLSTM block a pair of layers, no
attention, no FFN): parameters, the three serving entry points, and the
QAT training forward of every kind.

Counterpart of ``repro/models/transformer.py`` (contiguous or paged
caches):

  * ``prefill_step``  — full prompt -> last-token logits + filled cache
    (KV, and for the recurrent kinds the state after the prompt)
  * ``prefill_chunk`` — one admission wave: per-slot prompt chunks written
    in place at per-row offsets of the shared multi-slot cache, each
    attending its already-written prefix (``attn`` only, as in JAX)
  * ``decode_step``   — one token per row + cache + live lengths -> next
    logits
  * ``forward`` / ``forward_features`` — every position's logits / final
    hidden states, no cache (training, each block recomputed in the
    backward), and ``lm_head_loss_chunked``, the loss a sequence chunk at a
    time

Parameters are an ``nn.ModuleDict`` shaped like the JAX pytree —
``layers`` (one ``ModuleDict`` per block instead of a stacked axis: its
``attn``, hymba's ``ssm``, its FFN ``mlp`` or, with experts, ``moe``; or an
xLSTM pair's ``mlstm`` and ``slstm``), ``final_norm``, ``embed`` (token
frontend only) and, untied or embed frontend, ``lm_head`` — whose leaves
are the modules of ``core.bitlinear`` and ``models.layers`` (a sub-layer's
linears and dense tensors in a ``layers.Params``).  An embed model takes
(b, s, d_model) inputs where a token model takes (b, s) ids.  The cache
keeps the JAX layouts and names: contiguous ``{"k", "v"}`` of shape
(L, b, S, kv_h, hd) (``init_cache``), or a page pool of shape (L,
num_pages, page_size, kv_h, hd) read through a (b, n_pages) block table
(``init_paged_cache``, ``page_table=`` of ``prefill_chunk`` and
``decode_step``; ``attn`` only); with int8 KV (``kv_quant=True``) the K/V
planes are int8 and ``{"k_scale", "v_scale"}`` hold their per-(token,
head) f32 scales, the same shapes without hd.  hymba's cache adds
``"ssm": {"h": (L, b, H, N, hd) f32, "conv": (L, b, ssm_conv - 1, H * hd)
in the cache dtype}``; an xLSTM cache is ``{"mlstm": {"C": (L/2, b, H, hd,
hd), "n": (L/2, b, H, hd), "m": (L/2, b, H)}, "slstm": {"c", "n", "h",
"m": (L/2, b, H, hd)}}``, all f32, every ``m`` starting at -1e30.  The
cache is updated IN PLACE, state planes included (a prompt's state
replaces the rows' state; a decode step advances it): every entry point
returns the cache dict it was given.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bitlinear
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import dequant_bf16
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.models import attention, layers, ssm, xlstm
from repro_torch.models.layers import Ctx, Embedding, RMSNorm


def n_scan_layers(cfg: ModelConfig) -> int:
    """Blocks in the stack: one a layer, or one a pair of layers for
    ``xlstm_pair``."""
    if cfg.block_kind == "xlstm_pair":
        assert cfg.n_layers % 2 == 0
        return cfg.n_layers // 2
    return cfg.n_layers


def _refuse_recurrent(cfg: ModelConfig, what: str) -> None:
    if cfg.block_kind != "attn":
        raise NotImplementedError(
            f"{what} requires block_kind='attn' (got {cfg.block_kind!r})")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _draw(cfg: ModelConfig, generator: torch.Generator,
          pack_g: int | None) -> nn.ModuleDict:
    """Random weights, drawn from ``generator`` on its device (normal/
    sqrt(n_in) linears, zero biases, unit norms, 0.02 embeddings, expert
    banks normal/sqrt(d_model); the SSM's and sLSTM's dense tensors at
    JAX's scales), in one fixed order: each block's Q, K, V, O, then (hymba)
    its SSM, then its FFN (gate, up, down; or the router and the gate, up
    and down banks); an ``xlstm_pair`` block its mLSTM, then its sLSTM;
    then the embedding and the LM head.  With ``pack_g`` every ternary
    linear and bank is packed as soon as it is drawn, so no two float banks
    are held at once; the result equals packing the masters."""
    dev = generator.device

    def lin(n_in, n_out, bias=False):
        return layers.linear_init(generator, n_in, n_out, bias=bias,
                                  pack_g=pack_g)

    def norm():
        return RMSNorm(torch.ones(cfg.d_model, device=dev))

    blocks = nn.ModuleList()
    for _ in range(n_scan_layers(cfg)):
        if cfg.block_kind == "xlstm_pair":
            blocks.append(nn.ModuleDict({
                "ln1": norm(),
                "mlstm": xlstm.mlstm_init(generator, cfg.d_model,
                                          cfg.n_heads, cfg.hd, pack_g=pack_g),
                "ln2": norm(),
                "slstm": xlstm.slstm_init(generator, cfg.d_model,
                                          cfg.n_heads, cfg.hd,
                                          pack_g=pack_g)}))
            continue
        block = nn.ModuleDict({
            "ln1": norm(), "ln2": norm(),
            "attn": nn.ModuleDict({
                "q": lin(cfg.d_model, cfg.q_dim, cfg.qkv_bias),
                "k": lin(cfg.d_model, cfg.kv_dim, cfg.qkv_bias),
                "v": lin(cfg.d_model, cfg.kv_dim, cfg.qkv_bias),
                "o": lin(cfg.q_dim, cfg.d_model)})})
        if cfg.block_kind == "hymba":
            block["ssm"] = ssm.ssm_init(generator, cfg.d_model, cfg.n_heads,
                                        cfg.hd, cfg.ssm_state, cfg.ssm_conv,
                                        pack_g=pack_g)
        if cfg.n_experts:
            block["moe"] = layers.moe_init(generator, cfg.d_model, cfg.d_ff,
                                           cfg.n_experts, pack_g=pack_g)
        elif cfg.d_ff:
            block["mlp"] = nn.ModuleDict({
                "gate": lin(cfg.d_model, cfg.d_ff),
                "up": lin(cfg.d_model, cfg.d_ff),
                "down": lin(cfg.d_ff, cfg.d_model)})
        blocks.append(block)
    params = nn.ModuleDict({"layers": blocks, "final_norm": norm()})
    if cfg.frontend == "token":
        params["embed"] = Embedding(torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=generator,
            device=dev) * 0.02)
    if not cfg.tie_embeddings or cfg.frontend != "token":
        # the LM head stays dense (ternary_head=False, as JAX packs it)
        params["lm_head"] = bitlinear.init(generator, cfg.d_model,
                                           cfg.vocab_size)
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator) -> nn.ModuleDict:
    """Random float master weights (``_draw``'s order and scales)."""
    return _draw(cfg, generator, None)


def init_packed_params(cfg: ModelConfig,
                       generator: torch.Generator) -> nn.ModuleDict:
    """``pack_params(cfg, init_params(cfg, generator))`` without holding the
    masters: each linear and expert bank is packed as soon as it is drawn
    (a full-width MoE layer's float banks would take ~10 GB)."""
    return _draw(cfg, generator, cfg.group_size)


def pack_params(cfg: ModelConfig, params: nn.ModuleDict) -> nn.ModuleDict:
    """Offline stage: base-3 pack every ternary linear and expert bank
    (norms, the router, the SSM's and sLSTM's dense tensors, embedding and
    the dense LM head are shared with ``params``)."""
    g = cfg.group_size
    blocks = nn.ModuleList()
    for p in params["layers"]:
        block = nn.ModuleDict({"ln1": p["ln1"], "ln2": p["ln2"]})
        if "mlstm" in p:
            block["mlstm"] = xlstm.mlstm_pack(p["mlstm"], g)
            block["slstm"] = xlstm.slstm_pack(p["slstm"], g)
            blocks.append(block)
            continue
        block["attn"] = nn.ModuleDict({n: bitlinear.pack(m, g)
                                       for n, m in p["attn"].items()})
        if "ssm" in p:
            block["ssm"] = ssm.ssm_pack(p["ssm"], g)
        if "moe" in p:
            block["moe"] = layers.moe_pack(p["moe"], g)
        if "mlp" in p:
            block["mlp"] = nn.ModuleDict({n: bitlinear.pack(m, g)
                                          for n, m in p["mlp"].items()})
        blocks.append(block)
    out = nn.ModuleDict({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = blocks
    return out


def predecode_packed(cfg: ModelConfig, params: nn.ModuleDict) -> nn.ModuleDict:
    """Decode every layer's packed codes into dense ternary matrices, fusing
    Q|K|V and gate|up into one matrix each (one activation quant and one
    GEMM per projection group); the SSM's, mLSTM's and sLSTM's linears are
    decoded one by one and their dense tensors pass through, as in JAX.
    Outputs equal the packed path's exactly (see ``bitlinear.predecode``).
    Expert banks stay packed, as in JAX: the MoE runs them through
    ``tlmm`` an expert at a time."""
    blocks = nn.ModuleList()
    for p in params["layers"]:
        block = nn.ModuleDict({"ln1": p["ln1"], "ln2": p["ln2"]})
        if "mlstm" in p:
            block["mlstm"] = layers.predecode_all(p["mlstm"])
            block["slstm"] = layers.predecode_all(p["slstm"])
            blocks.append(block)
            continue
        a = p["attn"]
        block["attn"] = nn.ModuleDict({
            "qkv": bitlinear.predecode_fused([a["q"], a["k"], a["v"]]),
            "o": bitlinear.predecode(a["o"])})
        if "ssm" in p:
            block["ssm"] = layers.predecode_all(p["ssm"])
        if "moe" in p:
            block["moe"] = p["moe"]
        if "mlp" in p:
            m = p["mlp"]
            block["mlp"] = nn.ModuleDict({
                "gateup": bitlinear.predecode_fused([m["gate"], m["up"]]),
                "down": bitlinear.predecode(m["down"])})
        blocks.append(block)
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
    int8 with (L, batch, max_len, kv_h) f32 scale planes (``kv_quant``).
    hymba adds ``{"ssm": {"h", "conv"}}``: the SSM state (L, batch, H, N,
    hd) in f32 and the conv ring (L, batch, ssm_conv - 1, H * hd) in
    ``dtype``.  ``xlstm_pair`` keeps no K/V: ``{"mlstm": {"C", "n", "m"},
    "slstm": {"c", "n", "h", "m"}}`` over its L / 2 blocks, all f32, each
    ``m`` at -1e30 (``max_len`` unused)."""
    n_scan = n_scan_layers(cfg)

    def stack(state: dict) -> dict:
        return {k: v[None].repeat((n_scan,) + (1,) * v.ndim)
                for k, v in state.items()}

    if cfg.block_kind == "xlstm_pair":
        return {"mlstm": stack(xlstm.mlstm_init_state(
                    batch, cfg.n_heads, cfg.hd, device=device)),
                "slstm": stack(xlstm.slstm_init_state(
                    batch, cfg.n_heads, cfg.hd, device=device))}
    cache = _kv_planes((n_scan, batch, max_len, cfg.n_kv_heads), cfg.hd,
                       dtype, kv_quant, device)
    if cfg.block_kind == "hymba":
        cache["ssm"] = stack(ssm.ssm_init_state(
            batch, cfg.n_heads, cfg.hd, cfg.ssm_state, cfg.ssm_conv,
            cfg.n_heads * cfg.hd, dtype, device))
    return cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cuda", *,
                     kv_quant: bool = False) -> dict:
    """Paged cache: a pool of ``num_pages`` pages of ``page_size`` tokens,
    K/V (L, num_pages, page_size, kv_h, hd), shared by every slot through
    block tables (``attention.paged_update_kv_cache``); page 0 is the null
    page.  With ``kv_quant`` the pools are int8 and the scale planes
    (L, num_pages, page_size, kv_h) ride the same page axis.  Attention
    blocks only: recurrent state is O(1) a slot, with nothing to page."""
    _refuse_recurrent(cfg, "paged KV cache")
    return _kv_planes((cfg.n_layers, num_pages, page_size, cfg.n_kv_heads),
                      cfg.hd, dtype, kv_quant, device)


def copy_paged_page(cache: dict, src: int, dst: int) -> dict:
    """Copy pool page ``src`` onto ``dst`` in every layer and plane of a
    paged cache (``attention.copy_kv_page``; the page axis is 1, after the
    layer axis), in place — the serving engine's copy-on-write split of a
    partly shared prefix page.  Returns ``cache``."""
    for pool in cache.values():
        attention.copy_kv_page(pool, src, dst, page_axis=1)
    return cache


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
    n_heads, n_kv = cfg.n_heads, cfg.n_kv_heads
    # tensor-parallel (runtime/sharding.py): this rank's heads; K and V
    # split inside a head are gathered and cut to the rank's query heads
    tp = ctx.constrain is not None and ctx.constrain.tp
    kv_whole = False
    if tp:
        m, rank = ctx.constrain.model_size, ctx.constrain.model_rank
        n_heads //= m
        kv_whole = n_kv % m != 0
        n_kv = n_heads if kv_whole else n_kv // m
    if "qkv" in p:   # fused projection (pre-decoded serving hot path)
        q, k, v = layers.linear_apply(p["qkv"], x, ctx).split(
            [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        q = layers.linear_apply(p["q"], x, ctx)
        kl, vl = p["k"], p["v"]
        if kv_whole:
            kl = ctx.constrain.whole(kl, partial=True)
            vl = ctx.constrain.whole(vl, partial=True)
        k = layers.linear_apply(kl, x, ctx)
        v = layers.linear_apply(vl, x, ctx)
    if kv_whole:   # every KV head, repeated to the rank's query heads
        group = cfg.n_heads // cfg.n_kv_heads
        lo = rank * n_heads
        k, v = (z.reshape(b, t, cfg.n_kv_heads, cfg.hd).repeat_interleave(
            group, 2)[:, :, lo:lo + n_heads] for z in (k, v))
    q = q.reshape(b, t, n_heads, cfg.hd)
    k = k.reshape(b, t, n_kv, cfg.hd)
    v = v.reshape(b, t, n_kv, cfg.hd)
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
        if ctx.attn == "kernel":
            if torch.is_grad_enabled() and qt.requires_grad:
                raise NotImplementedError(
                    "the flash prefill kernel has no backward (nor has the "
                    "reference's Pallas one): train on Ctx(attn='skip')")
            o = fp_ops.flash_prefill(qt, kt, vt, window=window)
        else:   # the Fig. 6b baselines, plain PyTorch
            fn = (attention.attention_skip if ctx.attn == "skip"
                  else attention.attention_naive)
            o = fn(qt, kt, vt, causal=True, window=window,
                   q_chunk=ctx.attn_q_chunk, kv_chunk=ctx.attn_kv_chunk)
    elif phase == "chunk":
        # admission wave: rows with chunk_mask write their chunk's KV at
        # offset cache_len[i] of their own row (contiguous) or through their
        # block-table row (paged; masked rows write the null page); masked
        # rows' outputs are don't-care.  Attention reads the prefix from the
        # cache and the chunk's own span from its fresh full-precision K/V —
        # the JAX model's cast-and-overlay, without copying the cache — so
        # within-chunk numerics match monolithic prefill.  An int8 cache is
        # read dequantized in the activation dtype, as in JAX: int8 and
        # scale each cast to it, then multiplied (exact casts in f32).
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
                k_read = (k_read.to(k.dtype)
                          * cache["k_scale"][..., None].to(k.dtype))
                v_read = (v_read.to(v.dtype)
                          * cache["v_scale"][..., None].to(v.dtype))
            o = fp_ops.flash_chunk_prefill(
                qt, k_read.transpose(1, 2), v_read.transpose(1, 2), kt, vt,
                offsets, window=window)
    else:   # decode step, t == 1
        # with ctx.kv_splits every read below is split-K (plain PyTorch,
        # over ctx.kv_group when set) instead of a decode kernel, as in JAX
        splitk = bool(ctx.kv_splits)
        read_kw = ({"ctx": ctx, "window": window} if splitk
                   else {"window": window})
        if page_table is not None:
            # a lane parked at max_seq writes the null page when max_seq is
            # a whole number of pages, else its final page's slack row
            attention.paged_update_kv_cache(cache["k"], cache["v"], kw, vw,
                                            page_table, cache_len)
            if quant:
                attention.paged_update_kv_scales(
                    cache["k_scale"], cache["v_scale"], ks, vs, page_table,
                    cache_len)
                read = (attention.paged_splitk_decode_attention_quant
                        if splitk else da_ops.decode_attention_paged_quant)
                o = read(qt, cache["k"], cache["v"], cache["k_scale"],
                         cache["v_scale"], page_table, cache_len + 1,
                         **read_kw)
            else:
                read = (attention.paged_splitk_decode_attention if splitk
                        else da_ops.decode_attention_paged)
                o = read(qt, cache["k"], cache["v"], page_table,
                         cache_len + 1, **read_kw)
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
            read = (attention.splitk_decode_attention if splitk
                    else da_ops.decode_attention)
            o = read(qt, k_read.transpose(1, 2), v_read.transpose(1, 2),
                     cache_len + 1, **read_kw)
    o = o.transpose(1, 2).reshape(b, t, n_heads * cfg.hd)
    return layers.linear_apply(p["o"], o, ctx)


def _write_state(planes: dict, state: dict) -> None:
    """Copy a sub-layer's new recurrent state into its cache planes in
    place (casting to the plane's dtype), as the KV is written: the
    captured decode block replays on the same planes."""
    for name, plane in planes.items():
        plane.copy_(state[name])


def _xlstm_pair_apply(cfg, ctx, x, p, cache, phase):
    """mLSTM then sLSTM, each pre-normed and residual.  "full" runs both
    scans over the sequence (writing the state after it into ``cache``
    when one is given); "step" advances the state by one token."""
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.hd)
    for norm, name, forward, step, extra in (
            ("ln1", "mlstm", xlstm.mlstm_forward, xlstm.mlstm_step,
             {"chunk": cfg.ssm_chunk or 128}),
            ("ln2", "slstm", xlstm.slstm_forward, xlstm.slstm_step, {})):
        h = _mixer_in(ctx, layers.rmsnorm(p[norm], x, cfg.norm_eps))
        mctx, pm = _mixer(ctx, p[name])
        if phase == "full":
            out = forward(pm, h, mctx, return_state=cache is not None,
                          **kw, **extra)
            if cache is not None:
                out, state = out
                _write_state(cache[name], state)
        else:
            out, state = step(pm, h, cache[name], mctx, **kw)
            _write_state(cache[name], state)
        x = x + _mixer_out(ctx, out)
    return x


def _mixer_in(ctx: Ctx, h: torch.Tensor) -> torch.Tensor:
    """A block's normed input entering its mixer (``Constrain.mixer_in``:
    Megatron's f, or the whole residual for a mixer run whole)."""
    c = ctx.constrain
    return c.mixer_in(h) if c is not None else h


def _mixer(ctx: Ctx, p):
    """(context, weights) a mixer runs with: on a "model" axis that does
    not divide the heads, hooks off and weights gathered whole."""
    c = ctx.constrain
    if c is None:
        return ctx, p
    return c.mixer_ctx(ctx), c.mixer_params(p)


def _mixer_out(ctx: Ctx, y: torch.Tensor) -> torch.Tensor:
    c = ctx.constrain
    return c.mixer_out(y) if c is not None else y


def _block_apply(cfg, ctx, x, p, cache, positions, phase, cache_len=None,
                 chunk_mask=None, page_table=None):
    if cfg.block_kind == "xlstm_pair":
        return _xlstm_pair_apply(cfg, ctx, x, p, cache, phase)
    h = _mixer_in(ctx, layers.rmsnorm(p["ln1"], x, cfg.norm_eps))
    mctx, pa = _mixer(ctx, p["attn"])
    attn_out = _attn_apply(cfg, mctx, pa, h, cache, positions, phase,
                           cache_len, chunk_mask, page_table)
    if cfg.block_kind == "hymba":
        # attention and SSM heads in parallel on the same input, averaged
        kw = dict(n_heads=cfg.n_heads, head_dim=cfg.hd, state=cfg.ssm_state)
        ps = _mixer(ctx, p["ssm"])[1]
        if phase == "full":
            ssm_out = ssm.ssm_forward(ps, h, mctx, chunk=cfg.ssm_chunk,
                                      return_state=cache is not None, **kw)
            if cache is not None:
                ssm_out, state = ssm_out
                _write_state(cache["ssm"], state)
        else:
            ssm_out, state = ssm.ssm_step(ps, h, cache["ssm"], mctx, **kw)
            _write_state(cache["ssm"], state)
        attn_out = 0.5 * (attn_out + ssm_out.to(attn_out.dtype))
    x = x + _mixer_out(ctx, attn_out)
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    c = ctx.constrain
    tp = c is not None and c.tp
    if "moe" in p:
        h = ctx.c(h, "tp_in")
        b, t, d = h.shape
        out = layers.moe_apply(p["moe"], h.reshape(b * t, d),
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor, ctx=ctx)
        out = out.reshape(b, t, d)
        # each "model" rank's experts: partial sums
        return x + (c.row_out(out) if tp else out)
    if "mlp" in p:
        if tp and not c.ffn_split:
            # "model" does not divide d_ff: the FFN runs whole on every
            # rank's own residual (its part of the sequence under SP)
            mlp = c.whole(p["mlp"], partial=c.sp_now)
            return x + layers.mlp_apply(mlp, h, ctx)
        return x + layers.mlp_apply(p["mlp"], ctx.c(h, "tp_in"), ctx)
    return x


def _layer_cache(cache, i: int):
    """Layer i's views of every cache plane, nested as the cache is."""
    if cache is None:
        return None
    return {name: (_layer_cache(plane, i) if isinstance(plane, dict)
                   else plane[i]) for name, plane in cache.items()}


def _remat_context(ctx: Ctx):
    """``context_fn`` of a block's checkpoint: keep nothing, or, with
    ``remat_policy="dots"``, the outputs of the linears' products (matrix
    products without batch dimensions, JAX's
    ``dots_with_no_batch_dims_saveable``) and recompute the rest."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts,
                                        noop_context_fn)
    if ctx.remat_policy != "dots":
        return noop_context_fn
    aten = torch.ops.aten

    def policy(_, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in (aten.mm.default,
                                                     aten.addmm.default)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _run_layers(cfg, ctx, params, x, cache, positions, phase, cache_len=None,
                chunk_mask=None, page_table=None, remat=False):
    """Every block in order.  With ``remat`` (a training forward) each
    block runs under ``torch.utils.checkpoint``, so the backward recomputes
    what ``ctx.remat_policy`` does not keep, as JAX's scanned
    ``jax.checkpoint`` body does."""
    remat = remat and torch.is_grad_enabled()
    context_fn = _remat_context(ctx) if remat else None
    for i, p in enumerate(params["layers"]):
        layer_cache = _layer_cache(cache, i)
        x = ctx.c(x, "residual")   # the SP layout between blocks
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _block_apply, cfg, ctx, x, p, layer_cache, positions, phase,
                cache_len, chunk_mask, page_table, use_reentrant=False,
                context_fn=context_fn)
        else:
            x = _block_apply(cfg, ctx, x, p, layer_cache, positions, phase,
                             cache_len, chunk_mask, page_table)
    return x


def apply_blocks(cfg: ModelConfig, blocks, x: torch.Tensor, ctx: Ctx
                 ) -> torch.Tensor:
    """Hidden states (b, s, d_model) through ``blocks`` (some of
    ``params["layers"]``) in order, no cache, no remat: a pipeline
    stage's forward (``runtime.pipeline``)."""
    positions = torch.arange(x.shape[1], device=x.device)
    for p in blocks:
        x = _block_apply(cfg, ctx, x, p, None, positions, "full")
    return x


def _embed_in(cfg, params, inputs, ctx):
    """Token ids (b, s) through the embedding, or, ``frontend="embed"``,
    precomputed embeddings (b, s, d_model) as they are; in the activation
    dtype."""
    if cfg.frontend == "token":
        x = layers.embed_apply(params["embed"], inputs, ctx)
    else:
        x = inputs
    return ctx.c(x.to(ctx.act_dtype), "embed")


def _lm_head(cfg, params, x, ctx):
    """Final norm and unembedding; on a training mesh the logits are split
    on the vocabulary where "model" divides it (``Ctx.constrain``)."""
    x = ctx.c(layers.rmsnorm(params["final_norm"], x, cfg.norm_eps),
              "head_in")
    if cfg.tie_embeddings and "embed" in params:
        logits = torch.einsum("btd,vd->btv", x,
                              params["embed"].tok.to(x.dtype))
    else:
        head = params["lm_head"]
        if ctx.constrain is not None and ctx.constrain.tp and not (
                ctx.constrain.vocab_split):   # JAX splits its d_model
            head = ctx.constrain.whole(head, partial=False)
        logits = layers.linear_apply(head, x, ctx,
                                     ternary_w=cfg.ternary_head)
    return ctx.c(logits, "logits")


def xent_sum(logits: torch.Tensor, labels: torch.Tensor, ctx: Ctx
             ) -> torch.Tensor:
    """Sum over positions of logsumexp - gold logit (f32), over logits
    split on the vocabulary on a training mesh."""
    if ctx.constrain is not None and ctx.constrain.vocab_split:
        return ctx.constrain.xent_sum(logits, labels)
    lf = logits.float()
    return (torch.logsumexp(lf, dim=-1) - gold_logits(lf, labels)).sum()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward_features(cfg: ModelConfig, params: nn.ModuleDict,
                     inputs: torch.Tensor, ctx: Ctx,
                     remat: bool = True) -> torch.Tensor:
    """Backbone only: final hidden states (b, s, d_model) of every
    position, no cache, for every block kind (attention with a dense or
    MoE FFN, hymba's attention and SSM heads, xLSTM pairs).  With ``remat``
    and gradients on, each block is recomputed in the backward
    (``_run_layers``)."""
    x = _embed_in(cfg, params, inputs, ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    return _run_layers(cfg, ctx, params, x, None, positions, "full",
                       remat=remat)


def forward(cfg: ModelConfig, params: nn.ModuleDict, inputs: torch.Tensor,
            ctx: Ctx, remat: bool = True) -> torch.Tensor:
    """Training/eval forward: logits of every position (b, s, vocab)."""
    x = forward_features(cfg, params, inputs, ctx, remat)
    return _lm_head(cfg, params, ctx.c(x, "features"), ctx)


def gold_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels] position by position, by advanced indexing: its
    backward accumulates through ``index_put_``, which has a deterministic
    CUDA implementation (``torch.use_deterministic_algorithms``)."""
    flat = logits.reshape(-1, logits.shape[-1])
    rows = torch.arange(flat.shape[0], device=logits.device)
    return flat[rows, labels.reshape(-1).long()].reshape(labels.shape)


def _chunk_loss(cfg, params, ctx, x, labels):
    return xent_sum(_lm_head(cfg, params, x, ctx), labels, ctx)


def lm_head_loss_chunked(cfg: ModelConfig, params: nn.ModuleDict,
                         x: torch.Tensor, labels: torch.Tensor, ctx: Ctx,
                         chunk: int = 512) -> torch.Tensor:
    """Final norm, unembedding and mean cross-entropy over sequence chunks
    of ``chunk`` positions (the whole sequence where it does not divide
    it), each chunk under a checkpoint: its (b, chunk, vocab) logits are
    recomputed in the backward and the (b, s, vocab) logits never exist.
    The chunks' sums add in order from 0, then divide by b * s, as JAX's
    scan does."""
    x = ctx.c(x, "features")   # JAX's residual constraint before chunking
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        xc, lc = x[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(
                _chunk_loss, cfg, params, ctx, xc, lc, use_reentrant=False)
        else:
            part = _chunk_loss(cfg, params, ctx, xc, lc)
        total = total + part
    return total / (b * s)


def prefill_step(cfg: ModelConfig, params: nn.ModuleDict,
                 inputs: torch.Tensor, ctx: Ctx, cache: dict,
                 lengths: torch.Tensor | None = None):
    """Prompt (b, s) -> (last-token logits (b, vocab), cache).  With
    ``lengths`` ((b,) int) row i's logits are taken at position
    lengths[i] - 1 of a right-padded batch.  An embed model takes
    (b, s, d_model) embeddings."""
    x = _embed_in(cfg, params, inputs, ctx)
    b, s = x.shape[:2]
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
    writes land in the null page.  Attention blocks only: a recurrent
    state cannot resume chunk to chunk (the engine prefills those kinds
    whole)."""
    _refuse_recurrent(cfg, "chunked prefill")
    x = _embed_in(cfg, params, inputs, ctx)
    b, c = x.shape[:2]
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
    the cache is a page pool and row i appends through its table row.  An
    embed model takes (b, 1, d_model) embeddings."""
    x = _embed_in(cfg, params, inputs, ctx)
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    positions = cl[..., None] + torch.arange(1, device=x.device)
    x = _run_layers(cfg, ctx, params, x, cache, positions, "step", cl,
                    page_table=page_table)
    return _lm_head(cfg, params, x, ctx)[:, 0], cache
