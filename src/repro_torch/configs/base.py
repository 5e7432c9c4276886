"""Model configuration dataclass (the port's own copy of the JAX package's).

Every field keeps the JAX name and default so a configuration reads the
same in both packages; the port runs every block kind: ``"attn"`` (dense
or MoE, token or embed frontend), ``"hymba"`` and ``"xlstm_pair"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    block_kind: str = "attn"       # attn | hymba | xlstm_pair
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    swa_window: Optional[int] = None   # sliding window (None = full causal)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_chunk: int = 128
    frontend: str = "token"
    rope_theta: float = 10000.0
    rope_style: str = "consecutive"  # paper eq. 5 (default) | "interleaved"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    ternary: bool = True
    group_size: int = 5            # base-3 pack group (paper G=3)
    ternary_head: bool = False     # BitNet keeps embed/head dense

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context (state or window)."""
        return (self.block_kind in ("hymba", "xlstm_pair")
                or self.swa_window is not None)

    def reduced(self, n_layers: int = 2, d_model: int = 64, n_heads: int = 2,
                n_kv_heads: int | None = None, d_ff: int | None = None,
                vocab_size: int = 128, n_experts: int | None = None,
                **extra) -> "ModelConfig":
        """Smoke-test-sized config of the same family/structure (same rule
        as the JAX package's, so both build identical reduced models)."""
        kv = n_kv_heads if n_kv_heads is not None else min(
            n_heads, max(1, self.n_kv_heads * n_heads // max(self.n_heads, 1)))
        changes = dict(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=max(1, kv), head_dim=d_model // n_heads,
            d_ff=(d_ff if d_ff is not None else
                  (0 if self.d_ff == 0 else d_model * 2)),
            vocab_size=vocab_size,
            swa_window=(None if self.swa_window is None
                        else min(self.swa_window, 16)),
            ssm_chunk=16 if self.ssm_state else self.ssm_chunk,
        )
        if self.n_experts:
            ne = n_experts if n_experts is not None else 4
            changes.update(n_experts=ne, top_k=min(self.top_k, ne))
        changes.update(extra)
        return dataclasses.replace(self, **changes)
