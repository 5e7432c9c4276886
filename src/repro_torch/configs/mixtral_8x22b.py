"""mixtral-8x22b — 8 experts top-2, SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
sliding-window attention (4096) -> long_500k runnable with a windowed cache.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", block_kind="attn",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768, n_experts=8, top_k=2, swa_window=4096,
)
