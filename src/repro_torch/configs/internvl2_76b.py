"""internvl2-76b — InternViT + InternLM2 backbone [arXiv:2404.16821; unverified].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The InternViT
vision frontend is a stub: the model takes
precomputed patch embeddings; the LM backbone is modeled.  Full attention ->
long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", block_kind="attn",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, frontend="embed",
)
