"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (kv=24 = MHA) d_ff=6144 vocab=2048.  The EnCodec
modality frontend is a stub: the model takes
precomputed frame embeddings (b, s, d_model); the transformer backbone is
what is modeled.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", block_kind="attn",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, frontend="embed",
)
