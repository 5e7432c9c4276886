"""qwen1.5-0.5b — QKV bias, untied head [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (kv=16 = MHA) d_ff=2816 vocab=151936.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", block_kind="attn",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151936, qkv_bias=True,
)
