"""hymba-1.5b — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each block runs attention heads and Mamba(SSD) heads in parallel on the same
normalized input and averages the outputs.  Sliding-window attention (1024,
per the Hymba recipe for all-but-a-few layers; simplified to all layers here)
+ SSM state make long_500k runnable.  The port's engine admits its prompts
whole (the SSM state cannot resume chunk to chunk).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", block_kind="hymba",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, ssm_state=16, swa_window=1024,
)
