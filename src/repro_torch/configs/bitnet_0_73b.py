"""bitnet-0.73b — the paper's model (BitNet b1.58 0.73B).

49M embed+head (tied 32000x1536 table) + 680M decoder weights
(24L x (4*1536^2 attn + 3*1536*4096 FFN)).  W1.58A8 throughout; MHA;
SwiGLU; RMSNorm; RoPE (consecutive form, eq. 5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bitnet-0.73b", family="dense", block_kind="attn",
    n_layers=24, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=4096, vocab_size=32000, tie_embeddings=True,
)
