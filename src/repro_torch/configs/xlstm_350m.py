"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0: no separate FFN —
the xLSTM blocks carry their own projections.  Attention-free: the paper's
RPA/DA attention units are inapplicable; ternary BitLinear
projections apply throughout.  Runs long_500k (O(1) recurrent state).  The
port's engine admits its prompts whole.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm", block_kind="xlstm_pair",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
)
