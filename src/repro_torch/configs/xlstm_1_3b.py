"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, xLSTM[7:1] ratio.

48L d_model=2048 4H vocab=50304, d_ff=0 (blocks carry their own projections).
[arXiv:2405.04517; unverified]
Pattern: 7 mLSTM : 1 sLSTM, repeated 6x over 48 layers.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    norm="layernorm",
    act="gelu",
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    supports_long_context=True,
)
