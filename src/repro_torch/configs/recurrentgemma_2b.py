"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 attn:recurrent.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000  [arXiv:2402.19427; hf]
Pattern: (rglru, rglru, local) repeated; 26 % 3 = 2 trailing rglru layers.
Local attention window 2048 (Griffin); head_dim = 256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    rnn_width=2560,
    conv_width=4,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    logit_softcap=30.0,
    supports_long_context=True,
)
