"""qwen2-7b [dense] — GQA kv=4, QKV bias. 28L d=3584 28H ff=18944 vocab=152064.

[arXiv:2407.10671; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    block_pattern=("attn",),
    qkv_bias=True,
    act="silu",
    rope_theta=1_000_000.0,
)
