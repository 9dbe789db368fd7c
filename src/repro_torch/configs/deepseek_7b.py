"""deepseek-7b [dense] — llama-arch. 30L d=4096 32H (kv=32) ff=11008 vocab=102400.

[arXiv:2401.02954; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11_008,
    vocab_size=102_400,
    block_pattern=("attn",),
    act="silu",
    rope_theta=10_000.0,
)
