"""mistral-large-123b [dense] — 88L d=12288 96H (kv=8) ff=28672 vocab=32768.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
The memory-pressure stress case of the pool: ~123B params.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    block_pattern=("attn",),
    act="silu",
    rope_theta=1_000_000.0,
)
