"""gemma3-12b [dense] — 5:1 local:global, 128k context.

48L d_model=3840 16H (kv=8) d_ff=15360 vocab=262144, head_dim=256, window=1024.
[hf:google/gemma-3-1b-pt; unverified]
Runs long_500k: only the 8 global layers keep a full-length KV cache.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window_size=1024,
    act="gelu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    tie_embeddings=True,
    supports_long_context=True,
)
