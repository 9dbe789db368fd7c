"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048, 4 codebooks (delay pattern).
[arXiv:2306.05284; hf]
The EnCodec frontend is a modality stub: input_specs() provides precomputed
per-frame embeddings [B, S, d_model] (sum of the 4 codebook embeddings); the
output is 4 codebook heads of vocab 2048 each.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=("attn",),
    norm="layernorm",
    act="gelu",
    num_codebooks=4,
    input_mode="embeddings",
    rope_theta=10_000.0,
)
