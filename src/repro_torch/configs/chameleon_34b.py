"""chameleon-34b [vlm] — early-fusion, VQ image tokens share the vocab.

48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536.  [arXiv:2405.09818; unverified]
The VQ-GAN image tokenizer is a modality frontend stub: input_specs() feeds
precomputed token ids (text + image tokens interleaved in one sequence).
QK-norm per the Chameleon stability recipe.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=65_536,
    block_pattern=("attn",),
    qk_norm=True,
    act="silu",
    rope_theta=10_000.0,
)
