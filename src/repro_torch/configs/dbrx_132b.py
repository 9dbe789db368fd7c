"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

40L d_model=6144 48H (kv=8) ff_expert=10752 vocab=100352.
[hf:databricks/dbrx-base; unverified]
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    block_pattern=("attn",),
    act="silu",
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10_752, capacity_factor=1.25),
)
