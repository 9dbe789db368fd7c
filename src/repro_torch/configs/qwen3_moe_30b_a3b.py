"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained (ff_expert=768).

48L d_model=2048 32H (kv=4) vocab=151936.  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert ff (dense path unused)
    vocab_size=151_936,
    block_pattern=("attn",),
    qk_norm=True,
    act="silu",
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768, capacity_factor=1.25),
)
