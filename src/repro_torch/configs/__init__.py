"""Architecture registry of the port: the archs it can run today.

Dense (qwen2-7b, deepseek-7b, mistral-large-123b), gemma3 (gemma3-12b:
QK-norm, 5:1 local:global), VLM (chameleon-34b: QK-norm over token ids), MoE
(qwen3-moe-30b-a3b with QK-norm, dbrx-132b), xLSTM (xlstm-1.3b) and
RecurrentGemma (recurrentgemma-2b). The JAX package's musicgen-large
(codebook heads, embedding inputs) waits for a later slice of the port; see
``ROADMAP.md``.
"""
from __future__ import annotations

from .base import ModelConfig, MoEConfig
from .chameleon_34b import CONFIG as chameleon_34b
from .dbrx_132b import CONFIG as dbrx_132b
from .deepseek_7b import CONFIG as deepseek_7b
from .gemma3_12b import CONFIG as gemma3_12b
from .mistral_large_123b import CONFIG as mistral_large_123b
from .qwen2_7b import CONFIG as qwen2_7b
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .xlstm_1_3b import CONFIG as xlstm_1_3b

ARCHS = {c.name: c for c in (chameleon_34b, dbrx_132b, deepseek_7b, gemma3_12b,
                             mistral_large_123b, qwen2_7b, qwen3_moe_30b_a3b,
                             recurrentgemma_2b, xlstm_1_3b)}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {sorted(ARCHS)}); "
            "see ROADMAP.md, queue 1")
    return ARCHS[key]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (as ``repro.configs``)."""
    kw = dict(
        num_layers=max(len(cfg.block_pattern), 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window_size=min(cfg.window_size, 16) if cfg.window_size else 0,
        rnn_width=64 if cfg.rnn_width else 0,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                              capacity_factor=8.0)
    return cfg.with_(**kw)
