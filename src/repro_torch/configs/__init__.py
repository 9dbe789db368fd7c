"""Architecture registry of the port: the archs it can run today.

Dense (qwen2-7b, deepseek-7b), xLSTM (xlstm-1.3b) and RecurrentGemma
(recurrentgemma-2b). The JAX package's other architectures (MoE, gemma3,
multimodal) wait for later slices of the port; see ``ROADMAP.md``.
"""
from __future__ import annotations

from .base import ModelConfig, MoEConfig
from .deepseek_7b import CONFIG as deepseek_7b
from .qwen2_7b import CONFIG as qwen2_7b
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .xlstm_1_3b import CONFIG as xlstm_1_3b

ARCHS = {c.name: c for c in (deepseek_7b, qwen2_7b, recurrentgemma_2b, xlstm_1_3b)}


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
