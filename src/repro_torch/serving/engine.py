"""Serving steps: prefill and single-token decode against the KV caches
(counterpart of ``repro.serving.engine``), greedy next token: ``[B]``, or
``[B, C]`` for a codebook arch (the argmax over the last axis)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_fn(cfg: ModelConfig, *, max_len: int = 0) -> Callable:
    def prefill_fn(model: M.CausalLM, tokens: torch.Tensor):
        logits, caches = M.prefill(model, tokens, max_len=max_len)
        return torch.argmax(logits, dim=-1), caches
    return prefill_fn


def make_decode_fn(cfg: ModelConfig) -> Callable:
    def decode_fn(model: M.CausalLM, caches, tokens: torch.Tensor, cur_pos: int):
        logits, caches = M.decode_step(model, caches, tokens, cur_pos)
        return torch.argmax(logits, dim=-1), caches
    return decode_fn


def decode_inputs(cfg: ModelConfig, batch: int, *, device=None) -> torch.Tensor:
    """Inputs of one decode step, zeros: token ids [B, 1], or for an
    embeddings arch stub embeddings [B, 1, D] in the compute dtype (the JAX
    engine's stub for the frontend that would embed the last codes)."""
    if cfg.input_mode == "embeddings":
        return torch.zeros((batch, 1, cfg.d_model), dtype=getattr(torch, cfg.compute_dtype),
                           device=device)
    return torch.zeros((batch, 1), dtype=torch.long, device=device)
