"""Causal self-attention with GQA and a KV cache (counterpart of
``repro.models.attention``).

Prefill attention goes through the port's ``flash_attention`` and decode
attention through its ``decode_attention``: on the card each is a CUDA
kernel, on the CPU its plain version. The cache layout is the JAX package's:
``k``/``v`` ``[B, L, K, hd]``, ``pos [L]`` int32 with -1 for an empty slot,
position p in slot ``p % L`` (a ring buffer for sliding-window layers).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import Dense, apply_rope

Cache = Dict[str, torch.Tensor]


def cache_len(max_len: int, window: int) -> int:
    return min(window, max_len) if window else max_len


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  window: int = 0, dtype=torch.bfloat16, device=None) -> Cache:
    """Empty KV cache of one attention layer."""
    L = cache_len(max_len, window)
    shape = (batch, L, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((L,), -1, dtype=torch.int32, device=device)}


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, window: int, theta: float,
                 dtype, device):
        super().__init__()
        if cfg.qk_norm:
            raise NotImplementedError("qk_norm is not ported yet (ROADMAP.md, queue 1)")
        d = cfg.d_model
        self.cfg, self.window, self.theta = cfg, window, theta
        self.wq = Dense(d, cfg.q_dim, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wk = Dense(d, cfg.kv_dim, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wv = Dense(d, cfg.kv_dim, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wo = Dense(cfg.q_dim, d, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for dense in (self.wq, self.wk, self.wv, self.wo):
            dense.reset_parameters(generator)

    def _project_qkv(self, x, positions):
        """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,K,hd], rope applied."""
        B, S, _ = x.shape
        cfg = self.cfg
        q = self.wq(x).reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = self.wk(x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        return (apply_rope(q, positions, self.theta),
                apply_rope(k, positions, self.theta), v)

    def prefill(self, x: torch.Tensor, max_len: int) -> Tuple[torch.Tensor, Cache]:
        """Full-sequence attention and the cache filled for decoding.

        The cache has ``max(max_len, S)`` slots (``window`` for a local
        layer); the last ``min(L, S)`` positions are stored at ``p % L``.
        """
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        q, k, v = self._project_qkv(x, positions)
        out = flash_attention(q, k, v, causal=True, window=self.window)
        y = self.wo(out.reshape(B, S, self.cfg.q_dim))
        L = cache_len(max(max_len or S, S), self.window)
        keep = min(L, S)
        kv_pos = positions[S - keep:]
        slots = kv_pos % L
        cache = init_kv_cache(self.cfg, B, L, dtype=k.dtype, device=x.device)
        cache["k"][:, slots] = k[:, S - keep:]
        cache["v"][:, slots] = v[:, S - keep:]
        cache["pos"][slots] = kv_pos.to(torch.int32)
        return y, cache

    def decode(self, x: torch.Tensor, cache: Cache,
               cur_pos: int) -> Tuple[torch.Tensor, Cache]:
        """One token, x [B,1,D], at position ``cur_pos`` (a Python int).

        Writes the new k/v into slot ``cur_pos % L`` of ``cache`` in place
        and returns it with the block output.
        """
        B = x.shape[0]
        positions = torch.full((1,), cur_pos, device=x.device)
        q, k, v = self._project_qkv(x, positions)
        slot = cur_pos % cache["k"].shape[1]
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["pos"][slot] = cur_pos
        o = decode_attention(q[:, 0], cache["k"], cache["v"], cache["pos"],
                             cur_pos, window=self.window)
        return self.wo(o.reshape(B, 1, self.cfg.q_dim)), cache
