"""Causal self-attention with GQA and a KV cache (counterpart of
``repro.models.attention``).

Prefill attention goes through the port's ``flash_attention`` and decode
attention through its ``decode_attention``: on the card each is a CUDA
kernel, on the CPU its plain version. The cache layout is the JAX package's:
``k``/``v`` ``[B, L, K, hd]``, ``pos [L]`` int32 with -1 for an empty slot,
position p in slot ``p % L`` (a ring buffer for sliding-window layers).
With ``cfg.qk_norm`` each head's q and k go through an RMSNorm over
``head_dim`` (``q_norm``, ``k_norm``) after the projections and before rope,
in every mode.

Under tensor parallelism (train mode) a rank computes its block of the
heads: ``wq`` cut on a head boundary gives it H / model query heads, ``wk``
and ``wv`` cut on one K / model kv heads. A ``wk``/``wv`` cut inside a head
(``param_specs`` cuts by size, not by heads: reduced qwen2-7b's 2 kv heads
of 16 over 4 ranks) is all-gathered over the model group, and the rank
takes the kv heads its query heads read. QK-norm and rope act on the local
heads, and the flash kernel gets the local head counts; the row-parallel
``wo`` all-reduces the heads' partial sums. Where ``wq`` is cut off a head
boundary the rank gathers every head and computes them all.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import Dense, RMSNorm, apply_rope
from repro_torch.sharding.partitioning import NONE

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
    mp = NONE

    def __init__(self, cfg: ModelConfig, *, window: int, theta: float,
                 dtype, device):
        super().__init__()
        d = cfg.d_model
        self.cfg, self.window, self.theta = cfg, window, theta
        self.wq = Dense(d, cfg.q_dim, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wk = Dense(d, cfg.kv_dim, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wv = Dense(d, cfg.kv_dim, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.wo = Dense(cfg.q_dim, d, dtype=dtype, device=device)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, device=device)
            self.k_norm = RMSNorm(cfg.head_dim, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for dense in (self.wq, self.wk, self.wv, self.wo):
            dense.reset_parameters(generator)
        if self.q_norm is not None:
            self.q_norm.reset_parameters()
            self.k_norm.reset_parameters()

    def _project_qkv(self, x, positions):
        """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,K,hd]: QK-norm (if any), then
        rope. On a rank of a model group, q holds this rank's heads (all of
        them where ``wq`` is not cut on a head boundary) and k/v the heads
        they read, the QK-norm scales entering the cut; with ``NONE`` every
        collective below is the identity."""
        cfg, mp = self.cfg, self.mp
        B, S, _ = x.shape
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.wq(x)
        local = self.wq.column and H % mp.size == 0
        if self.wq.column and not local:
            q = mp.gather(q, -1)
        hq = q.shape[-1] // hd
        q = q.reshape(B, S, hq, hd)
        k, v = self.wk(x), self.wv(x)
        if self.wk.column and not (local and K % mp.size == 0):
            k, v = mp.gather(k, -1), mp.gather(v, -1)
        if local and k.shape[-1] == cfg.kv_dim:
            # every kv head, replicated: keep those this rank's heads read
            k, v = mp.enter(k), mp.enter(v)
            G, h0 = H // K, mp.rank * hq
            if hq % G == 0 or G % hq == 0:
                idx = torch.arange(h0 // G, h0 // G + max(1, hq // G), device=x.device)
            else:
                idx = (h0 + torch.arange(hq, device=x.device)) // G
            k = k.reshape(B, S, K, hd).index_select(2, idx)
            v = v.reshape(B, S, K, hd).index_select(2, idx)
        k = k.reshape(B, S, -1, hd)
        v = v.reshape(B, S, -1, hd)
        if self.q_norm is not None:
            enter = mp.enter if local else (lambda t: t)
            q = self.q_norm(q, enter(self.q_norm.scale))
            k = self.k_norm(k, enter(self.k_norm.scale))
        return (apply_rope(q, positions, self.theta),
                apply_rope(k, positions, self.theta), v)

    def forward(self, x: torch.Tensor, seq_cut: bool = False) -> torch.Tensor:
        """Train mode (``attention_forward``): causal (windowed for a local
        layer) attention over the whole sequence, x [B,S,D] -> [B,S,D]
        (this rank's block of the sequence where ``seq_cut``)."""
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        q, k, v = self._project_qkv(x, positions)
        out = flash_attention(q, k, v, causal=True, window=self.window)
        return self.wo(out.reshape(B, S, -1), seq_cut)

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
