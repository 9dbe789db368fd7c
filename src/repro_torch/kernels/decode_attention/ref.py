"""Plain PyTorch version of the decode attention kernel (cache layout).

Same function as ``repro.kernels.decode_attention.ref``: one query token per
batch row against an L-slot cache ``[B, L, K, hd]``. A slot is valid if
``slot_pos >= 0``, ``slot_pos <= cur_pos`` and, with a window,
``slot_pos > cur_pos - window``. float32 softmax, output cast to q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_reference(q: torch.Tensor, cache_k: torch.Tensor,
                               cache_v: torch.Tensor, slot_pos: torch.Tensor,
                               cur_pos: int, *, window: int = 0) -> torch.Tensor:
    """q: [B, H, hd]; cache_k/v: [B, L, K, hd]; slot_pos: [L]. Returns [B, H, hd]."""
    B, H, hd = q.shape
    K = cache_k.shape[2]
    G = H // K
    qg = q.float().reshape(B, K, G, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, cache_k.float()) / math.sqrt(hd)
    sp = slot_pos.to(q.device)
    valid = (sp >= 0) & (sp <= cur_pos)
    if window > 0:
        valid &= sp > cur_pos - window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgl,blkd->bkgd", w, cache_v.float())
    return out.reshape(B, H, hd).to(q.dtype)
