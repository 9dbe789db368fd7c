"""Plain PyTorch version of the flash attention kernel (model layout).

Same function as ``repro.kernels.flash_attention.ref``: float32 logits and
softmax, masked logits ``-1e30``, output ``w @ v / max(sum, 1e-30)``, cast to
q's dtype. It takes the model layout ``[B, S, H, hd]`` / ``[B, S, K, hd]``
directly, with query head h reading kv head ``h // (H // K)``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k/v: [B, S, K, hd]. Returns [B, S, H, hd]."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.float().reshape(B, S, K, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
