"""Plain PyTorch versions of the flash attention kernels (model layout).

Forward: the same function as ``repro.kernels.flash_attention.ref``: float32
logits and softmax, masked logits ``-1e30``, output ``w @ v / max(sum,
1e-30)``, cast to q's dtype. It takes the model layout ``[B, S, H, hd]`` /
``[B, S, K, hd]`` directly, with query head h reading kv head ``h // (H //
K)``. With ``return_lse`` it also returns each row's float32 log-sum-exp of
the scaled logits, ``[B, H, S]``, which the backward recomputes P from.

Backward: the explicit formulas the CUDA backward kernels implement (no
autograd): P = exp(s - lse) on the visible keys, delta = rowsum(dO ∘ O),
dV = Pᵀ dO, dS = P ∘ (dO Vᵀ - delta), dQ = dS K · scale, dK = dSᵀ Q · scale,
the G query heads of a group summed into their kv head.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(S: int, causal: bool, window: int, device) -> torch.Tensor:
    """[S, S] bool, query rows by key columns: the keys each query sees."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return mask


def _scores(q, k, causal, window):
    """Masked, scaled float32 logits [B, K, G, S, S]."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    return torch.where(_mask(S, causal, window, q.device), s, torch.full_like(s, NEG_INF))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, return_lse: bool = False):
    """q: [B, S, H, hd]; k/v: [B, S, K, hd]. Returns [B, S, H, hd] and, with
    ``return_lse``, the float32 log-sum-exp ``[B, H, S]``."""
    B, S, H, hd = q.shape
    s = _scores(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    w = torch.exp(s - m)
    total = w.sum(dim=-1, keepdim=True)
    w = w / total.clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    out = out.reshape(B, S, H, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(total))[..., 0].reshape(B, H, S)
    return out, lse


def flash_attention_backward_reference(q, k, v, o, do, lse, *, causal: bool = True,
                                       window: int = 0):
    """Gradients of the forward above from its output ``o``, the output's
    gradient ``do`` [B, S, H, hd] and ``lse`` [B, H, S]. Returns (dq, dk, dv)
    in the inputs' dtypes; float32 throughout."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    mask = _mask(S, causal, window, q.device)
    s = _scores(q, k, causal, window)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, S, 1)), torch.zeros_like(s))
    dog = do.float().reshape(B, S, K, G, hd)
    delta = (dog * o.float().reshape(B, S, K, G, hd)).sum(-1)            # [B,S,K,G]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(B, S, K, G, hd)) * scale
    return dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
