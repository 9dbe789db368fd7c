"""Basic building blocks: dense, norms, RoPE, embedding (and the tied
unembedding), gated MLP, logit softcap.

Counterpart of ``repro.models.layers``. Dense kernels keep the JAX package's
``[in, out]`` orientation (``y = x @ kernel + bias``), so converted weights
are copied as they are, with no transpose.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.kernel = _empty((in_dim, out_dim), dtype, device)
        self.bias = _empty((out_dim,), dtype, device) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal · 1/√in kernel drawn in float32, zero bias (as JAX)."""
        w = torch.randn(self.kernel.shape, generator=generator,
                        dtype=torch.float32, device=self.kernel.device)
        self.kernel.copy_(w.mul_(1.0 / math.sqrt(self.kernel.shape[0])))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class RMSNorm(nn.Module):
    """Gemma-style ``(1 + scale)`` RMSNorm, eps 1e-6, computed in float32."""

    def __init__(self, dim: int, *, eps: float = 1e-6, device=None):
        super().__init__()
        self.scale = _empty((dim,), torch.float32, device)
        self.eps = eps

    def reset_parameters(self) -> None:
        self.scale.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps) * (1.0 + self.scale)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with ``scale`` and ``bias``, eps 1e-6, biased variance,
    computed in float32 (``repro.models.layers.apply_norm``)."""

    def __init__(self, dim: int, *, eps: float = 1e-6, device=None):
        super().__init__()
        self.scale = _empty((dim,), torch.float32, device)
        self.bias = _empty((dim,), torch.float32, device)
        self.eps = eps

    def reset_parameters(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


def make_norm(kind: str, dim: int, *, device=None) -> nn.Module:
    """``cfg.norm``: ``rmsnorm`` or ``layernorm``."""
    if kind == "rmsnorm":
        return RMSNorm(dim, device=device)
    if kind == "layernorm":
        return LayerNorm(dim, device=device)
    raise ValueError(kind)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, heads, hd]; positions: [..., S]. Split halves, in float32."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs       # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


class MLP(nn.Module):
    """Gated MLP: ``wo(act(wi_gate x) * wi_up x)``."""

    def __init__(self, d_model: int, d_ff: int, act: str, *, dtype, device):
        super().__init__()
        self.wi_gate = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.wi_up = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.wo = Dense(d_ff, d_model, dtype=dtype, device=device)
        self.act = activation(act)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for d in (self.wi_gate, self.wi_up, self.wo):
            d.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.act(self.wi_gate(x)) * self.wi_up(x))


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, dtype, device):
        super().__init__()
        self.table = _empty((vocab, dim), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal · 0.02, drawn in float32 (as JAX)."""
        w = torch.randn(self.table.shape, generator=generator,
                        dtype=torch.float32, device=self.table.device)
        self.table.copy_(w.mul_(0.02))

    def forward(self, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
        return self.table[tokens].to(compute_dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits against the table (tied head): ``x @ table.T`` in x's dtype."""
        return x @ self.table.to(x.dtype).T


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``tanh(x / cap) * cap``; no cap when ``cap`` is 0."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
