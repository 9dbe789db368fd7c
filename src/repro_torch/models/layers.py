"""Basic building blocks: dense, norms, RoPE, embedding (and the tied
unembedding), gated MLP, logit softcap.

Counterpart of ``repro.models.layers``. Dense kernels keep the JAX package's
``[in, out]`` orientation (``y = x @ kernel + bias``), so converted weights
are copied as they are, with no transpose.

Tensor parallelism: a model built for a rank of a model group
(``models.model.CausalLM(..., mp=...)``) holds each leaf cut as its
``param_specs`` says, and every layer reads its cut from its own shapes. A
``Dense`` whose kernel is cut on its output dim is column-parallel: its
replicated input enters the cut computation (``ModelParallel.enter``:
identity forward, all-reduce of the input's gradient) and it gives this
rank's block of the output. One cut on its input dim is row-parallel: it
takes this rank's block of its input (cutting a whole input with
``split``), and its partial sums are all-reduced (``reduce``: identity
backward), or reduce-scattered over the sequence where the residual stream
is cut on it. ``Embedding`` is vocab-parallel where its table is cut on
the vocabulary: an id outside the rank's rows gives 0, then an all-reduce;
``unembed`` then gives the rank's block of the vocabulary's logits. With no
model group (``partitioning.NONE``) every layer is the plain one and no
collective is issued.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.partitioning import NONE


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    mp = NONE           # the model's ModelParallel (set by CausalLM)

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.kernel = _empty((in_dim, out_dim), dtype, device)
        self.bias = _empty((out_dim,), dtype, device) if bias else None

    @property
    def column(self) -> bool:
        """Cut on its output dim over the model group."""
        return self.kernel.shape[1] < self.out_dim

    @property
    def row(self) -> bool:
        """Cut on its input dim over the model group."""
        return self.kernel.shape[0] < self.in_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal · 1/√in kernel drawn in float32, zero bias (as JAX)."""
        w = torch.randn(self.kernel.shape, generator=generator,
                        dtype=torch.float32, device=self.kernel.device)
        self.kernel.copy_(w.mul_(1.0 / math.sqrt(self.kernel.shape[0])))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, seq_cut: bool = False) -> torch.Tensor:
        """x [..., in] (a row-parallel layer also takes its block [...,
        in / model]) -> [..., out], or this rank's block of it where the
        layer is column-parallel. ``seq_cut``: the output goes into a
        residual stream cut on dim 1 (sequence parallelism), so it comes
        out as this rank's block of the sequence."""
        mp = self.mp
        if self.column:
            x = mp.enter(x)
        elif self.row and x.shape[-1] == self.in_dim:
            x = mp.split(x, -1)
        y = x @ self.kernel.to(x.dtype)
        if self.row:
            y = mp.reduce_scatter(y, 1) if seq_cut else mp.reduce(y)
        elif seq_cut:
            y = mp.split(y, 1)
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

    def forward(self, x: torch.Tensor, scale: torch.Tensor = None) -> torch.Tensor:
        """``scale``: the scale to use in place of ``self.scale`` (the same
        leaf after ``ModelParallel.enter``, where it acts on a cut)."""
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        scale = self.scale if scale is None else scale
        y = xf * torch.rsqrt(var + self.eps) * (1.0 + scale)
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

    def forward(self, x: torch.Tensor, seq_cut: bool = False) -> torch.Tensor:
        """Column-parallel ``wi_gate``/``wi_up`` and row-parallel ``wo``
        where the ffn dim is cut (``seq_cut``: ``Dense.forward``'s)."""
        return self.wo(self.act(self.wi_gate(x)) * self.wi_up(x), seq_cut)


class Embedding(nn.Module):
    mp = NONE

    def __init__(self, vocab: int, dim: int, *, dtype, device):
        super().__init__()
        self.vocab = vocab
        self.table = _empty((vocab, dim), dtype, device)

    @property
    def cut(self) -> bool:
        """The table's rows are cut over the model group."""
        return self.table.shape[0] < self.vocab

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal · 0.02, drawn in float32 (as JAX)."""
        w = torch.randn(self.table.shape, generator=generator,
                        dtype=torch.float32, device=self.table.device)
        self.table.copy_(w.mul_(0.02))

    def forward(self, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
        if not self.cut:
            return self.table[tokens].to(compute_dtype)
        n = self.table.shape[0]
        local = tokens - self.mp.rank * n
        inside = (local >= 0) & (local < n)
        x = self.table[local.clamp(0, n - 1)].to(compute_dtype)
        return self.mp.reduce(x * inside[..., None].to(compute_dtype))

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits against the table (tied head): ``x @ table.T`` in x's dtype
        (this rank's vocabulary block where the table is cut)."""
        if self.cut:
            x = self.mp.enter(x)
        return x @ self.table.to(x.dtype).T


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``tanh(x / cap) * cap``; no cap when ``cap`` is 0."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
