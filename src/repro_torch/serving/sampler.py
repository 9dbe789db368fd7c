"""Token samplers: greedy, temperature, top-k, nucleus (top-p) over logits
(counterpart of ``repro.serving.sampler``).

JAX draws a token with ``jax.random.categorical``, which is
``argmax(logits + Gumbel noise)``. The port splits that in two:
``filter_logits`` applies temperature, top-k and top-p exactly as the JAX
``sample`` does, and ``sample`` adds Gumbel noise drawn from an explicit
``torch.Generator`` (or given) and takes the argmax. With JAX's noise
(``jax.random.gumbel(key, logits.shape)``) it draws JAX's tokens.

As in the JAX package, nothing calls the sampler: the serving ``Replica``
decodes greedily.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    greedy: bool = False


def filter_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """float32 logits [..., V] after temperature, top-k and top-p (the
    tokens cut are ``-inf``), as ``repro.serving.sampler.sample`` forms them
    before drawing. The temperature divides by a 0-dim tensor on the logits'
    device, so the card divides as the CPU does (a Python scalar would be a
    product with its reciprocal there)."""
    logits = logits.float()
    neg_inf = torch.tensor(-torch.inf, device=logits.device)
    if cfg.temperature != 1.0:
        logits = logits / torch.tensor(max(cfg.temperature, 1e-6), dtype=torch.float32,
                                       device=logits.device)
    if cfg.top_k and cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -cfg.top_k][..., None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p
        keep = cum - probs < cfg.top_p
        # JAX takes the largest kept logit as the cutoff (the top logit), so
        # only the top logit and its ties survive; the port keeps that
        cutoff = torch.where(keep, sorted_logits, neg_inf).max(dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise, float32, ``-log(-log(u))`` for u uniform in
    (0, 1), drawn from ``generator`` on ``device``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplerConfig, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [..., V] -> token ids [...]: the argmax for ``greedy``, else
    the argmax of ``filter_logits(logits) + noise``, ``noise`` drawn by
    ``gumbel`` from ``generator`` unless given."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, cfg)
    if noise is None:
        noise = gumbel(logits.shape, generator, logits.device)
    return torch.argmax(noise + logits, dim=-1)
