"""Plain PyTorch version of the RG-LRU scan kernel.

The function's definition, step by step: ``h_t = a_t * h_{t-1} + b_t`` over
the sequence axis from ``h0``, with a float32 carry, output in b's dtype.
``repro.kernels.rglru_scan.ref`` computes the same recurrence as an
associative scan; the tests hold the two against each other.
"""
from __future__ import annotations

import torch


def rglru_scan_reference(a: torch.Tensor, b: torch.Tensor,
                         h0: torch.Tensor) -> torch.Tensor:
    """a, b: [B, S, W]; h0: [B, W]. Returns h: [B, S, W] in b's dtype."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    for t in range(b.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(b.dtype)
