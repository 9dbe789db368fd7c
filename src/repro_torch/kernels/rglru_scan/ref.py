"""Plain PyTorch versions of the RG-LRU scan kernels.

The function's definition, step by step: ``h_t = a_t * h_{t-1} + b_t`` over
the sequence axis from ``h0``, with a float32 carry, output in b's dtype.
``repro.kernels.rglru_scan.ref`` computes the same recurrence as an
associative scan; the tests hold the two against each other. The backward
is the reverse recurrence the backward kernel computes, written out (no
autograd).
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


def rglru_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    """The same function by the CUDA kernel's algorithm, for the tests: S is
    cut into chunks of ``chunk`` steps (the last may be shorter); each chunk
    folds into the affine map h -> A h + H (A the product of its a_t, H its
    h at the end from 0); the carries compose from h0 in chunk order; each
    chunk is re-run from its carry. float32 throughout, output in b's dtype."""
    af, bf = a.float(), b.float()
    S = b.shape[1]
    starts = range(0, S, chunk)
    maps = []
    for s in starts:                      # pass 1: each chunk on its own
        A, H = torch.ones_like(af[:, 0]), torch.zeros_like(bf[:, 0])
        for t in range(s, min(s + chunk, S)):
            A, H = A * af[:, t], af[:, t] * H + bf[:, t]
        maps.append((A, H))
    carries, h = [], h0.float()
    for A, H in maps:                     # the carry into each chunk, in order
        carries.append(h)
        h = A * h + H
    out = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    for s, h in zip(starts, carries):     # pass 2: each chunk from its carry
        for t in range(s, min(s + chunk, S)):
            h = af[:, t] * h + bf[:, t]
            out[:, t] = h
    return out.to(b.dtype)


def rglru_scan_backward_reference(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                                  dh: torch.Tensor):
    """Gradients of ``h = scan(a, b, h0)`` from the forward's h and the
    gradient dh [B, S, W]: with a_S = 0, g_t = dh_t + a_{t+1} g_{t+1},
    db_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0), dh0 = a_0 g_0. Returns
    float32 (da, db, dh0)."""
    af, hf, dhf = a.float(), h.float(), dh.float()
    S = a.shape[1]
    da = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    g = torch.zeros_like(h0, dtype=torch.float32)
    for t in reversed(range(S)):
        g = dhf[:, t] + (af[:, t + 1] * g if t + 1 < S else 0.0)
        db[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else h0.float())
    return da, db, af[:, 0] * g
