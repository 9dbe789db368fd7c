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


def rglru_scan_backward_chunked(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                                dh: torch.Tensor, plan):
    """The backward by the CUDA kernel's algorithm, for the tests: the
    reverse recurrence as a forward one in reversed time u = S - 1 - t
    (a'_u = a_{S-u}, 0 at u = 0; b'_u = dh_{S-1-u}), cut as ``plan``
    (clusters, chunk, rounds, ...) says: round r's chunk c covers u from
    (r clusters + c) chunk. Each chunk folds four quarters into affine maps
    g -> A g + G and composes them in order; within a round the chunks'
    carries compose from the round's carry (0 in the first) in chunk order,
    and each quarter is re-run from its carry (the chunk's, then its earlier
    quarters'). Then db_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0) and
    dh0 = a_0 g_0. float32 throughout; returns (da, db, dh0)."""
    clusters, chunk, rounds = plan[:3]
    af, hf, dhf = a.float(), h.float(), dh.float()
    B, S, W = af.shape
    ar = torch.cat([torch.zeros_like(af[:, :1]), af.flip(1)[:, :-1]], dim=1)   # a'_u
    br = dhf.flip(1)                                                            # b'_u
    quarter = -(-chunk // 4)
    gr = torch.empty_like(af)                                                   # g'_u
    g = torch.zeros_like(af[:, 0])
    for r in range(rounds):
        spans, maps = [], []
        for c in range(clusters):                   # pass 1: each chunk's quarters
            u0 = (r * clusters + c) * chunk
            rows = max(0, min(chunk, S - u0))
            quarters = []
            for q in range(4):
                s0 = min(rows, q * quarter)
                s1 = min(rows, s0 + quarter)
                A, G = torch.ones_like(g), torch.zeros_like(g)
                for u in range(u0 + s0, u0 + s1):
                    A, G = A * ar[:, u], ar[:, u] * G + br[:, u]
                quarters.append((u0 + s0, u0 + s1, A, G))
            A, G = torch.ones_like(g), torch.zeros_like(g)
            for _, _, qa, qg in quarters:
                A, G = A * qa, qa * G + qg
            spans.append(quarters)
            maps.append((A, G))
        carries = []
        for A, G in maps:                           # carry-in, in chunk order
            carries.append(g)
            g = A * g + G
        for quarters, carry in zip(spans, carries):     # pass 2
            for q, (s0, s1, _, _) in enumerate(quarters):
                gc = carry
                for _, _, qa, qg in quarters[:q]:
                    gc = qa * gc + qg
                for u in range(s0, s1):
                    gc = ar[:, u] * gc + br[:, u]
                    gr[:, u] = gc
    gt = gr.flip(1)                                  # g_t
    hprev = torch.cat([h0.float()[:, None], hf[:, :-1]], dim=1)
    return gt * hprev, gt, af[:, 0] * gt[:, 0]
