"""Plain PyTorch version of the chunkwise mLSTM kernel (model layout).

Same function as ``repro.models.xlstm.mlstm_chunkwise``, the oracle of the JAX
package's kernel: the chunk is shrunk to a divisor of S, the stabiliser ``m``
starts at 0, masked log-weights are the finite ``-1e30`` and the denominator is
floored at ``exp(-m_j)``. All arithmetic is float32; h is cast to v's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def chunk_size(S: int, chunk: int) -> int:
    """The largest divisor of S that is at most ``chunk`` (as the model)."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def mlstm_chunk_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          i_log: torch.Tensor, f_log: torch.Tensor, *,
                          chunk: int = 256,
                          initial_state: Optional[State] = None,
                          return_state: bool = False):
    """q,k: [B,S,H,dqk]; v: [B,S,H,dv]; i_log/f_log: [B,S,H].

    Returns h [B,S,H,dv] in v's dtype and, with ``return_state``, the final
    float32 state ``(C [B,H,dqk,dv], n [B,H,dqk], m [B,H])``.
    """
    B, S, H, dqk = q.shape
    dv = v.shape[-1]
    c = chunk_size(S, chunk)
    T = S // c
    dev = q.device

    def split(x, tail):          # [B,S,H,*] -> [T,B,H,c,*]
        x = x.float().reshape((B, T, c, H) + tail)
        return x.permute((1, 0, 3, 2) + tuple(range(4, 4 + len(tail))))

    qs, ks, vs = split(q, (dqk,)), split(k, (dqk,)), split(v, (dv,))
    il, fl = split(i_log, ()), split(f_log, ())

    if initial_state is None:
        C = torch.zeros((B, H, dqk, dv), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, dqk), dtype=torch.float32, device=dev)
        m = torch.zeros((B, H), dtype=torch.float32, device=dev)
    else:
        C, n, m = (t.float() for t in initial_state)

    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    hs = []
    for t in range(T):
        qc, kc, vc, ic, fc = qs[t], ks[t], vs[t], il[t], fl[t]
        b = torch.cumsum(fc, dim=-1)                              # [B,H,c]
        btot = b[..., -1:]
        log_d = b[..., :, None] - b[..., None, :] + ic[..., None, :]
        log_d = torch.where(causal, log_d, torch.full_like(log_d, NEG_INF))
        m_intra = log_d.amax(dim=-1)
        m_inter = b + m[..., None]
        m_j = torch.maximum(m_intra, m_inter)
        d_mat = torch.exp(log_d - m_j[..., None])
        scores = qc @ kc.transpose(-1, -2)
        w = scores * d_mat
        h_intra = w @ vc
        n_intra = w @ kc
        dec_q = torch.exp(m_inter - m_j)
        h_inter = (qc @ C) * dec_q[..., None]
        n_inter = (qc @ n[..., None])[..., 0] * dec_q
        num = h_intra + h_inter
        den = torch.abs((qc * n_intra).sum(dim=-1) + n_inter)
        hs.append(num / torch.maximum(den, torch.exp(-m_j))[..., None])
        # ---- state update ----
        g = btot - b + ic
        m_state = torch.maximum(btot[..., 0] + m, g.amax(dim=-1))
        dec_k = torch.exp(g - m_state[..., None])
        decay = torch.exp(btot[..., 0] + m - m_state)
        kd = kc * dec_k[..., None]
        C = C * decay[..., None, None] + kd.transpose(-1, -2) @ vc
        n = n * decay[..., None] + kd.sum(dim=-2)
        m = m_state
    h = torch.stack(hs)                                       # [T,B,H,c,dv]
    h = h.permute(1, 0, 3, 2, 4).reshape(B, S, H, dv).to(v.dtype)
    if return_state:
        return h, (C, n, m)
    return h
