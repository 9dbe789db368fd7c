"""Plain PyTorch version of the chunkwise mLSTM kernel (model layout).

Same function as ``repro.models.xlstm.mlstm_chunkwise``, the oracle of the JAX
package's kernel: the chunk is shrunk to a divisor of S, the stabiliser ``m``
starts at 0, masked log-weights are the finite ``-1e30`` and the denominator is
floored at ``exp(-m_j)``. All arithmetic is float32; h is cast to v's dtype.
Given float64 tensors both functions work in float64: an evaluation to hold
the float32 kernels and formulas against.

``mlstm_chunk_backward_reference`` is the explicit chunkwise backward of
that function, the formulas ``csrc/mlstm_chunk_bwd.cu`` computes. It holds
the stabilisers ``m_j`` and ``m_state`` constant. That is the gradient, not
an approximation: every term of the numerator and of the denominator
carries the factor ``exp(-m_j)`` (``D``, ``dec_q`` and the carried state,
which is stored as ``(C, n) exp(-m)``), so ``h = num_true / max(|den_true|,
1)`` does not depend on m, and the gradient through m cancels term by term
(``stabilisers_constant=True`` on the forward lets autograd show it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def chunk_size(S: int, chunk: int) -> int:
    """The largest divisor of S that is at most ``chunk`` (as the model)."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


class Gates(NamedTuple):
    """One chunk's gate terms, float32 [B,H,c] unless said: the stabiliser
    ``m_j``, ``d_mat = exp(logD - m_j)`` [B,H,c,c], ``dec_q = exp(b + m -
    m_j)``, ``dec_k = exp(btot - b + i - m_state)``, ``decay = exp(btot + m
    - m_state)`` [B,H] and the next chunk's ``m = m_state`` [B,H]."""
    m_j: torch.Tensor
    d_mat: torch.Tensor
    dec_q: torch.Tensor
    dec_k: torch.Tensor
    decay: torch.Tensor
    m_state: torch.Tensor


def chunk_gates(ic: torch.Tensor, fc: torch.Tensor, m: torch.Tensor,
                stabilisers_constant: bool = False) -> Gates:
    """The gate terms of a chunk from its log gates ``ic``, ``fc`` [B,H,c]
    and the carried stabiliser ``m`` [B,H] (``b = cumsum(f)``, ``logD_jl =
    b_j - b_l + i_l`` for l <= j)."""
    c = ic.shape[-1]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=ic.device))
    b = torch.cumsum(fc, dim=-1)
    btot = b[..., -1]
    log_d = b[..., :, None] - b[..., None, :] + ic[..., None, :]
    log_d = torch.where(causal, log_d, torch.full_like(log_d, NEG_INF))
    m_inter = b + m[..., None]
    m_j = torch.maximum(log_d.amax(dim=-1), m_inter)
    g = btot[..., None] - b + ic
    m_state = torch.maximum(btot + m, g.amax(dim=-1))
    if stabilisers_constant:
        m_j, m_state = m_j.detach(), m_state.detach()
    return Gates(m_j, torch.exp(log_d - m_j[..., None]), torch.exp(m_inter - m_j),
                 torch.exp(g - m_state[..., None]), torch.exp(btot + m - m_state), m_state)


def _split(x: torch.Tensor, B: int, T: int, c: int, H: int) -> torch.Tensor:
    """[B,S,H,*] -> [T,B,H,c,*], float32 (float64 stays float64)."""
    tail = tuple(x.shape[3:])
    x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    x = x.reshape((B, T, c, H) + tail)
    return x.permute((1, 0, 3, 2) + tuple(range(4, 4 + len(tail))))


def _join(xs, B: int, S: int, H: int, dtype) -> torch.Tensor:
    """[T] of [B,H,c,*] -> [B,S,H,*] in ``dtype``."""
    x = torch.stack(xs)
    tail = tuple(x.shape[4:])
    x = x.permute((1, 0, 3, 2) + tuple(range(4, 4 + len(tail))))
    return x.reshape((B, S, H) + tail).to(dtype)


def _update(C, n, kc, vc, gates: Gates):
    """The state after a chunk: C' = decay C + (dec_k k)^T v, n' = decay n
    + sum_l dec_k_l k_l."""
    kd = kc * gates.dec_k[..., None]
    return (C * gates.decay[..., None, None] + kd.transpose(-1, -2) @ vc,
            n * gates.decay[..., None] + kd.sum(dim=-2))


def mlstm_chunk_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          i_log: torch.Tensor, f_log: torch.Tensor, *,
                          chunk: int = 256,
                          initial_state: Optional[State] = None,
                          return_state: bool = False,
                          stabilisers_constant: bool = False):
    """q,k: [B,S,H,dqk]; v: [B,S,H,dv]; i_log/f_log: [B,S,H].

    Returns h [B,S,H,dv] in v's dtype and, with ``return_state``, the final
    float32 state ``(C [B,H,dqk,dv], n [B,H,dqk], m [B,H])``.
    ``stabilisers_constant`` detaches ``m_j`` and ``m_state`` from autograd
    (the same values), as the explicit backward holds them.
    """
    B, S, H, dqk = q.shape
    dv = v.shape[-1]
    c = chunk_size(S, chunk)
    T = S // c
    qs, ks, vs, il, fl = (_split(x, B, T, c, H) for x in (q, k, v, i_log, f_log))

    if initial_state is None:
        like = dict(dtype=qs.dtype, device=q.device)
        C = torch.zeros((B, H, dqk, dv), **like)
        n = torch.zeros((B, H, dqk), **like)
        m = torch.zeros((B, H), **like)
    else:
        C, n, m = (t.to(qs.dtype) for t in initial_state)

    hs = []
    for t in range(T):
        qc, kc, vc = qs[t], ks[t], vs[t]
        gates = chunk_gates(il[t], fl[t], m, stabilisers_constant)
        w = (qc @ kc.transpose(-1, -2)) * gates.d_mat
        h_inter = (qc @ C) * gates.dec_q[..., None]
        n_inter = (qc @ n[..., None])[..., 0] * gates.dec_q
        num = w @ vc + h_inter
        den = torch.abs((qc * (w @ kc)).sum(dim=-1) + n_inter)
        hs.append(num / torch.maximum(den, torch.exp(-gates.m_j))[..., None])
        C, n = _update(C, n, kc, vc, gates)
        m = gates.m_state
    h = _join(hs, B, S, H, v.dtype)
    if return_state:
        return h, (C, n, m)
    return h


def _states(ks, vs, il, fl, dv: int):
    """Each chunk's start state (C_t, n_t) from zero and its gate terms."""
    T, B, H, c, dqk = ks.shape
    like = dict(dtype=ks.dtype, device=ks.device)
    C = torch.zeros((B, H, dqk, dv), **like)
    n = torch.zeros((B, H, dqk), **like)
    m = torch.zeros((B, H), **like)
    out = []
    for t in range(T):
        gates = chunk_gates(il[t], fl[t], m)
        out.append((C, n, gates))
        C, n = _update(C, n, ks[t], vs[t], gates)
        m = gates.m_state
    return out


def _denominator(qc, kc, C_n_gates):
    """The signed denominator ``den`` [B,H,c] of a chunk (before |.|) and
    its floor ``exp(-m_j)``."""
    _, n, gates = C_n_gates
    s = qc @ kc.transpose(-1, -2)
    den = (s * s * gates.d_mat).sum(dim=-1) + (qc @ n[..., None])[..., 0] * gates.dec_q
    return s, den, torch.exp(-gates.m_j)


def floor_share(q: torch.Tensor, k: torch.Tensor, i_log: torch.Tensor,
                f_log: torch.Tensor, *, chunk: int = 256) -> float:
    """The share of positions where the denominator's floor ``exp(-m_j)``
    wins over ``|den_j|`` (where ``dh`` sends no gradient to ``den``)."""
    B, S, H, dqk = q.shape
    c = chunk_size(S, chunk)
    T = S // c
    qs, ks, il, fl = (_split(x, B, T, c, H) for x in (q, k, i_log, f_log))
    vs = ks[..., :1]
    wins = 0
    for t, state in enumerate(_states(ks, vs, il, fl, 1)):
        _, den, floor = _denominator(qs[t], ks[t], state)
        wins += int((den.abs() < floor).sum())
    return wins / (B * S * H)


def mlstm_chunk_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   i_log: torch.Tensor, f_log: torch.Tensor,
                                   h: torch.Tensor, dh: torch.Tensor, *,
                                   chunk: int = 256):
    """dq, dk, dv, di, df of ``mlstm_chunk_reference`` (zero initial state,
    no gradient of the final state) from its inputs, its output ``h`` and
    the output's gradient ``dh`` [B,S,H,dv]. The first three in q's, k's
    and v's dtypes, the gates' in float32; all arithmetic float32 (float64
    where every input is float64, the gate gradients then float64 too).

    The float32 chunk-start states ``(C_t, n_t)`` and the stabilisers are
    recomputed forward from zero, then the chunks are walked in reverse
    carrying ``dC`` and ``dn``, the gradients of the state after the chunk.
    Within a chunk, with ``s = q k^T``, ``D = exp(logD - m_j)``, ``N_j =
    max(|den_j|, exp(-m_j))`` and ``dnum_j = dh_j / N_j``:

    * ``dN_j = -sum_e dh_je h_je / N_j`` and ``dden_j = dN_j sign(den_j)``
      where the floor does not win (else 0); ``den_j = sum_l s_jl^2 D_jl +
      dec_q_j q_j . n_t`` (the intra term is quadratic in the scores: the
      model's ``n_intra = (s o D) k``);
    * ``ds = D o (dnum v^T + 2 s dden)``, ``dlogD = D o s o (dnum v^T + s
      dden)``, ``dq = ds k + dec_q (dnum C_t^T + dden n_t)``, ``dk = ds^T q
      + dec_k (v dC^T + dn)``, ``dv = (s o D)^T dnum + dec_k k dC``;
    * the log gates: ``logD_jl = b_j - b_l + i_l``, ``log dec_q_j = b_j +
      m - m_j``, ``log dec_k_l = btot - b_l + i_l - m_state``, ``log decay
      = btot + m - m_state`` with ``b = cumsum(f)``, so ``df`` is the
      reverse cumsum of ``db`` and ``btot`` sends its gradient to every f
      of the chunk.
    """
    B, S, H, dqk = q.shape
    dv = v.shape[-1]
    c = chunk_size(S, chunk)
    T = S // c
    qs, ks, vs, hs, dhs, il, fl = (_split(x, B, T, c, H)
                                   for x in (q, k, v, h, dh, i_log, f_log))
    states = _states(ks, vs, il, fl, dv)
    dC = torch.zeros((B, H, dqk, dv), dtype=qs.dtype, device=q.device)
    dn = torch.zeros((B, H, dqk), dtype=qs.dtype, device=q.device)
    grads = [None] * T
    for t in reversed(range(T)):
        C, n, gates = states[t]
        qc, kc, vc = qs[t], ks[t], vs[t]
        s, den, floor = _denominator(qc, kc, states[t])
        N = torch.maximum(den.abs(), floor)
        dnum = dhs[t] / N[..., None]
        dN = -(dhs[t] * hs[t]).sum(dim=-1) / N
        dden = torch.where(den.abs() >= floor, dN * torch.sign(den), torch.zeros_like(dN))
        dp = dnum @ vc.transpose(-1, -2)                          # [B,H,c,c]
        ds = gates.d_mat * (dp + 2.0 * s * dden[..., None])
        dlog_d = gates.d_mat * s * (dp + s * dden[..., None])
        inter = dnum @ C.transpose(-1, -2) + dden[..., None] * n[..., None, :]
        r = vc @ dC.transpose(-1, -2) + dn[..., None, :]          # [B,H,c,dqk]
        dg = gates.dec_k * (kc * r).sum(dim=-1)
        db = (dlog_d.sum(dim=-1) - dlog_d.sum(dim=-2) - dg
              + gates.dec_q * (qc * inter).sum(dim=-1))
        db[..., -1] += dg.sum(dim=-1) + gates.decay * (
            (C * dC).sum(dim=(-2, -1)) + (n * dn).sum(dim=-1))
        grads[t] = (ds @ kc + gates.dec_q[..., None] * inter,
                    ds.transpose(-1, -2) @ qc + gates.dec_k[..., None] * r,
                    (s * gates.d_mat).transpose(-1, -2) @ dnum
                    + gates.dec_k[..., None] * (kc @ dC),
                    dlog_d.sum(dim=-2) + dg,
                    torch.flip(torch.cumsum(torch.flip(db, (-1,)), dim=-1), (-1,)))
        dC = gates.decay[..., None, None] * dC + (
            qc * gates.dec_q[..., None]).transpose(-1, -2) @ dnum
        dn = gates.decay[..., None] * dn + (qc * (gates.dec_q * dden)[..., None]).sum(dim=-2)
    dq, dk, dvs, di, df = zip(*grads)
    return (_join(dq, B, S, H, q.dtype), _join(dk, B, S, H, k.dtype),
            _join(dvs, B, S, H, v.dtype), _join(di, B, S, H, il.dtype),
            _join(df, B, S, H, fl.dtype))
