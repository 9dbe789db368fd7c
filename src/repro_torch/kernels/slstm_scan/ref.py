"""Plain PyTorch version of the sLSTM recurrence kernel (model layout).

Same function as the JAX package's ``lax.scan`` of ``_slstm_cell``
(``repro.models.xlstm.slstm_block_forward``): per head, the block-diagonal
recurrent products of h_{t-1} with ``rec`` [4, H, dh, dh] (gates z, i, f, o),
exponential gating with the stabiliser m, the normaliser n floored at 1e-6.
The per-head input and forget gates are means over the dh columns. All
arithmetic is float32 (float64 tensors give a float64 evaluation).

``slstm_scan_backward_reference`` is the explicit reverse-time backward of
that function, the formulas ``csrc/slstm_scan.cu``'s backward kernel
computes. Both arms of ``m_new = max(f_log + m, i_log)`` carry the gradient,
half to each at a tie, and so does the floor ``max(n, 1e-6)``, as ``jax.vjp``
differentiates ``jnp.maximum``. The recurrent term of dh_{t-1} takes the z
and o gates' products in full and the i and f gates' as their row sums of
``rec`` times the per-head scalar (their dpre is the same in every column).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]
FLOOR = 1e-6                       # the normaliser's floor


class Saved(NamedTuple):
    """What the forward keeps for the backward: c, n, z = tanh(pre_z), o =
    sigmoid(pre_o) [B, S, H, dh] and, per (row, step, head), i_log, the
    forget gate's mean pre-activation f_raw and the stabiliser m, stacked
    as [B, S, H, 3]."""
    c: torch.Tensor
    n: torch.Tensor
    z: torch.Tensor
    o: torch.Tensor
    gates: torch.Tensor


def recurrent_weights(rec: torch.Tensor) -> torch.Tensor:
    """rec [4,H,dh,dh] laid out once per sequence as [H, dh, 4·dh], the
    operand of each step's product. ``einsum("bhd,ghde->gbhe")`` makes this
    copy at every step, and autograd keeps each one: 16 MB a step at
    xlstm-1.3b's widths, 34 GB over a 2048-token training sequence."""
    g, H, dh, _ = rec.shape
    return rec.permute(1, 2, 0, 3).reshape(H, dh, g * dh)


def slstm_cell(rec_t: torch.Tensor, xz, xi, xf, xo, state: State):
    """One step: the new state and the step's (z, o, i_log, f_raw). x*:
    [B,H,dh] float32 input projections; rec_t ``recurrent_weights(rec)``
    [H, dh, 4·dh]."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    B, H, dh = h.shape
    # einsum("bhd,ghde->gbhe", h, rec) as the einsum computes it: one bmm
    r = torch.bmm(h.transpose(0, 1), rec_t).view(H, B, 4, dh).permute(2, 1, 0, 3)
    z = torch.tanh(xz + r[0])
    i_log = (xi + r[1]).mean(dim=-1)                      # per-head scalar gates
    f_raw = (xf + r[2]).mean(dim=-1)
    f_log = F.logsigmoid(f_raw)
    o = torch.sigmoid(xo + r[3])
    m_new = torch.maximum(f_log + m, i_log)
    ibar = torch.exp(i_log - m_new)[..., None]
    fbar = torch.exp(f_log + m - m_new)[..., None]
    c_new = fbar * c + ibar * z
    n_new = fbar * n + ibar
    h_new = o * c_new / n_new.clamp_min(FLOOR)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}, (z, o, i_log, f_raw)


def slstm_scan_reference(xz: torch.Tensor, xi: torch.Tensor, xf: torch.Tensor,
                         xo: torch.Tensor, rec: torch.Tensor, state: State, *,
                         with_saved: bool = False):
    """The recurrence step by step over S from ``state`` (the ``h, c, n, m``
    cache of ``init_slstm_cache``). x*: [B,S,H,dh]; rec [4,H,dh,dh].
    Returns h [B,S,H,dh] and the final state; with ``with_saved`` also the
    ``Saved`` values of every step."""
    rec_t = recurrent_weights(rec)
    hs, keep = [], []
    for s in range(xz.shape[1]):
        state, gates = slstm_cell(rec_t, xz[:, s], xi[:, s], xf[:, s], xo[:, s], state)
        hs.append(state["h"])
        if with_saved:
            keep.append((state["c"], state["n"], *gates, state["m"]))
    h = torch.stack(hs, dim=1)
    if not with_saved:
        return h, state
    c, n, z, o, i_log, f_raw, m = (torch.stack(v, dim=1) for v in zip(*keep))
    return h, state, Saved(c, n, z, o, torch.stack((i_log, f_raw, m), dim=-1))


def recurrent_grad(h0: torch.Tensor, h: torch.Tensor, dpre) -> torch.Tensor:
    """drec [4,H,dh,dh] = Σ_{b,t} h_{t-1}^T dpre_{g,t} as one product, from
    the initial h0 [B,H,dh], h [B,S,H,dh] and the four gates' dpre
    [B,S,H,dh] (dxz, dxi, dxf, dxo)."""
    B, S, H, dh = h.shape
    h_prev = torch.cat((h0[:, None], h[:, :-1]), dim=1)
    lhs = h_prev.permute(2, 3, 0, 1).reshape(H, dh, B * S)
    rhs = torch.stack(dpre).permute(0, 3, 1, 2, 4).reshape(4, H, B * S, dh)
    return torch.matmul(lhs, rhs)


def _half_where(a: torch.Tensor, b) -> torch.Tensor:
    """The share of max(a, b)'s gradient that goes to a: 1, 0, or half at a
    tie."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0)).to(a.dtype)


def slstm_scan_backward_reference(rec: torch.Tensor, state: State, h: torch.Tensor,
                                  saved: Saved, dh: torch.Tensor):
    """dxz, dxi, dxf, dxo [B,S,H,dh] and drec [4,H,dh,dh] of
    ``slstm_scan_reference`` from ``rec``, the initial ``state``, its output
    h, its ``Saved`` values and the gradient dh of h. The final state takes
    no gradient."""
    B, S, H, D = h.shape
    c_all, n_all, z_all, o_all, gates = saved
    w_zo = torch.cat((rec[0], rec[3]), dim=-1).transpose(1, 2)   # [H, 2D, D]
    rsum_i, rsum_f = rec[1].sum(dim=-1), rec[2].sum(dim=-1)      # [H, D]
    dc = torch.zeros_like(state["c"])
    dn = torch.zeros_like(state["n"])
    dm = torch.zeros_like(state["m"])
    dh_rec = torch.zeros_like(state["h"])
    dx = [torch.empty_like(h) for _ in range(4)]
    for t in reversed(range(S)):
        if t:
            c_prev, n_prev, m_prev = c_all[:, t - 1], n_all[:, t - 1], gates[:, t - 1, :, 2]
        else:
            c_prev, n_prev, m_prev = state["c"], state["n"], state["m"]
        c, n, z, o = c_all[:, t], n_all[:, t], z_all[:, t], o_all[:, t]
        i_log, f_raw, m = gates[:, t].unbind(-1)
        f_log = F.logsigmoid(f_raw)
        ib = torch.exp(i_log - m)[..., None]
        fb = torch.exp(f_log + m_prev - m)[..., None]
        g = dh[:, t] + dh_rec
        nd = n.clamp_min(FLOOR)
        do = g * c / nd
        dct = dc + g * o / nd
        dnt = dn + -g * o * c / (nd * nd) * _half_where(n, FLOOR)
        dpz = dct * ib * (1 - z * z)
        dpo = do * o * (1 - o)
        dib = (dct * z + dnt).sum(dim=-1)                        # [B, H]
        dfb = (dct * c_prev + dnt * n_prev).sum(dim=-1)
        dc, dn = dct * fb, dnt * fb
        d_i, d_f = dib * ib[..., 0], dfb * fb[..., 0]
        dm_new = dm - d_i - d_f
        w = _half_where(f_log + m_prev, i_log)                   # the f_log + m arm's share
        dil = d_i + dm_new * (1 - w)
        dfl = d_f + dm_new * w
        dm = d_f + dm_new * w
        dpi = (dil / D)[..., None]
        dpf = (dfl * torch.sigmoid(-f_raw) / D)[..., None]
        dx[0][:, t], dx[3][:, t] = dpz, dpo
        dx[1][:, t], dx[2][:, t] = dpi.expand_as(dpz), dpf.expand_as(dpz)
        zo = torch.cat((dpz, dpo), dim=-1).transpose(0, 1)          # [H, B, 2D]
        dh_rec = torch.bmm(zo, w_zo).transpose(0, 1) + dpi * rsum_i + dpf * rsum_f
    return (*dx, recurrent_grad(state["h"], h, dx))
