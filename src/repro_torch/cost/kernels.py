"""The work of each of the port's kernels: (operations, bytes) of one call.

One set of formulas for two readers: ``chip_smoke.py`` divides them by the
card's rates for each kernel row's bound, and the kernels' wrappers report
them to the cost counter (``cost.analysis.report_kernel``) on every call,
on the card and on ``meta``. Bytes count each input read once and each
output written once; operations count the products at the rate of their
type (a multiply-add is two). Where the work depends on the mask, only the
(query, key) pairs it lets through count. The decode kernel reads every
slot of the cache, so its work counts the whole cache length.
"""
from __future__ import annotations

from typing import Tuple

Work = Tuple[int, int]


def visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs the causal mask with ``window`` (0: none) lets
    through: sum over q < S of min(q + 1, window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_forward(B: int, S: int, H: int, K: int, hd: int, window: int = 0,
                  itemsize: int = 2, lse: bool = False) -> Work:
    """QK^T and PV over the visible pairs; q, k, v in, o out (and the
    float32 log-sum-exp [B, H, S] that training writes beside it)."""
    flops = 4 * B * H * hd * visible_pairs(S, window)
    nbytes = itemsize * (2 * B * S * H * hd + 2 * B * S * K * hd)
    return flops, nbytes + (4 * B * H * S if lse else 0)


def flash_backward(B: int, S: int, H: int, K: int, hd: int, window: int = 0,
                   itemsize: int = 2) -> Work:
    """Five products over the visible pairs (QK^T again, dP, dV, dQ, dK); q,
    k, v, o, dO and the log-sum-exp in, dq, dk, dv out."""
    flops = 5 * 2 * B * H * hd * visible_pairs(S, window)
    nbytes = itemsize * (3 * B * S * H * hd + 2 * B * S * K * hd) + 4 * B * H * S \
        + itemsize * (B * S * H * hd + 2 * B * S * K * hd)
    return flops, nbytes


def decode(B: int, H: int, K: int, L: int, hd: int, itemsize: int = 2) -> Work:
    """One query a head against all L slots; q and the cache in, o out, and
    the slots' positions (int32)."""
    flops = 4 * B * H * hd * L
    nbytes = itemsize * (2 * B * H * hd + 2 * B * L * K * hd) + 4 * L
    return flops, nbytes


def mlstm(B: int, S: int, H: int, dqk: int, dv: int, chunk: int, itemsize: int = 2) -> Work:
    """The chunkwise mLSTM at chunk ``chunk`` (a divisor of S): within each
    chunk the causal pairs' q k^T, W v and the row sums, across chunks q C
    and the C and n updates; q, k, v in and h out, the float32 gates in and
    the final float32 state (C, n, m) out."""
    c = chunk
    pairs = c * (c + 1) // 2                       # causal (j, l) pairs per chunk
    per_chunk = (2 * pairs * (dqk + dv + 1)        # q k^T, W v, sum W S
                 + 4 * c * dqk * dv                # q C and the C update
                 + 4 * c * dqk)                    # q . n and the n update
    flops = B * H * (S // c) * per_chunk
    nbytes = (itemsize * B * S * H * (2 * dqk + 2 * dv)   # q, k, v in, h out
              + 4 * 2 * B * S * H                  # the two gates (f32)
              + 4 * B * H * (dqk * dv + dqk + 1))  # C, n, m out (f32)
    return flops, nbytes


def mlstm_backward(B: int, S: int, H: int, dqk: int, dv: int, chunk: int,
                   itemsize: int = 2, as_built: bool = True,
                   path: str = "tensor_cores") -> Work:
    """The backward of the chunkwise mLSTM at chunk ``chunk`` (a divisor of
    S), as built in ``csrc/mlstm_chunk_bwd.cu`` on ``path``, the one that
    ``ops.backward_path`` picks for the dtype and the widths:

    * ``"tensor_cores"``: over
      the T - 1 chunk boundaries, [c, dqk] x [c, dv]-sized products for the
      chunk-start states, their gradient walked back, dh C^T in dq, v G^T in
      dk and k G in dv, each twice (its float32 operand split into bf16 hi
      and lo); over the causal pairs of every chunk the scores once, dP = dh
      v^T, and twice (dS, W' split) dS k, dS^T q and W'^T dh; the vector
      terms (n and dn, q . n, dh . h, the row dots with q and k, <C_t, G_t>);
    * ``"cuda_cores"``: per chunk five such products
      (the states recomputed for every chunk, the gradient walked back, q
      C^T, v dC^T, k dC), over the causal pairs the scores twice, dP, dS k,
      dS^T q, W^T dh, and the vector terms.

    ``as_built=False`` counts the backward's own work, the bound's: the
    chunk-start states taken as given (no recompute) and the scores once.
    q, k, v, h, dh and the float32 gates in, dq, dk, dv and the float32 di,
    df out; the scratch between the kernel's launches is not counted."""
    c = chunk
    T = S // c
    pairs = c * (c + 1) // 2
    nbytes = itemsize * B * S * H * (4 * dqk + 4 * dv) + 4 * 4 * B * S * H
    if not as_built:
        per_chunk = 8 * c * dqk * dv + pairs * (6 * dqk + 4 * dv) + 4 * c * dqk + 2 * c * dv
        return B * H * T * per_chunk, nbytes
    if path not in ("tensor_cores", "cuda_cores"):
        raise ValueError(f"path is 'tensor_cores' or 'cuda_cores', got {path!r}")
    if path == "tensor_cores":
        per_head = ((T - 1) * (20 * c * dqk * dv + 10 * c * dqk)
                    + T * (pairs * (10 * dqk + 6 * dv) + 2 * c * dv)
                    + max(T - 2, 0) * 2 * dqk * dv)
        return B * H * per_head, nbytes
    per_chunk = 10 * c * dqk * dv + pairs * (8 * dqk + 4 * dv) + 6 * c * dqk + 2 * c * dv
    return B * H * T * per_chunk, nbytes


def rglru_forward(B: int, S: int, W: int, itemsize: int = 4, out_itemsize: int = 4) -> Work:
    """One multiply-add a step and channel (float32 carry); a and b in, h0
    in (float32), h out."""
    flops = 2 * B * S * W
    nbytes = itemsize * 2 * B * S * W + out_itemsize * B * S * W + 4 * B * W
    return flops, nbytes


def rglru_backward(B: int, S: int, W: int) -> Work:
    """Two multiply-add-sized operations and a product a step (float32); a,
    h, dh and h0 in, da, db and dh0 out."""
    return 3 * B * S * W, 4 * (5 * B * S * W + 2 * B * W)


# a column's step: the z and o sums, two terms xi / dh + h rho (3 each) and
# their sums, 3 c, 2 n, 2 h
SLSTM_GATE_OPS = 17
SLSTM_BWD_OPS = 25        # a column's step of the backward's elementwise terms


def slstm(B: int, S: int, H: int, dh: int, saved: bool = False) -> Work:
    """The sLSTM recurrence of one layer as the kernel computes it: each
    step's z and o products h_{t-1} rec[g] (2 dh^2 a row, head and gate),
    the i and f gates factored through rec's row means (once, 2 H dh^2;
    then per column and step a term xi / dh + h rho and its sum) and the
    gates; xz, xi, xf, xo and rec in, the state (h, c, n [B, H, dh], m
    [B, H]) in and out, h out, all float32; ``saved`` (training) also c, n,
    z, o and the head's three gate scalars of every step out."""
    flops = 4 * B * S * H * dh * dh + 2 * H * dh * dh + SLSTM_GATE_OPS * B * S * H * dh
    state = 3 * B * H * dh + B * H
    words = 5 * B * S * H * dh + 4 * H * dh * dh + 2 * state
    if saved:
        words += 4 * B * S * H * dh + 3 * B * S * H
    return flops, 4 * words


def slstm_backward(B: int, S: int, H: int, dh: int) -> Work:
    """The sLSTM backward kernel (drec is a product outside it): for every
    step but the first, the z and o gates' dpre times rec's rows (4 dh^2 a
    row and head) and the i and f gates' row sums times their scalar, once
    the row sums (2 H dh^2), and the elementwise terms; the saved c, n, z, o
    and gate scalars, dh, rec and the initial (c, n, m) in, dxz, dxi, dxf
    and dxo out, all float32."""
    flops = (4 * B * (S - 1) * H * dh * (dh + 1) + 2 * H * dh * dh
             + SLSTM_BWD_OPS * B * S * H * dh)
    words = (5 * B * S * H * dh + 3 * B * S * H + 4 * H * dh * dh + 2 * B * H * dh + B * H
             + 4 * B * S * H * dh)
    return flops, 4 * words
