"""The work of one call of each of the port's kernels: (operations, bytes).

Frozen copy of ``src/repro_torch/cost/kernels.py`` (commit 02043fe) with one
count per kernel: the least work that the call's inputs need by the published
equations, whatever implements it. So the mLSTM backward is counted as
``mlstm_backward(..., as_built=False)`` there (the chunk-start states taken
as given, the scores once), and the sLSTM as the factored recurrent products
of PR 34's count. Bytes count each input read once and each output written
once; operations count a multiply-add as two.
"""
from __future__ import annotations

from typing import Tuple

Work = Tuple[int, int]


def visible_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask with ``window`` (0: none) lets through."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_forward(B: int, S: int, H: int, K: int, hd: int, window: int = 0,
                  itemsize: int = 2, lse: bool = False) -> Work:
    """QK^T and PV over the visible pairs; q, k, v in, o out (and the float32
    log-sum-exp [B, H, S] that training writes beside it)."""
    flops = 4 * B * H * hd * visible_pairs(S, window)
    nbytes = itemsize * (2 * B * S * H * hd + 2 * B * S * K * hd)
    return flops, nbytes + (4 * B * H * S if lse else 0)


def flash_backward(B: int, S: int, H: int, K: int, hd: int, window: int = 0,
                   itemsize: int = 2) -> Work:
    """Five products over the visible pairs (QK^T again, dP, dV, dQ, dK); q, k,
    v, o, dO and the log-sum-exp in, dq, dk, dv out."""
    flops = 5 * 2 * B * H * hd * visible_pairs(S, window)
    nbytes = itemsize * (3 * B * S * H * hd + 2 * B * S * K * hd) + 4 * B * H * S \
        + itemsize * (B * S * H * hd + 2 * B * S * K * hd)
    return flops, nbytes


def chunk_size(S: int, chunk: int) -> int:
    """The largest divisor of S that is at most ``chunk`` (the model's rule)."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def mlstm(B: int, S: int, H: int, dqk: int, dv: int, chunk: int, itemsize: int = 2) -> Work:
    """The chunkwise mLSTM forward at chunk ``chunk`` (a divisor of S): within
    each chunk the causal pairs' q k^T, W v and the row sums, across chunks q C
    and the C and n updates; q, k, v in and h out, the float32 gates in and the
    final float32 state (C, n, m) out."""
    c = chunk
    pairs = c * (c + 1) // 2
    per_chunk = 2 * pairs * (dqk + dv + 1) + 4 * c * dqk * dv + 4 * c * dqk
    flops = B * H * (S // c) * per_chunk
    nbytes = (itemsize * B * S * H * (2 * dqk + 2 * dv) + 4 * 2 * B * S * H
              + 4 * B * H * (dqk * dv + dqk + 1))
    return flops, nbytes


def mlstm_backward(B: int, S: int, H: int, dqk: int, dv: int, chunk: int,
                   itemsize: int = 2) -> Work:
    """The chunkwise mLSTM backward's own work: the chunk-start states taken as
    given, the scores once; q, k, v, h, dh and the float32 gates in, dq, dk, dv
    and the float32 di, df out."""
    c = chunk
    T = S // c
    pairs = c * (c + 1) // 2
    nbytes = itemsize * B * S * H * (4 * dqk + 4 * dv) + 4 * 4 * B * S * H
    per_chunk = 8 * c * dqk * dv + pairs * (6 * dqk + 4 * dv) + 4 * c * dqk + 2 * c * dv
    return B * H * T * per_chunk, nbytes


SLSTM_GATE_OPS = 17       # a column's step of the forward's elementwise terms
SLSTM_BWD_OPS = 25        # a column's step of the backward's elementwise terms


def slstm(B: int, S: int, H: int, dh: int, saved: bool = False) -> Work:
    """The sLSTM recurrence of one layer: each step's z and o products h_{t-1}
    rec[g] (2 dh^2 a row, head and gate), the i and f gates factored through
    rec's row means (once, 2 H dh^2) and the gates; xz, xi, xf, xo and rec in,
    the state in and out, h out, all float32; ``saved`` (training) also c, n,
    z, o and the head's three gate scalars of every step out."""
    flops = 4 * B * S * H * dh * dh + 2 * H * dh * dh + SLSTM_GATE_OPS * B * S * H * dh
    state = 3 * B * H * dh + B * H
    words = 5 * B * S * H * dh + 4 * H * dh * dh + 2 * state
    if saved:
        words += 4 * B * S * H * dh + 3 * B * S * H
    return flops, 4 * words


def slstm_backward(B: int, S: int, H: int, dh: int) -> Work:
    """The sLSTM backward (drec is a product outside it): for every step but
    the first the z and o gates' dpre times rec's rows and the i and f gates'
    row sums times their scalar, once the row sums, and the elementwise terms;
    the saved values, dh, rec and the initial state in, dxz, dxi, dxf, dxo out,
    all float32."""
    flops = (4 * B * (S - 1) * H * dh * (dh + 1) + 2 * H * dh * dh
             + SLSTM_BWD_OPS * B * S * H * dh)
    words = (5 * B * S * H * dh + 3 * B * S * H + 4 * H * dh * dh + 2 * B * H * dh + B * H
             + 4 * B * S * H * dh)
    return flops, 4 * words
