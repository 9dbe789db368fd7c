"""Plain PyTorch version of the batched WS request-queue core.

The function the CUDA kernel computes, written as the JAX package writes it
(``repro.workloads.queueing``: the ``body`` of ``_kw_batched_core`` and of
``_pw_batched_core``, then ``_device_fold``), batched over jobs in float32:
a Python loop over requests on ``[B, k_pad]`` slot vectors, then the metric
fold. A job's row depends on that job alone (padded slots and intervals are
value-invariant), so co-batched jobs never change each other's bits.

Inputs, one row a job (``n_pad`` requests, ``e_pad`` capacity intervals):
  t, s        [B, n_pad] float32 arrival and service times; padding has t = inf
  n_valid     [B] int32 requests of each job (the rest is padding)
  horizon     [B] float32: a request that cannot start before it is unserved
  slo         [B] float32 latency target: a violation is unserved or above it
  cap_t       [B, e_pad] float32 interval starts (padding: inf)
  cap_k       [B, e_pad] int32 slots in each interval (padding: 0); the
              constant kind reads only column 0, its k
  hi_t        [B, e_pad] float32 interval ends (the last real one and
              padding: inf)
  k_pad       the width of the slot vector, at least every job's largest k

Returns [B, 8] float32 in ``FOLD_COLS`` order: n_served, p50, p95, p99,
mean, max, mean wait, violations. A job with nothing served has inf
percentiles, mean and mean wait 0 and max -inf (its metrics come from the
counts alone).

``queue_flush_reference`` takes a flush as the kernel does, flat tables of
ragged jobs of both kinds (``kind`` [J], 0 "const" or 1 "pw"; t, s [N] with
job j's requests at [req_off[j], req_off[j] + n_j), n_j = n_valid[j] where
given, else req_off[j + 1] - req_off[j]; cap_t, cap_k, hi_t [E] with job j's
intervals at [cap_off[j], cap_off[j + 1]); horizon, slo [J]), and gives each
job the row ``queue_core_reference`` gives it alone.

``window_start`` and ``advance_cursor`` state the kernel's interval search
in plain numpy (a window of 32 intervals, a cursor that only moves past
intervals the commit point has passed), for the tests to hold against the
``amin`` over all intervals.
"""
from __future__ import annotations

import numpy as np
import torch

KINDS = ("const", "pw")
QUANTILES = (50.0, 95.0, 99.0)


def _columns(x):
    """[B, n] -> n views [B, 1], one a request (cheaper to index in the loop)."""
    return x.t().contiguous().unsqueeze(-1).unbind(0)


def _kw_scan(t, s, cap_k, horizon, k_pad):
    """Constant capacity: Kiefer-Wolfowitz, start = max(t_i, min(free)) and
    the earliest-free slot takes the finish; slots beyond a job's k stay
    inf. Returns each request's start [B, 1], inf where unserved."""
    slot = torch.arange(k_pad, device=t.device)
    free = torch.where(slot[None, :] < cap_k[:, :1], 0.0, torch.inf).to(torch.float32)
    hz = horizon[:, None]
    starts = []
    for t_i, s_i in zip(_columns(t), _columns(s)):
        earliest, slot_i = free.min(dim=1, keepdim=True)
        start = torch.maximum(t_i, earliest)
        ok = start < hz
        free = torch.where(ok, free.scatter(1, slot_i, start + s_i), free)
        starts.append(torch.where(ok, start, torch.inf))
    return starts


def _pw_scan(t, s, cap_t, cap_k, hi_t, horizon, k_pad):
    """Piecewise capacity k(t): a sorted slot vector and the FIFO commit
    point. In interval e a request may start once fewer than k_e slots are
    busy (the (K - k_e)-th finish of the sorted vector), within [cap_t,
    hi_t); the earliest such start wins. A served request drops the earliest
    finish and inserts its own in order. An unserved request whose
    queue-adjusted arrival is inside the horizon zeroes every slot that
    frees before the horizon (the oracle's heap drain). Returns each
    request's start [B, 1], inf where unserved."""
    B, K = t.shape[0], k_pad
    j = torch.arange(K, device=t.device)
    gi = torch.clamp(K - cap_k, 0, K - 1).long()
    closed = cap_k <= 0
    free = torch.zeros((B, K), dtype=torch.float32, device=t.device)
    prev = torch.zeros((B, 1), dtype=torch.float32, device=t.device)
    hz = horizon[:, None]
    starts = []
    for t_i, s_i in zip(_columns(t), _columns(s)):
        s0 = torch.maximum(t_i, prev)
        thresh = free.gather(1, gi).masked_fill_(closed, torch.inf)
        lo = torch.maximum(torch.maximum(cap_t, thresh), s0)
        start = lo.masked_fill_(lo >= hi_t, torch.inf).amin(dim=1, keepdim=True)
        served = start < hz
        fin = start + s_i
        # drop free[0], insert fin: free[j + 1] below pos, fin at pos, free[j] above
        pos = (free[:, 1:] < fin).sum(dim=1, keepdim=True)
        merged = torch.where(j < pos, free.roll(-1, 1), torch.where(j == pos, fin, free))
        drained = (s0 < hz).logical_and_(~served).logical_and(free < hz)
        free = torch.where(served, merged, free.masked_fill(drained, 0.0))
        prev = torch.where(served, start, prev)
        starts.append(torch.where(served, start, torch.inf))
    return starts


def fold(lat, wait, n_valid, slo):
    """[B, n] latencies and waits -> [B, 8] ``FOLD_COLS``, as
    ``_device_fold``: percentiles by numpy's linear rule over the served
    (finite) latencies in float32, means of the served, violations over
    the valid requests."""
    n = lat.shape[1]
    served = torch.isfinite(lat)
    m = served.sum(dim=1)
    mf = m.to(torch.float32)
    # q / 100 on the CPU: on a CUDA tensor PyTorch divides by a scalar as a
    # product with its reciprocal, one ulp off at 0.99
    q = (torch.tensor(QUANTILES, dtype=torch.float32) / 100.0).to(lat.device)
    pos = torch.clamp(mf - 1.0, min=0.0)[:, None] * q[None, :]
    lo_r = torch.floor(pos).long()
    hi_r = torch.minimum(lo_r + 1, torch.clamp(m - 1, min=0)[:, None])
    frac = pos - lo_r.to(torch.float32)
    ordered = torch.sort(lat, dim=1).values                  # inf (unserved) last
    lo = ordered.gather(1, lo_r)
    hi = ordered.gather(1, hi_r)
    pcts = lo * (1.0 - frac) + hi * frac
    pcts = torch.where(m[:, None] > 0, pcts, torch.inf)
    denom = torch.clamp(m, min=1).to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=lat.device)
    mean = (torch.where(served, lat.double(), zero).sum(dim=1) / denom).float()
    mean_w = (torch.where(served, wait.double(), zero).sum(dim=1) / denom).float()
    mx = torch.where(served, lat, -torch.inf).amax(dim=1)
    valid = torch.arange(n, device=lat.device)[None, :] < n_valid[:, None]
    viol = (valid & (~served | (lat > slo[:, None]))).sum(dim=1)
    return torch.cat([mf[:, None], pcts, mean[:, None], mx[:, None],
                      mean_w[:, None], viol.to(torch.float32)[:, None]], dim=1)


def _starts(kind, t, s, cap_t, cap_k, hi_t, horizon, k_pad):
    """Each request's start [B, steps], inf where unserved."""
    if kind == "const":
        starts = _kw_scan(t, s, cap_k, horizon, k_pad)
    else:
        starts = _pw_scan(t, s, cap_t, cap_k, hi_t, horizon, k_pad)
    return torch.cat(starts, dim=1)


def _lat_wait(start, t, s):
    served = torch.isfinite(start)
    lat = torch.where(served, (start + s) - t, torch.inf)    # fin - t_i
    wait = torch.where(served, start - t, torch.inf)
    return lat, wait


def queue_core_reference(kind, t, s, n_valid, horizon, slo, cap_t, cap_k, hi_t,
                         k_pad: int) -> torch.Tensor:
    """The batched queue core in plain PyTorch; see the module docstring.
    Padded requests change no carry, so the loop stops at the batch's
    longest job (one step at least: a padded one)."""
    if kind not in KINDS:
        raise ValueError(f"unknown queue kind {kind!r}; have {KINDS}")
    steps = max(int(n_valid.max()), 1)
    t, s = t[:, :steps].float(), s[:, :steps].float()
    start = _starts(kind, t, s, cap_t, cap_k, hi_t, horizon, k_pad)
    return fold(*_lat_wait(start, t, s), n_valid, slo)


def queue_flush_reference(kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo,
                          n_valid=None) -> torch.Tensor:
    """A flush in plain PyTorch -> [J, 8]; see the module docstring. Job j's
    row is ``queue_core_reference``'s for job j alone: padding is
    value-invariant, so the jobs of one kind run their requests as one padded
    batch, and each job is then folded over its own requests (a padded one
    if it has none), as alone."""
    J, dev = kind.shape[0], t.device
    off, co, kinds = req_off.tolist(), cap_off.tolist(), kind.tolist()
    nv = n_valid.tolist() if n_valid is not None else [off[j + 1] - off[j] for j in range(J)]
    out = torch.empty((J, 8), dtype=torch.float32, device=dev)
    for kind_id, name in enumerate(KINDS):
        rows = [j for j in range(J) if kinds[j] == kind_id]
        if not rows:
            continue
        B, steps = len(rows), max(max(nv[j] for j in rows), 1)
        e_pad = max(co[j + 1] - co[j] for j in rows)
        t_b = torch.full((B, steps), torch.inf, dtype=torch.float32, device=dev)
        s_b = torch.zeros((B, steps), dtype=torch.float32, device=dev)
        ct_b = torch.full((B, e_pad), torch.inf, dtype=torch.float32, device=dev)
        hi_b = torch.full((B, e_pad), torch.inf, dtype=torch.float32, device=dev)
        ck_b = torch.zeros((B, e_pad), dtype=torch.int32, device=dev)
        for r, j in enumerate(rows):
            n, e = nv[j], co[j + 1] - co[j]
            t_b[r, :n] = t[off[j]:off[j] + n]
            s_b[r, :n] = s[off[j]:off[j] + n]
            ct_b[r, :e] = cap_t[co[j]:co[j + 1]]
            ck_b[r, :e] = cap_k[co[j]:co[j + 1]]
            hi_b[r, :e] = hi_t[co[j]:co[j + 1]]
        k_pad = max(int(ck_b.max()), 1)
        idx = torch.tensor(rows, device=dev)
        lat, wait = _lat_wait(_starts(name, t_b, s_b, ct_b, ck_b, hi_b, horizon[idx].float(),
                                      k_pad), t_b, s_b)
        for r, j in enumerate(rows):
            m = max(nv[j], 1)
            out[j] = fold(lat[r:r + 1, :m], wait[r:r + 1, :m],
                          torch.tensor([nv[j]], device=dev), slo[j:j + 1].float())[0]
    return out


def window_start(s0, cap_t, thresh, hi_t, wb: int, width: int = 32):
    """The kernel's interval search for one request, in float32 numpy.
    ``thresh`` is each interval's free[K - k_e] (+inf where k_e <= 0), ``wb``
    the cursor. An interval that has not ended (s0 < hi) is feasible iff
    a = max(cap_t, thresh) < hi, and then max(cap_t, thresh, s0) = max(a,
    s0): start = max(s0, the least feasible a). The window [wb, wb + width)
    is searched first; the starts ascend, so a later window is searched only
    while the min exceeds the start of its first interval."""
    a = np.maximum(cap_t, thresh)
    cand = np.where((s0 < hi_t) & (a < hi_t), a, np.float32(np.inf))
    m = cand[wb:wb + width].min(initial=np.float32(np.inf))
    nb = wb + width
    while nb < len(cap_t) and m > cap_t[nb]:
        m = min(m, cand[nb:nb + width].min())
        nb += width
    return np.maximum(np.float32(s0), m)


def advance_cursor(prev, hi_t, wb: int, width: int = 32) -> int:
    """The cursor after a request: where intervals remain past the window,
    past the window's leading intervals that ended by the commit point
    ``prev`` (which never decreases, so no later request can use them)."""
    if len(hi_t) > wb + width:
        ended = hi_t[wb:wb + width] <= prev
        wb += width if ended.all() else int(np.argmin(ended))
    return wb
