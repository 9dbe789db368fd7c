"""M/G/k-style replica queue with continuous-batching service times.

Each WS node runs one serving replica with ``ServiceTimeModel.max_batch``
concurrent slots (the same knob as ``ContinuousBatcher``); the cluster is a
FIFO queue over ``k(t) = nodes(t) * slots_per_replica`` slots. Capacity is
piecewise-constant in time, so the same simulator measures both the
autoscaler's *planned* latency and the latency *realized* under whatever the
Resource Provision Service actually granted (they differ exactly when WS
demand went unmet — the tail the paper's node-demand timeseries can't see).

Capacity drops do not kill in-flight requests (nodes drain, matching the WS
CMS's release-idle-nodes policy); they only gate new starts.

Implementations (all agree bit-for-bit on float64, enforced by
tests/test_queueing_equivalence.py):

  * ``no_wait``   — vectorized numpy O(N log N): when no request ever
                    queues (checked exactly), latency == service time.
  * ``constant``  — constant capacity k: FIFO M/G/k reduces to the
                    Kiefer–Wolfowitz k-slot rolling-finish recurrence
                    (replace the earliest-free slot), O(N log k).
  * ``event``     — piecewise capacity: two-pointer event-merged sweep,
                    O((N + E) log k) with an O(E) next-capacity-rise
                    table instead of a searchsorted per retry.
  * ``reference`` — the original per-request loop with a binary-search
                    capacity lookup inside a retry loop; kept as the
                    golden oracle and the benchmark baseline.

``simulate_queue_batch`` (and its ``simulate_queue_many`` wrapper) runs
every heterogeneous cell of a flush in ONE launch of the hand-written
``kernels.queue_core`` CUDA kernel (``queue_flush``, ragged flat tables) — a
Kiefer–Wolfowitz recurrence for constant capacity and a k(t)-aware
sorted-slot recurrence for piecewise capacity — with the metric fold in the
same launch (float32 — golden-tolerance, not bit-identical). On the CPU the
kernel's plain PyTorch version runs instead; nothing falls back to the numpy
paths unless asked (``backend='numpy'``). The JAX package's shape-bucket
plan stays (``plan_queue_buckets``, ``bucket_inputs``) for the bucket form
of the kernel and the parity tests.

The port's copy of ``repro.workloads.queueing``: the exact numpy paths are
the JAX package's, line for line; the batched section replaces its
``jit(vmap(lax.scan))`` programs with the kernel.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from math import inf as _INF
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import SLOConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.queue_core import queue_flush
from repro_torch.serving.batching import ServiceTimeModel
from repro_torch.workloads.arrivals import RequestTrace

# running totals across simulate_queue calls: the campaign snapshots these
# around each cell to report queue-sim requests/sec in its artifact (one
# dict per process; cells return deltas, so process pools stay correct)
SIM_COUNTERS: Dict[str, float] = {
    "calls": 0, "requests": 0, "seconds": 0.0,
    "no_wait": 0, "constant": 0, "event": 0, "reference": 0,
    "cuda_batched": 0, "torch_batched": 0,
}


def snapshot_counters() -> Dict[str, float]:
    return dict(SIM_COUNTERS)


def counters_delta(before: Dict[str, float]) -> Dict[str, float]:
    return {k: SIM_COUNTERS[k] - before.get(k, 0) for k in SIM_COUNTERS}


@dataclasses.dataclass
class QueueMetrics:
    n_requests: int
    n_served: int
    p50_s: float
    p95_s: float
    p99_s: float
    mean_s: float
    max_s: float
    mean_wait_s: float
    violation_rate: float          # frac(latency > slo.latency_target_s)
    slo_met: bool                  # violation_rate <= slo.max_violation_rate
    unserved: int                  # never started before horizon

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def capacity_steps(events: Sequence[Tuple[float, int]],
                   slots_per_node: int = 1
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize (time, nodes) change events into step arrays (times, slots).

    Events need not be sorted or deduplicated; the last level at a given
    time wins. Capacity before the first event is 0.
    """
    if not events:
        return np.array([0.0]), np.array([0], dtype=np.int64)
    # stable sort on time only: among same-time events the last logged wins
    ev = sorted(events, key=lambda e: e[0])
    times, levels = [0.0], [0]
    for t, n in ev:
        lvl = int(n) * slots_per_node
        if t == times[-1]:
            levels[-1] = lvl
        else:
            times.append(float(t))
            levels.append(lvl)
    return np.asarray(times), np.asarray(levels, dtype=np.int64)


# ----------------------------------------------------------- metric fold


def _metrics(n: int, lat: np.ndarray, wait: np.ndarray, unserved: int,
             slo: SLOConfig) -> QueueMetrics:
    """Fold per-request latency/wait arrays into QueueMetrics (shared by
    every implementation, so they can only disagree on the arrays)."""
    served = np.isfinite(lat)
    n_served = int(served.sum())
    viol = float(np.mean(~served | (lat > slo.latency_target_s)))
    if n_served == 0:
        return QueueMetrics(n, 0, np.inf, np.inf, np.inf, np.inf, np.inf,
                            np.inf, 1.0, False, unserved)
    sl = lat[served]
    p50, p95, p99 = np.percentile(sl, [50.0, 95.0, 99.0])
    return QueueMetrics(
        n_requests=n,
        n_served=n_served,
        p50_s=float(p50),
        p95_s=float(p95),
        p99_s=float(p99),
        mean_s=float(sl.mean()),
        max_s=float(sl.max()),
        mean_wait_s=float(wait[served].mean()),
        violation_rate=viol,
        slo_met=viol <= slo.max_violation_rate,
        unserved=unserved,
    )


# ------------------------------------------------------- implementations


def _try_no_wait(t: np.ndarray, svc: np.ndarray, cap_t: np.ndarray,
                 cap_k: np.ndarray, horizon: float
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Fully vectorized fast path: if no request would ever queue, latency
    is exactly the service time. Returns None when any request waits.

    With FIFO starts at the arrival instants, request i finds
    ``#{j < i : t_j + svc_j > t_i}`` slots busy; since arrivals are sorted
    and service times positive, that count is a single global searchsorted
    over the optimistic finish times. The check is exact, so the arrays
    returned are bit-identical to what the reference loop would produce.
    """
    n = len(t)
    if n == 0 or float(svc.min()) <= 0.0 or float(t[-1]) >= horizon:
        return None
    fin = t + svc
    # cheap prefix probe: queueing in the first block rejects congested
    # cells without paying the full-array sort
    probe = 2048
    if n > probe:
        tp = t[:probe]
        kp = cap_k[np.searchsorted(cap_t, tp, side="right") - 1]
        infl_p = (np.arange(probe)
                  - np.searchsorted(np.sort(fin[:probe]), tp, side="right"))
        if not np.all(infl_p < kp):
            return None
    k_at = cap_k[np.searchsorted(cap_t, t, side="right") - 1]
    inflight = np.arange(n) - np.searchsorted(np.sort(fin), t, side="right")
    if not np.all(inflight < k_at):
        return None
    return fin - t, np.zeros(n)


def _simulate_constant(t: np.ndarray, svc: np.ndarray, k: int,
                       horizon: float
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Constant-capacity FIFO M/G/k: Kiefer–Wolfowitz rolling-finish
    recurrence over a k-slot heap of slot-free times, O(N log k).

    A request starts at max(arrival, earliest slot-free time) and replaces
    that slot's finish — no capacity lookups, no retry loop. Bit-identical
    to the reference loop (same max/add float64 arithmetic).
    """
    n = len(t)
    lat = [_INF] * n
    wait = [_INF] * n
    if k <= 0:
        return np.asarray(lat), np.asarray(wait), n
    sl = svc.tolist()
    heapreplace = heapq.heapreplace
    heappush = heapq.heappush
    busy: List[float] = []          # slot free times, at most k entries
    unserved = 0
    for i, t0 in enumerate(t.tolist()):
        if len(busy) < k:
            if t0 >= horizon:
                unserved += 1
                continue
            fin = t0 + sl[i]
            heappush(busy, fin)
            lat[i] = fin - t0
            wait[i] = 0.0
            continue
        m = busy[0]
        start = t0 if t0 > m else m
        if start >= horizon:
            unserved += 1
            continue
        fin = start + sl[i]
        heapreplace(busy, fin)
        wait[i] = start - t0
        lat[i] = fin - t0
    return np.asarray(lat), np.asarray(wait), unserved


def _next_rise(cap_k: Sequence[int]) -> List[int]:
    """next_rise[j] = smallest j' > j with cap_k[j'] > cap_k[j], else nc.

    Monotonic-stack precompute so the event-merged sweep finds "when does
    capacity next exceed the current level" in O(1) instead of scanning."""
    nc = len(cap_k)
    out = [nc] * nc
    stack: List[int] = []
    for j in range(nc):
        kj = cap_k[j]
        while stack and cap_k[stack[-1]] < kj:
            out[stack.pop()] = j
        stack.append(j)
    return out


def _simulate_event(t: np.ndarray, svc: np.ndarray, cap_t: np.ndarray,
                    cap_k: np.ndarray, horizon: float
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Piecewise-capacity FIFO sweep: two pointers (requests, capacity
    events) merged in time, O((N + E) log k).

    The capacity interval of every *arrival* is precomputed in one
    vectorized searchsorted; the scalar pointer only walks events for the
    requests whose start was pushed past their arrival by the FIFO queue.
    It advances monotonically with the committed start time (which is
    nondecreasing across *served* requests); a request that turns out
    unserved searches with a local copy so future capacity never leaks
    back to earlier arrivals. Blocked requests jump straight to
    min(earliest finish, next capacity rise) via the ``_next_rise`` table
    instead of rescanning events per retry. Bit-identical to the
    reference loop.
    """
    n = len(t)
    sl = svc.tolist()
    ct = cap_t.tolist()
    ck = cap_k.tolist()
    nc = len(ct)
    ngr = _next_rise(ck)
    heappush = heapq.heappush
    heappop = heapq.heappop
    lat = [_INF] * n
    wait = [_INF] * n
    ci_of_t = (np.searchsorted(cap_t, t, side="right") - 1).tolist()
    busy: List[float] = []          # completion-time heap of in-flight slots
    blen = 0                        # len(busy), tracked to skip len() calls
    unserved = 0
    prev_start = 0.0                # FIFO discipline: a request never starts
    ci_done = 0                     # capacity interval at prev_start
    for i, t0 in enumerate(t.tolist()):
        if t0 >= prev_start:        # common case: arrival interval known
            start = t0
            ci = ci_of_t[i]
        else:
            start = prev_start
            ci = ci_done
            while ci + 1 < nc and ct[ci + 1] <= start:
                ci += 1
        while True:
            k = ck[ci]
            while blen and busy[0] <= start:
                heappop(busy)
                blen -= 1
            if blen < k:
                break
            # blocked: wait for a slot to free or capacity to rise
            cand = busy[0] if blen else _INF
            jn = ngr[ci]
            if jn < nc and ct[jn] < cand:
                cand = ct[jn]
            if cand == _INF:
                start = _INF
                break
            if cand > start:
                start = cand
            if start >= horizon:
                start = _INF
                break
            while ci + 1 < nc and ct[ci + 1] <= start:
                ci += 1
        if start >= horizon:            # also catches start == inf
            unserved += 1
            continue
        prev_start = start
        ci_done = ci
        fin = start + sl[i]
        heappush(busy, fin)
        blen += 1
        wait[i] = start - t0
        lat[i] = fin - t0
    return np.asarray(lat), np.asarray(wait), unserved


def _simulate_reference(t: np.ndarray, svc: np.ndarray, cap_t: np.ndarray,
                        cap_k: np.ndarray, horizon: float
                        ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The original per-request loop (searchsorted capacity lookup inside a
    retry loop). Kept verbatim as the golden oracle and bench baseline."""
    n = len(t)
    busy: List[float] = []          # completion-time heap of in-flight slots
    lat = np.empty(n)
    wait = np.empty(n)
    unserved = 0
    nc = len(cap_t)
    prev_start = 0.0                # FIFO discipline: a request never starts
    #                                 before the one queued ahead of it

    for i in range(n):
        t0 = float(t[i])
        start = max(t0, prev_start)
        while True:
            # capacity level AT `start` (looked up per request — a global
            # monotone pointer would apply a later capacity step to this
            # request whenever an earlier one blocked past it)
            ci = int(np.searchsorted(cap_t, start, side="right")) - 1
            k = int(cap_k[ci])
            while busy and busy[0] <= start:
                heapq.heappop(busy)
            if len(busy) < k:
                break
            # blocked: wait for a slot to free or capacity to rise
            nxt = []
            if busy:
                nxt.append(busy[0])
            j = ci + 1
            while j < nc:
                if cap_k[j] > k:
                    nxt.append(float(cap_t[j]))
                    break
                j += 1
            if not nxt:
                start = np.inf
                break
            start = max(start, min(nxt))
            if start >= horizon:
                start = np.inf
                break
        if not np.isfinite(start) or start >= horizon:
            unserved += 1
            lat[i] = np.inf
            wait[i] = np.inf
            continue
        prev_start = start
        fin = start + float(svc[i])
        heapq.heappush(busy, fin)
        wait[i] = start - t0
        lat[i] = fin - t0
    return lat, wait, unserved


IMPLS = ("auto", "fast", "event", "reference")


def simulate_queue(trace: RequestTrace,
                   capacity_events: Sequence[Tuple[float, int]],
                   model: ServiceTimeModel,
                   slo: SLOConfig,
                   horizon: Optional[float] = None,
                   impl: str = "auto") -> QueueMetrics:
    """FIFO M/G/k(t) simulation; returns latency + SLO metrics.

    capacity_events: (time, n_nodes) change events (each node contributes
    ``model.slots_per_replica`` slots). Requests that cannot start before
    `horizon` (capacity starvation) count as unserved AND as violations —
    an unserved request is the worst possible latency.

    impl: ``auto`` picks the fastest exact path (vectorized no-wait ->
    constant-capacity recurrence -> event-merged sweep); ``fast`` forces
    the vectorized family (raises on piecewise capacity with queueing);
    ``event`` and ``reference`` force those loops. All paths produce
    bit-identical float64 metrics.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    n = len(trace)
    if horizon is None:
        horizon = float(trace.t[-1]) + 1e9 if n else 0.0
    if n == 0:
        return QueueMetrics(0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                            True, 0)

    t0_wall = time.perf_counter()
    svc = model.service_times(trace.prompt_tokens, trace.decode_tokens)
    cap_t, cap_k = capacity_steps(capacity_events, model.slots_per_replica)
    t = np.asarray(trace.t, dtype=np.float64)
    horizon = float(horizon)
    constant = bool(np.all(cap_k == cap_k[0]))

    used = impl
    if impl == "reference":
        lat, wait, unserved = _simulate_reference(t, svc, cap_t, cap_k,
                                                  horizon)
    elif impl == "event":
        lat, wait, unserved = _simulate_event(t, svc, cap_t, cap_k, horizon)
    else:
        nw = _try_no_wait(t, svc, cap_t, cap_k, horizon)
        if nw is not None:
            lat, wait = nw
            unserved = 0
            used = "no_wait"
        elif constant:
            lat, wait, unserved = _simulate_constant(t, svc, int(cap_k[0]),
                                                     horizon)
            used = "constant"
        elif impl == "fast":
            raise ValueError("impl='fast' needs constant capacity or a "
                             "contention-free trace; use 'auto' or 'event'")
        else:
            lat, wait, unserved = _simulate_event(t, svc, cap_t, cap_k,
                                                  horizon)
            used = "event"

    SIM_COUNTERS["calls"] += 1
    SIM_COUNTERS["requests"] += n
    SIM_COUNTERS["seconds"] += time.perf_counter() - t0_wall
    SIM_COUNTERS[used] += 1
    return _metrics(n, lat, wait, unserved, slo)


def simulate_queue_reference(trace: RequestTrace,
                             capacity_events: Sequence[Tuple[float, int]],
                             model: ServiceTimeModel,
                             slo: SLOConfig,
                             horizon: Optional[float] = None
                             ) -> QueueMetrics:
    """The pre-vectorization implementation (golden oracle / baseline)."""
    return simulate_queue(trace, capacity_events, model, slo,
                          horizon=horizon, impl="reference")


# ------------------------------------------------ batched (queue_core kernel)


@dataclasses.dataclass(frozen=True)
class QueueJob:
    """One cell of a batched queue simulation (``simulate_queue_batch``)."""
    trace: RequestTrace
    capacity_events: Sequence[Tuple[float, int]]
    model: ServiceTimeModel
    slo: SLOConfig
    horizon: Optional[float] = None


# columns of the batched metric fold, in order
FOLD_COLS = ("n_served", "p50_s", "p95_s", "p99_s", "mean_s", "max_s",
             "mean_wait_s", "violations")

def _pad_bucket(n: int, floor: int) -> int:
    """Smallest grid point >= n on the half-pow2 grid {p, 1.5p, 2p}:
    per-cell padding waste stays under 50% (above ``floor``) while cells
    of similar size share a bucket — one launch, one batch — and the
    number of distinct shapes stays logarithmic."""
    if n <= floor:
        return floor
    p = floor
    while p * 2 < n:
        p *= 2
    if p * 3 // 2 >= n:
        return p * 3 // 2
    return p * 2


def _pad_pow2(n: int, floor: int) -> int:
    """Smallest power-of-two grid point >= n: the slot width of a
    constant-capacity bucket. Padding there is value-invariant (padded
    slots hold inf), so it only sizes the batch's slot vectors."""
    p = floor
    while p < n:
        p *= 2
    return p


def _job_horizon(job: QueueJob) -> float:
    if job.horizon is not None:
        return float(job.horizon)
    return float(job.trace.t[-1]) + 1e9 if len(job.trace) else 0.0


def _job_caps(jobs: Sequence[QueueJob]) -> List[Optional[tuple]]:
    """Each job's ``capacity_steps`` arrays; None for an empty trace (those
    are handled on the host)."""
    return [capacity_steps(job.capacity_events, job.model.slots_per_replica)
            if len(job.trace) else None for job in jobs]


def _plan(jobs: Sequence[QueueJob]):
    """Bucket jobs by kind and padded trace length, as the JAX package's
    batched cores need (one launch a bucket there); returns (buckets, caps)
    where caps[i] is job i's ``capacity_steps`` arrays.

    Only ``n_pad`` is part of the key, a pure function of the cell alone.
    The e/k axes are padded at dispatch time to the batch maximum: padded
    intervals start at +inf and never produce a candidate, padded slots
    only add zeros below the sorted free list (or inf above a constant
    cell's k), so co-batching cells with different e/k changes the batch's
    shape but not one bit of any cell's result — shard merges stay
    bit-identical to single-shot campaign runs."""
    buckets: Dict[tuple, List[int]] = {}
    caps = _job_caps(jobs)
    for i, job in enumerate(jobs):
        if caps[i] is None:
            continue
        kind = "const" if len(caps[i][0]) == 1 else "pw"
        buckets.setdefault((kind, _pad_bucket(len(job.trace), 256)), []).append(i)
    return buckets, caps


def plan_queue_buckets(jobs: Sequence[QueueJob]) -> Dict[tuple, List[int]]:
    """Public view of the shape-bucket plan: {key: [job indices]}.

    Keys are ("const", n_pad) or ("pw", n_pad); a bucket's padded element
    count is ``len(rows) * n_pad``. The JAX package launches once a bucket;
    the port's flush is one launch whatever the buckets, and keeps the plan
    for the bucket form of the kernel and for parity. Jobs with empty traces
    are handled on host and appear in no bucket."""
    return _plan(jobs)[0]


def _metrics_from_fold(n: int, cols: np.ndarray,
                       slo: SLOConfig) -> QueueMetrics:
    m = int(cols[0])
    if m == 0:
        return QueueMetrics(n, 0, np.inf, np.inf, np.inf, np.inf, np.inf,
                            np.inf, 1.0, False, n)
    viol = float(cols[7]) / n
    return QueueMetrics(n, m, float(cols[1]), float(cols[2]),
                        float(cols[3]), float(cols[4]), float(cols[5]),
                        float(cols[6]), viol,
                        viol <= slo.max_violation_rate, n - m)


def bucket_inputs(jobs: Sequence[QueueJob], key: tuple, rows: Sequence[int],
                  caps: Sequence[Optional[tuple]]):
    """The queue core's host inputs for one bucket, as numpy arrays: (kind,
    t, s, n_valid, horizon, slo, cap_t, cap_k, hi_t, k_pad). Arrival and
    service times are float32 (service times drawn in float64 by
    ``ServiceTimeModel.service_times``, then cast), padding has t = inf."""
    kind, n_pad = key
    B = len(rows)
    t_b = np.full((B, n_pad), np.inf, dtype=np.float32)
    s_b = np.zeros((B, n_pad), dtype=np.float32)
    hz = np.empty(B, dtype=np.float32)
    nv = np.empty(B, dtype=np.int32)
    st = np.empty(B, dtype=np.float32)
    for r, i in enumerate(rows):
        job = jobs[i]
        tr = job.trace
        n = len(tr)
        t_b[r, :n] = tr.t
        s_b[r, :n] = job.model.service_times(tr.prompt_tokens,
                                             tr.decode_tokens)
        hz[r] = _job_horizon(job)
        nv[r] = n
        st[r] = job.slo.latency_target_s
    if kind == "const":
        k_pad = _pad_pow2(max(max(int(caps[i][1][0]), 1) for i in rows), 8)
        ct_b = np.zeros((B, 1), dtype=np.float32)
        hi_b = np.full((B, 1), np.inf, dtype=np.float32)
        ck_b = np.array([[int(caps[i][1][0])] for i in rows], dtype=np.int32)
    else:
        e_pad = -8 * (-max(len(caps[i][0]) for i in rows) // 8)
        k_pad = -8 * (-max(max(int(caps[i][1].max()), 1) for i in rows) // 8)
        ct_b = np.full((B, e_pad), np.inf, dtype=np.float32)
        hi_b = np.full((B, e_pad), np.inf, dtype=np.float32)
        ck_b = np.zeros((B, e_pad), dtype=np.int32)
        for r, i in enumerate(rows):
            cap_t, cap_k = caps[i]
            e = len(cap_t)
            ct_b[r, :e] = cap_t
            ck_b[r, :e] = cap_k
            hi_b[r, :e - 1] = cap_t[1:]
    return kind, t_b, s_b, nv, hz, st, ct_b, ck_b, hi_b, k_pad


# The flat flush tables, in ``queue_flush``'s argument order: (name, dtype).
FLUSH_FIELDS = (("kind", np.int32), ("t", np.float32), ("s", np.float32),
                ("req_off", np.int32), ("cap_t", np.float32), ("cap_k", np.int32),
                ("hi_t", np.float32), ("cap_off", np.int32), ("horizon", np.float32),
                ("slo", np.float32))


def flush_inputs(jobs: Sequence[QueueJob], rows: Sequence[int],
                 caps: Sequence[Optional[tuple]], pin_memory: bool = False):
    """The flat host tables of one flush (jobs ``rows``), built once in one
    int32 buffer (page-locked when ``pin_memory``), so that one copy moves
    them: returns (buffer, spans, k_max), spans[name] = (offset, length) in
    ``FLUSH_FIELDS`` order and k_max the flush's largest slot count (at
    least 1). Arrival and service times are float32 (service times drawn in
    float64 by ``ServiceTimeModel.service_times``, then cast); a job with one
    capacity interval is constant ("const", kind 0), else piecewise (1).
    Raises ValueError where a piecewise job's interval starts descend or
    begin below 0."""
    ns = [len(jobs[i].trace) for i in rows]
    es = [len(caps[i][0]) for i in rows]
    J, N, E = len(rows), sum(ns), sum(es)
    if max(N, E) >= 2 ** 31:
        raise ValueError("a flush holds fewer than 2**31 requests and intervals")
    sizes = {"kind": J, "t": N, "s": N, "req_off": J + 1, "cap_t": E, "cap_k": E,
             "hi_t": E, "cap_off": J + 1, "horizon": J, "slo": J}
    spans, at = {}, 0
    for name, _ in FLUSH_FIELDS:
        spans[name] = (at, sizes[name])
        at += sizes[name]
    buf = torch.empty(at, dtype=torch.int32, pin_memory=pin_memory)
    raw = buf.numpy()
    v = {name: raw[a:a + n].view(dt)
         for (name, dt), (a, n) in zip(FLUSH_FIELDS, spans.values())}
    v["req_off"][0] = v["cap_off"][0] = 0
    np.cumsum(ns, out=v["req_off"][1:])
    np.cumsum(es, out=v["cap_off"][1:])
    v["hi_t"][:] = np.inf
    k_max = 1
    for r, i in enumerate(rows):
        job, (cap_t, cap_k) = jobs[i], caps[i]
        if len(cap_t) > 1 and (cap_t[0] < 0 or np.any(np.diff(cap_t) < 0)):
            raise ValueError(f"job {i}: capacity interval starts must ascend from 0")
        a, b = v["req_off"][r], v["req_off"][r + 1]
        v["t"][a:b] = job.trace.t
        v["s"][a:b] = job.model.service_times(job.trace.prompt_tokens,
                                              job.trace.decode_tokens)
        a, b = v["cap_off"][r], v["cap_off"][r + 1]
        v["cap_t"][a:b] = cap_t
        v["cap_k"][a:b] = cap_k
        v["hi_t"][a:b - 1] = cap_t[1:]
        v["kind"][r] = int(len(cap_t) > 1)
        k_max = max(k_max, int(cap_k.max() if len(cap_t) > 1 else cap_k[0]))
        v["horizon"][r] = _job_horizon(job)
        v["slo"][r] = job.slo.latency_target_s
    return buf, spans, k_max


def flush_tensors(buf: torch.Tensor, spans) -> List[torch.Tensor]:
    """``queue_flush``'s table arguments as views of a ``flush_inputs``
    buffer, on the host or copied to the card."""
    return [buf[a:a + n].view(torch.float32) if dt == np.float32 else buf[a:a + n]
            for (_, dt), (a, n) in zip(FLUSH_FIELDS, spans.values())]


def simulate_queue_batch(jobs: Sequence[QueueJob], backend: str = "auto",
                         stats_out: Optional[List[str]] = None,
                         device=None) -> List[QueueMetrics]:
    """Batched FIFO M/G/k(t) simulation over heterogeneous cells.

    Every job is one block of ONE call of ``kernels.queue_core.queue_flush``
    on ``device`` (default the card; ``repro_torch.device.resolve_device``
    raises when there is none): the host builds the flat tables once in one
    page-locked buffer, copies them in with one copy, launches once and
    copies back one [J, 8] result. Constant-capacity cells run the
    Kiefer–Wolfowitz recurrence, piecewise-capacity cells the k(t)-aware
    sorted-slot recurrence, with the metric fold in the same launch (float32:
    metrics agree with the exact paths to golden tolerance, not bitwise). On
    a CUDA device the kernel runs; on the CPU its plain PyTorch version.
    ``backend`` is "auto" (that dispatch) or "numpy", the only way to the
    exact per-cell ``simulate_queue`` paths. Results come back in input
    order; ``stats_out``, when given, receives one impl tag per job
    ("cuda_batched", "torch_batched" or "numpy")."""
    if backend not in ("auto", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    batched = backend != "numpy"
    dev = resolve_device(device) if batched else None
    out: List[Optional[QueueMetrics]] = [None] * len(jobs)
    tags = ["numpy"] * len(jobs)
    caps = _job_caps(jobs) if batched else [None] * len(jobs)
    rows = [i for i, c in enumerate(caps) if c is not None]
    for i, job in enumerate(jobs):
        if caps[i] is None:
            out[i] = simulate_queue(job.trace, job.capacity_events,
                                    job.model, job.slo,
                                    horizon=job.horizon)
    if not rows:
        if stats_out is not None:
            stats_out.extend(tags)
        return out  # type: ignore[return-value]

    t0_wall = time.perf_counter()
    tag = "cuda_batched" if dev.type == "cuda" else "torch_batched"
    buf, spans, k_max = flush_inputs(jobs, rows, caps, pin_memory=dev.type == "cuda")
    res = queue_flush(*flush_tensors(buf.to(dev, non_blocking=True), spans), k_max)
    res = res.cpu().numpy().astype(np.float64)           # [J, FOLD_COLS]
    for r, i in enumerate(rows):
        out[i] = _metrics_from_fold(len(jobs[i].trace), res[r], jobs[i].slo)
        tags[i] = tag
    SIM_COUNTERS["calls"] += len(rows)
    SIM_COUNTERS["requests"] += sum(len(jobs[i].trace) for i in rows)
    SIM_COUNTERS["seconds"] += time.perf_counter() - t0_wall
    SIM_COUNTERS[tag] += len(rows)
    if stats_out is not None:
        stats_out.extend(tags)
    return out  # type: ignore[return-value]


def simulate_queue_many(traces: Sequence[RequestTrace],
                        capacities: Sequence[Sequence[Tuple[float, int]]],
                        model: ServiceTimeModel,
                        slo: SLOConfig,
                        horizon: Optional[float] = None,
                        backend: str = "auto",
                        device=None) -> List[QueueMetrics]:
    """Batched FIFO queue simulation over many grid cells sharing one
    model/slo/horizon — a thin wrapper over ``simulate_queue_batch``."""
    if len(traces) != len(capacities):
        raise ValueError("traces and capacities must align")
    jobs = [QueueJob(tr, ev, model, slo, horizon)
            for tr, ev in zip(traces, capacities)]
    return simulate_queue_batch(jobs, backend=backend, device=device)


# ------------------------------------------------- analytic approximation


def sakasegawa_wait(rate: float, mean_s: float, scv_s: float,
                    k_slots: int, scv_a: float = 1.0) -> float:
    """Allen–Cunneen / Sakasegawa mean-wait approximation for G/G/k.

    Wq ~= (Ca^2 + Cs^2)/2 * rho^(sqrt(2(k+1)) - 1) / (k (1 - rho)) * E[s].
    Returns inf when rho >= 1. The autoscaler inverts this numerically to
    pick the smallest k meeting the latency target.
    """
    if k_slots <= 0:
        return np.inf
    rho = rate * mean_s / k_slots
    if rho >= 1.0:
        return np.inf
    if rho <= 0.0:
        return 0.0
    return ((scv_a + scv_s) / 2.0
            * rho ** (np.sqrt(2.0 * (k_slots + 1)) - 1.0)
            / (k_slots * (1.0 - rho)) * mean_s)


def predicted_percentile_latency(rate: float, mean_s: float, scv_s: float,
                                 p99_service_s: float, k_slots: int,
                                 percentile: float = 99.0,
                                 scv_a: float = 1.0) -> float:
    """Predicted latency percentile: service tail + exponential wait tail.

    With mean wait Wq, the waiting-time tail is approximated exponential, so
    the p-th percentile of wait is -ln(1 - p/100) * Wq (4.6x Wq at p99).
    """
    wq = sakasegawa_wait(rate, mean_s, scv_s, k_slots, scv_a)
    if not np.isfinite(wq):
        return np.inf
    tail = -np.log(max(1e-12, 1.0 - percentile / 100.0))
    return p99_service_s + tail * wq
