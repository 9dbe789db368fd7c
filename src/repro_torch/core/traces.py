"""Workload traces (paper §III-B).

The original inputs — SDSC BLUE (2 weeks from 2000-04-25, 144 nodes, 2672
jobs) and the 1998 World Cup HTTP trace (2 weeks from June 7, scaled 2.22x)
— are not redistributable offline. This module provides:

  * ``parse_swf`` — a Standard Workload Format parser, so the real SDSC BLUE
    log drops in unchanged if available;
  * calibrated synthetic generators matching the published summary statistics
    (job count, node count, utilization regime; peak:normal load ratio ~8,
    peak WS demand 64 instances). EXPERIMENTS.md validates the paper's
    *relative* SC-vs-DC claims on these.

All generators are deterministic in `seed`.

The port's own copy of ``repro.core.traces`` with the same logic.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.types import Job
from repro_torch.core.ws_cms import demand_events, demand_from_load

TWO_WEEKS_S = 14 * 24 * 3600.0
SDSC_BLUE_NODES = 144
SDSC_BLUE_JOBS_2W = 2672
WORLDCUP_PEAK_INSTANCES = 64
WS_CAPACITY_RPS = 100.0          # req/s per instance at 100% util


# ------------------------------------------------------------------- SWF


def parse_swf(path: str, *, max_nodes: int = SDSC_BLUE_NODES,
              start: float = 0.0, horizon: float = TWO_WEEKS_S) -> List[Job]:
    """Parse a Standard Workload Format file into Jobs.

    SWF fields: 1 job id, 2 submit, 4 run time, 5 allocated processors.
    Processor counts are mapped to nodes (SDSC BLUE: 8 CPUs/node).
    """
    jobs: List[Job] = []
    cpus_per_node = 8
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            parts = line.split()
            jid, submit = int(parts[0]), float(parts[1])
            runtime = float(parts[3])
            procs = int(parts[4])
            if runtime <= 0 or procs <= 0:
                continue
            t = submit - start
            if t < 0 or t > horizon:
                continue
            size = max(1, math.ceil(procs / cpus_per_node))
            jobs.append(Job(job_id=jid, submit_time=t,
                            size=min(size, max_nodes), runtime=runtime))
    return jobs


# -------------------------------------------------------------- HPC synth


def synthetic_sdsc_blue(seed: int = 0, n_jobs: int = SDSC_BLUE_JOBS_2W,
                        horizon: float = TWO_WEEKS_S,
                        max_nodes: int = SDSC_BLUE_NODES) -> List[Job]:
    """SDSC-BLUE-like synthetic batch trace.

    Calibration targets: `n_jobs` over `horizon`; node-size distribution
    favoring powers of two <= 144; log-normal runtimes with a heavy tail;
    diurnal arrivals. Total demand ~= 60-65% of 144 nodes x 2 weeks, the
    regime in which a 144-node dedicated system is busy but feasible.
    """
    rng = np.random.default_rng(seed)
    # --- arrivals: nonhomogeneous Poisson via thinning over a diurnal rate
    base_rate = n_jobs / horizon
    t, times = 0.0, []
    while len(times) < n_jobs:
        t += rng.exponential(1.0 / (base_rate * 1.8))
        if t >= horizon:
            t = horizon * rng.random()  # wrap: keep exactly n_jobs
        hour = (t / 3600.0) % 24.0
        accept = 0.55 + 0.45 * math.sin((hour - 6.0) / 24.0 * 2 * math.pi)
        if rng.random() < accept:
            times.append(t)
    times = np.sort(np.asarray(times[:n_jobs]))

    # --- sizes: chunky powers of two (4..~96) with jitter, capped. SDSC BLUE
    # allocations were multi-node (8-way SMP nodes); tiny 1-node jobs are
    # rare. Chunky sizes also produce First-Fit fragmentation — idle-but-
    # queued nodes — which is what absorbs most WS +1 ramps without kills.
    exps = rng.uniform(2.0, 6.6, size=n_jobs)
    sizes = np.power(2.0, np.round(exps)).astype(int)
    jitter = rng.random(n_jobs) < 0.25
    sizes[jitter] = np.maximum(
        4, (sizes[jitter] * rng.uniform(0.6, 1.4, jitter.sum())).astype(int))
    sizes = np.minimum(sizes, max_nodes)

    # --- runtimes: log-normal, capped at 36 h
    runtimes = rng.lognormal(mean=math.log(1500.0), sigma=1.25, size=n_jobs)
    runtimes = np.clip(runtimes, 30.0, 36 * 3600.0)

    # --- calibrate total demand to ~101% of the dedicated system: the real
    # SDSC BLUE machine ran saturated with deep queues — SC cannot complete
    # everything in-window, which is what makes the consolidated capacity
    # worth having (paper Fig. 7)
    target = 1.01 * max_nodes * horizon
    scale = target / float(np.sum(sizes * runtimes))
    runtimes = np.clip(runtimes * scale, 30.0, 48 * 3600.0)

    return [Job(job_id=i + 1, submit_time=float(times[i]),
                size=int(sizes[i]), runtime=float(runtimes[i]))
            for i in range(n_jobs)]


# --------------------------------------------------------------- WS synth


def synthetic_worldcup_load(seed: int = 0, horizon: float = TWO_WEEKS_S,
                            dt: float = 20.0) -> Tuple[np.ndarray, float]:
    """World-Cup-98-like request-rate trace (req/s sampled every dt).

    Diurnal base + evening match bursts on match days; peak:normal ~ 8:1.
    Scaled (the paper's 2.22x analog) so the §III-C autoscaler peaks at 64
    instances. Returns (load, dt).
    """
    rng = np.random.default_rng(seed + 1)
    n = int(horizon / dt)
    tt = np.arange(n) * dt
    hours = (tt / 3600.0) % 24.0
    days = (tt / 86400.0).astype(int)

    base = 700.0 * (0.75 + 0.45 * np.sin((hours - 9.0) / 24.0 * 2 * np.pi))
    # a few HUGE match days (the famous peak days) + moderate match days —
    # this is the World-Cup-98 shape: peak:normal ~ 8:1 driven by 2-3 days
    big_days = {3, 10}
    moderate_days = {2, 5, 7, 8, 12}
    burst = np.zeros(n)
    for d, amp in [(d, 5200.0) for d in sorted(big_days)] + \
                  [(d, 1400.0) for d in sorted(moderate_days)]:
        # two matches: ~15:30 and ~20:30 local, 2.5 h each, sharp ramp
        for center in (15.5, 20.5):
            mask = days == d
            x = (hours - center) / 1.25
            burst += np.where(mask, amp * np.exp(-x * x), 0.0)
    noise = rng.normal(1.0, 0.015, n)
    load = np.maximum(20.0, (base + burst) * noise)
    # light EMA (~3 min) — per-20s request rates are already aggregates; the
    # published World Cup curves are smooth at this resolution
    alpha = dt / 180.0
    for i in range(1, n):
        load[i] = (1 - alpha) * load[i - 1] + alpha * load[i]

    # scale so that the autoscaled instance demand peaks at exactly 64.
    # The autoscaler is nonlinear in the scale (its +1/-1 windowed walk),
    # so one rescale is not enough in general: iterate multiplicative
    # corrections, with the exponent damped every few rounds so a 63<->65
    # oscillation cannot cycle forever (the peak is a monotone step
    # function of the scale, so a damped walk settles inside the
    # peak==64 plateau).
    demand = demand_from_load(load, dt, WS_CAPACITY_RPS)
    scale = WORLDCUP_PEAK_INSTANCES / demand.max()
    load = load * scale
    demand = demand_from_load(load, dt, WS_CAPACITY_RPS)
    for i in range(32):
        peak = int(demand.max())
        if peak == WORLDCUP_PEAK_INSTANCES:
            break
        ratio = (WORLDCUP_PEAK_INSTANCES / max(peak, 1)) \
            ** (1.0 / (1 + i // 4))
        load = load * ratio
        demand = demand_from_load(load, dt, WS_CAPACITY_RPS)
    return load, dt


def worldcup_demand_events(seed: int = 0, horizon: float = TWO_WEEKS_S
                           ) -> List[Tuple[float, int]]:
    load, dt = synthetic_worldcup_load(seed, horizon)
    demand = demand_from_load(load, dt, WS_CAPACITY_RPS)
    return demand_events(demand, dt)
