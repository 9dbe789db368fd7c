"""Request-arrival processes for the WS department (request-level model).

Four generators cover the evaluation axes of the PhoenixCloud follow-up
(arXiv:1006.1401) and the HPC-cloud taxonomy's hybrid scenarios
(arXiv:1710.08731):

  * ``poisson``      — homogeneous Poisson (the M/G/k baseline);
  * ``mmpp``         — 2-state Markov-modulated Poisson (bursty traffic);
  * ``diurnal``      — nonhomogeneous Poisson with a day/night cycle, the
                       request-level analogue of the World-Cup trace shape;
  * ``flash_crowd``  — diurnal base plus sudden short spikes (the "varying
                       load" case the paper's WS department must survive).

All generators are vectorized numpy and deterministic in ``seed``. Token
counts per request (prompt + decode) come from ``sample_token_counts`` so
service times can be derived via ``serving.batching.ServiceTimeModel``.

The port's own copy of ``repro.workloads.arrivals`` with the same logic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.types import Request

# token-count calibration: long-form generation (decode-dominated), the
# regime where a replica serves ~0.3 req/s/slot and queueing matters.
# Decode lengths are gamma(shape=4) — CV 0.5, p99/mean ~2.5 — so the p99
# *service* time stays under a ~30 s latency target and the SLO is
# feasible; the latency tail then comes from queueing, which is the thing
# the autoscaler controls.
PROMPT_TOK_MEAN = 600.0
PROMPT_TOK_SIGMA = 0.8
DECODE_TOK_MEAN = 1000.0
DECODE_GAMMA_SHAPE = 4.0


@dataclasses.dataclass
class RequestTrace:
    """Columnar request trace: arrays, not objects, so every downstream
    consumer (queue sim, autoscaler windows, campaign reductions) stays
    vectorized."""
    t: np.ndarray               # [N] float64, sorted arrival seconds
    prompt_tokens: np.ndarray   # [N] int64
    decode_tokens: np.ndarray   # [N] int64
    kind: str = "poisson"

    def __len__(self) -> int:
        return len(self.t)

    def to_requests(self) -> List[Request]:
        return [Request(req_id=i, arrival=float(self.t[i]),
                        prompt_tokens=int(self.prompt_tokens[i]),
                        decode_tokens=int(self.decode_tokens[i]))
                for i in range(len(self.t))]

    def rate_in(self, t0: float, t1: float) -> float:
        n = int(np.searchsorted(self.t, t1) - np.searchsorted(self.t, t0))
        return n / max(t1 - t0, 1e-9)


def sample_token_counts(n: int, rng: np.random.Generator,
                        prompt_mean: float = PROMPT_TOK_MEAN,
                        decode_mean: float = DECODE_TOK_MEAN):
    """Log-normal prompts (heavy tail), gamma decode lengths (CV 0.5)."""
    mu = np.log(prompt_mean) - 0.5 * PROMPT_TOK_SIGMA ** 2
    prompt = np.maximum(
        8, rng.lognormal(mu, PROMPT_TOK_SIGMA, n)).astype(np.int64)
    decode = np.maximum(16, rng.gamma(
        DECODE_GAMMA_SHAPE, decode_mean / DECODE_GAMMA_SHAPE, n)
    ).astype(np.int64)
    return prompt, decode


# ------------------------------------------------------------- generators


def poisson_arrivals(rate: float, horizon: float, seed: int = 0
                     ) -> RequestTrace:
    """Homogeneous Poisson at `rate` req/s over [0, horizon)."""
    rng = np.random.default_rng(seed)
    n_est = int(rate * horizon * 1.2) + 64
    gaps = rng.exponential(1.0 / rate, n_est)
    t = np.cumsum(gaps)
    while t[-1] < horizon:                       # rare under-draw
        more = np.cumsum(rng.exponential(1.0 / rate, n_est)) + t[-1]
        t = np.concatenate([t, more])
    t = t[t < horizon]
    prompt, decode = sample_token_counts(len(t), rng)
    return RequestTrace(t, prompt, decode, kind="poisson")


def _thin(t_max_rate: np.ndarray, rate_at, max_rate: float,
          rng: np.random.Generator) -> np.ndarray:
    """Vectorized thinning of a max-rate Poisson stream."""
    keep = rng.random(len(t_max_rate)) < rate_at(t_max_rate) / max_rate
    return t_max_rate[keep]


def diurnal_arrivals(base_rate: float, horizon: float, seed: int = 0,
                     peak_ratio: float = 4.0) -> RequestTrace:
    """Nonhomogeneous Poisson with a sinusoidal day/night cycle.

    Mean rate == base_rate; instantaneous rate swings between
    base_rate * 2/(1 + peak_ratio) and base_rate * 2*peak_ratio/(1+peak_ratio).
    """
    rng = np.random.default_rng(seed)
    amp = (peak_ratio - 1.0) / (peak_ratio + 1.0)

    def rate_at(t):
        hour = (t / 3600.0) % 24.0
        return base_rate * (1.0 + amp * np.sin((hour - 9.0) / 24.0
                                               * 2 * np.pi))

    max_rate = base_rate * (1.0 + amp)
    base = poisson_arrivals(max_rate, horizon, seed)
    t = _thin(base.t, rate_at, max_rate, rng)
    prompt, decode = sample_token_counts(len(t), rng)
    return RequestTrace(t, prompt, decode, kind="diurnal")


def mmpp_arrivals(rate_lo: float, rate_hi: float, horizon: float,
                  seed: int = 0, mean_sojourn_s: float = 600.0
                  ) -> RequestTrace:
    """2-state Markov-modulated Poisson process (bursty arrivals).

    The modulating chain alternates lo/hi states with exponential sojourns
    of mean `mean_sojourn_s`; within a state arrivals are Poisson. Index of
    dispersion > 1 — burstier than Poisson at every timescale above the
    sojourn scale.
    """
    rng = np.random.default_rng(seed)
    # state sojourn boundaries covering the horizon
    n_soj = int(horizon / mean_sojourn_s * 2.5) + 8
    sojourns = rng.exponential(mean_sojourn_s, n_soj)
    bounds = np.concatenate([[0.0], np.cumsum(sojourns)])
    while bounds[-1] < horizon:
        extra = rng.exponential(mean_sojourn_s, n_soj)
        bounds = np.concatenate([bounds, bounds[-1] + np.cumsum(extra)])
    times: List[np.ndarray] = []
    state_hi = bool(rng.integers(0, 2))
    for i in range(len(bounds) - 1):
        t0, t1 = float(bounds[i]), float(min(bounds[i + 1], horizon))
        if t0 >= horizon:
            break
        rate = rate_hi if state_hi else rate_lo
        n = rng.poisson(rate * (t1 - t0))
        if n > 0:
            times.append(np.sort(rng.uniform(t0, t1, n)))
        state_hi = not state_hi
    t = np.sort(np.concatenate(times)) if times else np.empty(0)
    prompt, decode = sample_token_counts(len(t), rng)
    return RequestTrace(t, prompt, decode, kind="mmpp")


def flash_crowd_arrivals(base_rate: float, horizon: float, seed: int = 0,
                         spike_ratio: float = 6.0,
                         n_spikes: int = 2,
                         spike_duration_s: float = 900.0) -> RequestTrace:
    """Diurnal base + `n_spikes` sudden flash crowds at `spike_ratio` x base.

    Spike start times are seeded-deterministic, placed away from the horizon
    edges so the ramp and drain are both inside the window.
    """
    rng = np.random.default_rng(seed + 7)
    base = diurnal_arrivals(base_rate, horizon, seed, peak_ratio=3.0)
    lo = 0.1 * horizon
    # short horizons: numpy draws from an inverted interval without error,
    # which would place spikes before t=0 — clamp so lo <= hi always
    hi = max(lo, 0.9 * horizon - spike_duration_s)
    starts = np.sort(rng.uniform(lo, hi, n_spikes))
    extra: List[np.ndarray] = []
    for s0 in starts:
        n = rng.poisson(base_rate * (spike_ratio - 1.0) * spike_duration_s)
        if n > 0:
            # sharp onset, exponential tail-off inside the spike window
            offs = rng.exponential(spike_duration_s / 3.0, n)
            offs = offs[offs < spike_duration_s]
            extra.append(s0 + offs)
    t = np.sort(np.concatenate([base.t] + extra)) if extra else base.t
    t = t[t < horizon]
    prompt, decode = sample_token_counts(len(t), rng)
    return RequestTrace(t, prompt, decode, kind="flash_crowd")


GENERATORS = {
    "poisson": lambda rate, horizon, seed: poisson_arrivals(
        rate, horizon, seed),
    # lo/hi chosen so the stationary mean (equal sojourns) equals `rate`
    "mmpp": lambda rate, horizon, seed: mmpp_arrivals(
        0.4 * rate, 1.6 * rate, horizon, seed),
    "diurnal": lambda rate, horizon, seed: diurnal_arrivals(
        rate, horizon, seed),
    "flash_crowd": lambda rate, horizon, seed: flash_crowd_arrivals(
        rate, horizon, seed),
}


def make_trace(kind: str, rate: float, horizon: float, seed: int = 0
               ) -> RequestTrace:
    """Uniform entry point: mean rate `rate` req/s, process shape `kind`."""
    if kind not in GENERATORS:
        raise ValueError(f"unknown arrival process {kind!r}; "
                         f"have {sorted(GENERATORS)}")
    return GENERATORS[kind](rate, horizon, seed)


def burstiness_index(trace: RequestTrace, window_s: float = 60.0) -> float:
    """Index of dispersion of counts: Var(N_w)/E(N_w) over fixed windows.

    == 1 for Poisson, > 1 for MMPP / flash crowds. Used by tests to verify
    the generators actually produce the burstiness they claim.
    """
    if len(trace) == 0:
        return 0.0
    horizon = float(trace.t[-1]) + 1e-9
    edges = np.arange(0.0, horizon + window_s, window_s)
    counts, _ = np.histogram(trace.t, bins=edges)
    m = counts.mean()
    return float(counts.var() / m) if m > 0 else 0.0
