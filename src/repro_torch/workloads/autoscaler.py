"""SLO-aware autoscaling: latency targets -> node demand.

The paper's §III-C rule scales on a utilization threshold; it knows nothing
about latency. ``SLOAutoscaler`` replaces it for request-level workloads:
per control window it estimates the arrival rate and the service-time
distribution (from token counts via ``ServiceTimeModel``), then picks the
smallest replica count whose *predicted* latency percentile (Sakasegawa
G/G/k wait + exponential tail) meets the SLO, with square-root-staffing
headroom and scale-down hysteresis so the demand curve doesn't flap.

``RequestWorkload`` packages a trace + model + SLO into the
``WSDemandProvider`` protocol consumed by ``ConsolidationSim`` and
``PhoenixOrchestrator``: planned demand events in, realized latency metrics
out.

The port's own copy of ``repro.workloads.autoscaler`` with the same logic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import SLOConfig
from repro_torch.core.ws_cms import demand_events
from repro_torch.serving.batching import ServiceTimeModel
from repro_torch.workloads.arrivals import RequestTrace
from repro_torch.workloads.queueing import (QueueMetrics,
                                      predicted_percentile_latency,
                                      simulate_queue)


class SLOAutoscaler:
    """Converts a latency SLO into per-window node demand."""

    def __init__(self, model: ServiceTimeModel, slo: SLOConfig, *,
                 window_s: float = 60.0,
                 n_min: int = 1, n_max: int = 10_000,
                 headroom: float = 0.5,
                 scale_down_margin: float = 0.8):
        self.model = model
        self.slo = slo
        self.window_s = window_s
        self.n_min = n_min
        self.n_max = n_max
        # square-root staffing: k_slots >= offered + headroom*sqrt(offered)
        self.headroom = headroom
        # only scale down if the smaller size would still meet the target
        # at `scale_down_margin` of it (hysteresis)
        self.scale_down_margin = scale_down_margin

    # ------------------------------------------------------------ per-window
    def predicted_latency_s(self, rate_rps: float, mean_s: float,
                            scv_s: float, p99_service_s: float,
                            n: int) -> float:
        """Predicted SLO-percentile latency at ``n`` nodes for this load —
        the runtime orchestrator feeds ``target - predicted`` into the
        ``TenantSignals`` latency-headroom channel each control interval."""
        if rate_rps <= 0 or mean_s <= 0:
            return 0.0
        return float(predicted_percentile_latency(
            rate_rps, mean_s, scv_s, p99_service_s,
            max(1, n) * self.model.slots_per_replica, self.slo.percentile))

    def desired_nodes(self, rate_rps: float, mean_s: float, scv_s: float,
                      p99_service_s: float, current: int = 0) -> int:
        """Smallest node count meeting the SLO at the given offered load."""
        slots = self.model.slots_per_replica
        offered = rate_rps * mean_s                       # slots of work
        if offered <= 0:
            return self.n_min
        k_floor = offered + self.headroom * np.sqrt(offered)
        n_base = max(self.n_min, int(np.ceil(k_floor / slots)))
        if p99_service_s >= self.slo.latency_target_s:
            # SLO infeasible at any scale (service alone exceeds the
            # target): provision for near-zero queueing and let the
            # violation rate report the miss
            return min(self.n_max, int(np.ceil(n_base * 1.3)))

        def ok(n: int) -> bool:
            return predicted_percentile_latency(
                rate_rps, mean_s, scv_s, p99_service_s, n * slots,
                self.slo.percentile) <= self.slo.latency_target_s

        # geometric expansion + binary search for the smallest feasible n
        lo, hi = n_base, n_base
        while hi < self.n_max and not ok(hi):
            lo, hi = hi + 1, min(self.n_max, hi * 2)
        while lo < hi:
            mid = (lo + hi) // 2
            if ok(mid):
                hi = mid
            else:
                lo = mid + 1
        n = lo
        if current > n:
            # hysteresis: keep the larger size unless the smaller one has
            # comfortable margin
            lat = predicted_percentile_latency(
                rate_rps, mean_s, scv_s, p99_service_s, n * slots,
                self.slo.percentile)
            if lat > self.scale_down_margin * self.slo.latency_target_s:
                n = min(current, n + 1)
        return n

    # ------------------------------------------------------------ full plan
    def plan(self, trace: RequestTrace, horizon: float) -> np.ndarray:
        """Node demand sampled every window_s over [0, horizon)."""
        n_win = max(1, int(np.ceil(horizon / self.window_s)))
        edges = np.arange(n_win + 1) * self.window_s
        counts, _ = np.histogram(trace.t, bins=edges)
        svc = self.model.service_times(trace.prompt_tokens,
                                       trace.decode_tokens)
        # global service-shape statistics (windows share the token mix);
        # rates vary per window
        mean_s = float(svc.mean()) if len(svc) else 0.0
        var_s = float(svc.var()) if len(svc) else 0.0
        scv_s = var_s / (mean_s ** 2) if mean_s > 0 else 0.0
        p99_s = float(np.percentile(svc, 99)) if len(svc) else 0.0

        out = np.empty(n_win, dtype=np.int64)
        cur = self.n_min
        for w in range(n_win):
            rate = counts[w] / self.window_s
            cur = self.desired_nodes(rate, mean_s, scv_s, p99_s, cur)
            out[w] = cur
        return out

    def plan_events(self, trace: RequestTrace, horizon: float
                    ) -> List[Tuple[float, int]]:
        return demand_events(self.plan(trace, horizon), self.window_s)


@dataclasses.dataclass
class RequestWorkload:
    """WSDemandProvider backed by a request trace + SLO autoscaler.

    This object replaces the raw ``ws_demand`` timeseries: the simulator
    asks it for planned demand events, runs the consolidation policies, and
    hands back the realized WS allocation so request latency can be
    measured against what was actually granted.
    """
    trace: RequestTrace
    model: ServiceTimeModel
    slo: SLOConfig
    autoscaler: Optional[SLOAutoscaler] = None
    horizon: Optional[float] = None
    planned: Optional[List[Tuple[float, int]]] = None

    def __post_init__(self):
        if self.autoscaler is None:
            self.autoscaler = SLOAutoscaler(self.model, self.slo)

    # ------------------------------------------------- WSDemandProvider API
    def demand_events(self, horizon: float) -> List[Tuple[float, int]]:
        if self.planned is None or self.horizon != horizon:
            self.horizon = horizon
            self.planned = self.autoscaler.plan_events(self.trace, horizon)
        return self.planned

    def realized_metrics(self, alloc_events: Sequence[Tuple[float, int]],
                         horizon: Optional[float] = None
                         ) -> Dict[str, float]:
        """Latency under the allocation the cluster actually granted."""
        m = simulate_queue(self.trace, alloc_events, self.model, self.slo,
                           horizon=horizon)
        return m.as_dict()

    def planned_metrics(self, horizon: float) -> Dict[str, float]:
        """Latency if the planned demand were always granted in full."""
        ev = self.demand_events(horizon)
        m = simulate_queue(self.trace, ev, self.model, self.slo,
                           horizon=horizon)
        return m.as_dict()

    def peak_nodes(self, horizon: float) -> int:
        ev = self.demand_events(horizon)
        return max((n for _, n in ev), default=0)
