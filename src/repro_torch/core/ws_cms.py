"""WS CMS — cloud management service for Web services (paper §II/§III-C).

WS Server resource-management policy (verbatim): release idle nodes to the
Resource Provision Service immediately; request more when needed.

The instance autoscaler implements the paper's §III-C rule: with n current
instances, +1 instance if avg CPU utilization > 80% over the past 20 s,
-1 instance if it drops below 80%·(n-1)/n, floor n = 1. ``demand_from_load``
turns a request-rate trace into the instance-demand curve of Fig. 5; the
same rule drives real serving replicas in ``runtime/serving_pool.py``.

The grant / force-release / node-lost protocol lives in ``core/cms.py``;
this class adds the latency-tenant specifics: demand tracking against the
provision service, shortfall accounting, and the realized-allocation log.

The port's own copy of ``repro.core.ws_cms`` with the same logic.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.cms import CMSBase, proxy_headroom_s
from repro_torch.core.types import SimConfig, SLOConfig, TenantSignals

UTIL_WINDOW_S = 20.0
UTIL_UP = 0.80


def demand_from_load(load: np.ndarray, dt: float,
                     capacity_per_instance: float,
                     n0: int = 1, n_max: int = 10_000) -> np.ndarray:
    """Apply the paper's autoscaling rule to a request-rate trace.

    load[t]: requests/s sampled every `dt` seconds. An instance saturates at
    `capacity_per_instance` req/s (util = served_load / (n * capacity)).
    Decisions are taken every UTIL_WINDOW_S using the window-average util.
    Returns the instance-demand curve (same sampling as `load`).
    """
    steps_per_win = max(1, int(round(UTIL_WINDOW_S / dt)))
    n = n0
    out = np.empty(len(load), dtype=np.int64)
    acc, cnt = 0.0, 0
    for i, lam in enumerate(load):
        util = min(lam / (n * capacity_per_instance), 1.5)
        acc += util
        cnt += 1
        if cnt >= steps_per_win:
            avg = acc / cnt
            if avg > UTIL_UP and n < n_max:
                n += 1
            elif n > 1 and avg < UTIL_UP * (n - 1) / n:
                n -= 1
            acc, cnt = 0.0, 0
        out[i] = n
    return out


def resolve_demand_events(ws_demand, horizon: float):
    """Accept either a raw [(t, n), ...] timeseries or a WSDemandProvider.

    Returns (events, provider) — provider is None for plain timeseries.
    """
    if hasattr(ws_demand, "demand_events"):
        return list(ws_demand.demand_events(horizon)), ws_demand
    return list(ws_demand), None


def demand_events(demand: np.ndarray, dt: float) -> List[Tuple[float, int]]:
    """Compress a sampled demand curve into (time, new_level) change events."""
    ev: List[Tuple[float, int]] = [(0.0, int(demand[0]))]
    for i in range(1, len(demand)):
        if demand[i] != demand[i - 1]:
            ev.append((i * dt, int(demand[i])))
    return ev


class WSServer(CMSBase):
    """Tracks instance demand vs allocation; talks to the provision service."""

    kind = "latency"

    def __init__(self, cfg: SimConfig,
                 request: Callable[[int], int],
                 release: Callable[[int], None],
                 slo: Optional[SLOConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.demand = 0
        self._request = request
        self._release = release
        self.slo = slo
        # most recent latency observation (runtime feeds real serving-pool
        # percentiles through observe_latency; the simulator leaves it None
        # and signals() falls back to an allocation-surplus proxy)
        self.observed_latency_s: Optional[float] = None
        # diagnostics
        self.unmet_node_seconds = 0.0
        self.reclaim_events = 0
        self.preempted_nodes = 0       # nodes lost to higher-priority claims
        self._last_t = 0.0
        # realized-allocation change log: (time, alloc) whenever alloc moves.
        # Request-level workloads replay this through the queue simulator to
        # measure the latency the WS department actually experienced.
        self.alloc_events: List[Tuple[float, int]] = [(0.0, 0)]

    def demand_nodes(self) -> int:
        return self.demand

    # -------------------------------------------------------------- signals
    def observe_latency(self, latency_s: float):
        """Feed a measured/predicted latency percentile (runtime path)."""
        self.observed_latency_s = latency_s

    def latency_headroom_s(self) -> float:
        """Seconds of slack to the SLO target. With a real observation this
        is ``target - observed`` (negative = measured violation); otherwise
        the shared zero-clamped surplus proxy (``cms.proxy_headroom_s`` —
        an unclamped negative prediction made slo_elastic bids overshoot;
        the shortfall already drives ``queue_depth``/``unmet``, so it must
        not be double-counted as urgency)."""
        target = self.slo.latency_target_s if self.slo else 0.0
        if self.observed_latency_s is not None:
            return target - self.observed_latency_s
        return proxy_headroom_s(self.alloc, self.demand, target)

    def signals(self, now: float, name: str = "",
                weight: float = 1.0) -> TenantSignals:
        return TenantSignals(
            name=name, kind=self.kind, alloc=self.alloc, demand=self.demand,
            weight=weight,
            latency_headroom_s=self.latency_headroom_s(),
            slo_target_s=self.slo.latency_target_s if self.slo else 0.0,
            queue_depth=max(0, self.demand - self.alloc))

    def _log_alloc(self, now: float):
        if self.alloc_events[-1][1] != self.alloc:
            self.alloc_events.append((now, self.alloc))

    def _account(self, now: float):
        short = max(0, self.demand - self.alloc)
        self.unmet_node_seconds += short * (now - self._last_t)
        self._last_t = now

    # ------------------------------------------- CMS protocol (core/cms.py)
    def _before_change(self, now: float):
        self._account(now)

    def _after_change(self, now: float):
        self._log_alloc(now)

    def force_release(self, n: int, now: float) -> int:
        """A higher-priority tenant preempts n of our nodes. Replicas are
        fungible, so no per-node work is lost beyond the in-flight requests
        the queue simulator will re-run; the shortfall shows up in
        ``unmet_node_seconds`` until demand is next re-claimed."""
        got = super().force_release(n, now)
        self.preempted_nodes += got
        return got

    # ---------------------------------------------------- demand tracking
    def set_demand(self, n: int, now: float):
        self._account(now)
        self.demand = n
        if n > self.alloc:
            need = n - self.alloc
            granted = self._request(need)
            if granted < need:
                pass  # shortfall tracked by _account on the next event
            if granted > 0:
                self.reclaim_events += 1
            self.alloc += granted
        elif n < self.alloc:
            # release idle nodes immediately (paper's WS policy)
            give = self.alloc - n
            self.alloc -= give
            self._release(give)
        self._log_alloc(now)
