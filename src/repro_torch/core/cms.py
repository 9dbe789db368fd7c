"""Shared CMS protocol base (paper §II).

Every department's cloud-management service — the ST batch scheduler, the WS
replica manager, any future tenant kind — speaks the same three-verb
protocol to the Resource Provision Service:

  * ``grant(n, now)``          — passively receive n nodes;
  * ``force_release(n, now)``  — give up n nodes NOW (urgent reclaim by a
    higher-priority tenant); returns the count actually released;
  * ``node_lost(now)``         — one provisioned node died;
  * ``signals(now, ...)``      — a ``TenantSignals`` snapshot (latency
    headroom, queue depth, preemption cost) for phase-1 reclaim planners;
    the policy layer derives per-interval bids from it (``compute_bid`` /
    ``unit_bid`` in core/policies.py — linear, or slo_elastic where the
    bid rises as the reported latency headroom shrinks, which is why the
    WS proxy headroom is clamped at zero when no real latency feed is
    wired).

``CMSBase`` owns the ``alloc`` bookkeeping and the release skeleton; the
concrete CMS only says how to *make nodes available* (ST: free idle first,
then kill/preempt jobs in the paper's order; WS: replicas are fungible, so
just account the shortfall) and what to do *after* an allocation change
(ST: try to schedule; WS: log the realized-allocation timeline). Keeping the
skeleton here means every tenant kind inherits the same can't-desync
property: ``alloc`` only ever moves inside these verbs, in lockstep with the
provision service's per-tenant record.

The port's own copy of ``repro.core.cms`` with the same logic.
"""
from __future__ import annotations

from repro_torch.core.types import TenantSignals


def proxy_headroom_s(alloc: int, demand: int, target_s: float) -> float:
    """Latency-headroom proxy for a tenant WITHOUT a real latency feed:
    spare replicas scale the SLO target positively; a replica shortfall is
    NOT yet a measured violation, so the proxy clamps at zero (a negative
    prediction would inflate slo_elastic bids while the shortfall is
    already reported through ``queue_depth``/``unmet``). Shared by the
    simulator's WS CMS and the runtime orchestrator so their bids can
    never diverge."""
    surplus = max(0, alloc - demand)
    if target_s <= 0.0:
        return float(surplus)
    return target_s * surplus / max(demand, 1)


class CMSBase:
    """Common grant / force-release / node-lost protocol of a tenant CMS."""

    kind: str = "batch"

    def __init__(self):
        self.alloc = 0                 # nodes currently provisioned to us

    # ------------------------------------------------------------- hooks
    def _before_change(self, now: float):
        """Runs before ``alloc`` moves (accounting cut-off point)."""

    def _make_available(self, n: int, now: float):
        """Ensure n of our nodes hold no work (evict/stop as needed)."""

    def _after_change(self, now: float):
        """Runs after ``alloc`` moved (reschedule, timeline logging)."""

    def demand_nodes(self) -> int:
        """How many nodes this CMS could currently use (declared demand)."""
        return 0

    def signals(self, now: float, name: str = "",
                weight: float = 1.0) -> TenantSignals:
        """Runtime snapshot for reclaim planners (subclasses enrich it with
        headroom / queue depth / preemption cost)."""
        return TenantSignals(name=name, kind=self.kind, alloc=self.alloc,
                             demand=self.demand_nodes(), weight=weight)

    # ---------------------------------------------------------- protocol
    def grant(self, n: int, now: float):
        """Resource Provision Service pushes n nodes (passive receipt)."""
        self._before_change(now)
        self.alloc += n
        self._after_change(now)

    def force_release(self, n: int, now: float) -> int:
        """Forced reclaim of n nodes (provision policy rule 3). Returns the
        number actually released (== n unless alloc < n)."""
        release = min(n, self.alloc)
        if release <= 0:
            return 0
        self._before_change(now)
        self._make_available(release, now)
        self.alloc -= release
        self._after_change(now)
        return release

    def node_lost(self, now: float):
        """A provisioned node died (fault injection / runtime failure).

        The loss goes through the CMS's own bookkeeping — never decrement
        ``alloc`` from outside — so the provision service's per-tenant
        record and this counter cannot diverge.
        """
        if self.alloc <= 0:
            return
        self._before_change(now)
        self._make_available(1, now)
        self.alloc -= 1
        self._after_change(now)
