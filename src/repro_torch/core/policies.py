"""Two-phase cooperative policy engines for the N-department tenancy
framework.

The 2009 paper hard-codes one policy triple for exactly two departments:

  * WS demands have higher priority than ST demands;
  * ALL idle resources are provisioned to ST;
  * an urgent WS claim forcibly reclaims from ST.

``TenantProvisionService`` (core/provision.py) generalizes the state machine
to N registered tenants; THIS module supplies the :class:`PolicyEngine`
objects that decide the two halves of every provisioning action:

  * **phase 1 — reclaim planning** (``plan_reclaim``): given a node
    deficit, produce an *ordered reclaim plan* — which victims to drain,
    in what order, with what per-victim cap — from per-tenant runtime
    signals (:class:`~repro.core.types.TenantSignals`: latency headroom vs
    SLO, queue depth, preemption cost, declared weight/bid);
  * **phase 2 — idle distribution** (``idle_grants``): how freed/idle
    nodes flow back to batch-class tenants.

The paper's verbatim behaviour is the ``"paper"`` engine (its plan is the
fixed reverse-priority chain, its idle rule dumps everything on the top
batch tenant — bit-for-bit the seed semantics). ``demand_capped`` and
``proportional_share`` are phase-2-only variants sharing the same default
planner. Beyond them, ``slo_headroom`` plans reclaims from the latency
tenant furthest under its SLO target first and batch tenants by cheapest
preemption, and ``auction`` derives per-interval bids (weight x unmet
demand) whose clearing price decides both reclaim order and idle
distribution. ``budget_auction`` and ``second_price`` turn the auction
into a real market: tenants spend a finite ``budget`` over the horizon
(ledger in :class:`~repro.core.types.MarketState`), bids can be
SLO-elastic (rising as latency headroom shrinks), idle nodes clear at the
lowest winning (first-price) or highest losing (Vickrey) per-node bid,
and a broke tenant falls back to its floor (arXiv:1006.1401 frames
provisioning policies as exactly this resource-economy design space;
arXiv:1004.1276 motivates per-community budgets over multi-community
mixes).

An engine never mutates service state itself: it returns grant/reclaim
plans and the service applies them, so every engine inherits the same
conservation invariants — including the floor guarantee: a plan never asks
for nodes below a victim's declared ``floor``.

The port's own copy of ``repro.core.policies`` with the same logic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.telemetry import NULL_TRACER
from repro_torch.core.types import MarketState, TenantSignals

# per-engine cap on retained clearing-price / plan samples (aggregates are
# exact; samples are for inspection and the campaign artifact)
STATE_SAMPLES_MAX = 64
# slo_elastic bids scale between 1x (full latency headroom) and this cap
# (deep SLO violation); 2x corresponds to exactly-zero headroom
ELASTIC_BID_MAX = 4.0


@dataclasses.dataclass
class Tenant:
    """Runtime per-tenant record held by the provision service registry."""
    name: str
    kind: str                  # "latency" | "batch"
    priority: int              # lower number = higher priority
    alloc: int = 0
    # batch tenants: how many nodes they could still use (queue demand);
    # latency tenants: their current target demand
    demand: int = 0
    # proportional-share policies: relative share of idle capacity
    weight: float = 1.0
    # forced reclaim never takes this tenant below `floor` nodes
    floor: int = 0
    # auction engines: bid = bid_weight x unmet demand (None -> weight)
    bid_weight: Optional[float] = None
    # market engines: tokens spendable across the run (None = unlimited)
    budget: Optional[float] = None
    # "linear" | "slo_elastic" (bid rises as latency headroom shrinks)
    bid_policy: str = "linear"
    # batch tenants: called to release n nodes (kill/preempt); returns freed.
    # A batch tenant WITHOUT a release hook is not forcibly reclaimable
    # (matches the paper service, which skips reclaim when unwired).
    on_force_release: Optional[Callable[[int], int]] = None
    # called when nodes are granted
    on_grant: Optional[Callable[[int], None]] = None
    # runtime signal source (CMS / orchestrator); None -> derived snapshot
    signals: Optional[Callable[[], TenantSignals]] = None


def tenant_signals(t: Tenant) -> TenantSignals:
    """Resolve a tenant's runtime signals, falling back to a snapshot
    derived from the registry record when no CMS source is wired."""
    if t.signals is not None:
        s = t.signals()
        if s is not None:
            s.bid = compute_bid(t, s)
            return s
    s = TenantSignals(name=t.name, kind=t.kind, alloc=t.alloc,
                      demand=t.demand, weight=t.weight)
    s.bid = compute_bid(t, s)
    return s


def bid_elasticity(t: Tenant, s: Optional[TenantSignals]) -> float:
    """``slo_elastic`` multiplier: 1x at full latency headroom, 2x at zero
    headroom, up to ``ELASTIC_BID_MAX`` in deep violation. ``linear``
    tenants (and tenants without an SLO target) always get 1x."""
    if getattr(t, "bid_policy", "linear") != "slo_elastic" or s is None:
        return 1.0
    target = s.slo_target_s
    if target <= 0.0:
        return 1.0
    urgency = (target - s.latency_headroom_s) / target
    return 1.0 + min(max(urgency, 0.0), ELASTIC_BID_MAX - 1.0)


def compute_bid(t: Tenant, s: Optional[TenantSignals] = None) -> float:
    """Per-interval bid: bid_weight (default weight) x unmet demand,
    scaled by the ``slo_elastic`` urgency factor when the tenant opted in."""
    unmet = s.unmet if s is not None else max(0, t.demand - t.alloc)
    w = t.bid_weight if t.bid_weight is not None else t.weight
    return max(0.0, float(w)) * bid_elasticity(t, s) * float(unmet)


def unit_bid(t: Tenant, s: Optional[TenantSignals] = None) -> float:
    """Per-NODE bid price (the market engines' money unit): bid_weight
    (default weight) x the slo_elastic urgency factor. ``compute_bid`` is
    this price times unmet demand."""
    w = t.bid_weight if t.bid_weight is not None else t.weight
    return max(0.0, float(w)) * bid_elasticity(t, s)


@dataclasses.dataclass(frozen=True)
class ReclaimStep:
    """One entry of a reclaim plan: drain up to ``take`` nodes from
    ``victim`` (the service caps the actual take at the live deficit and
    allocation when it applies the plan)."""
    victim: str
    take: int
    reason: str = ""


class PolicyEngine:
    """Base two-phase engine: reclaim planning + idle distribution.

    ``plan_reclaim`` (phase 1) returns the ordered ``ReclaimStep`` list an
    urgent claim may drain; the default planner walks the legacy
    ``victim_order`` chain, capping each step at what the victim can give
    up without crossing its ``floor``. The plan covers EVERY eligible
    victim (not just enough to cover the deficit): a victim may release
    fewer nodes than asked, and the service must be able to continue down
    the chain exactly like the paper's loop did.

    ``idle_grants`` (phase 2) returns ``[(tenant, n), ...]`` for the
    service to apply. ``demand_driven`` tells callers (the simulator)
    whether batch demand must be kept up to date and surplus idle
    allocation voluntarily returned — the paper's engine ignores demand
    entirely, so the simulator skips that bookkeeping for it.

    Engines carry per-run state: how many plans were made, which victims
    were actually drained (reported back by the service via
    ``note_reclaimed``) and, for stateful engines like ``auction``,
    per-interval clearing prices. ``state_snapshot()`` serializes it for
    results/artifacts.
    """

    name = "base"
    demand_driven = True
    # demand-driven engines normally guarantee that nodes only sit free
    # once every batch tenant's declared demand is covered; budget engines
    # cannot (a broke tenant may be unable to BUY coverage), so they unset
    # this and the service relaxes the corresponding invariant check
    demand_satiating = True
    stateful = False

    def __init__(self):
        self.reclaim_plans = 0
        self.victim_counts: Dict[str, int] = {}
        self.victim_nodes: Dict[str, int] = {}
        self.last_plan: List[str] = []
        self.plan_samples: List[List[str]] = []
        # plans beyond the sample cap (aggregates above stay exact); kept
        # as an attribute so capped sample lists are distinguishable from
        # short runs without changing the serialized snapshot
        self.plan_samples_dropped = 0
        # telemetry sink; the provision service swaps in its live Tracer
        # at wiring time (core/telemetry.py) — NULL_TRACER costs a branch
        self.tracer = NULL_TRACER

    # ------------------------------------------------------------- phase 1
    def plan_reclaim(self, deficit: int, tenants: Sequence[Tenant],
                     claimant: Tenant) -> List[ReclaimStep]:
        plan = [ReclaimStep(v.name, self.reclaimable(v), "victim-chain")
                for v in self.victim_order(tenants, claimant)
                if self.reclaimable(v) > 0]
        self._note_plan(plan)
        return plan

    def victim_order(self, tenants: Sequence[Tenant], claimant: Tenant
                     ) -> List[Tenant]:
        """Paper rule 3 generalized: batch tenants in REVERSE priority order
        (cheapest victim first), then lower-priority latency tenants."""
        batch = sorted((t for t in tenants if t.kind == "batch"),
                       key=lambda t: t.priority, reverse=True)
        latency = sorted(
            (t for t in tenants
             if t.kind == "latency" and t.name != claimant.name
             and t.priority > claimant.priority),
            key=lambda t: t.priority, reverse=True)
        return batch + latency

    @staticmethod
    def reclaimable(v: Tenant) -> int:
        """Nodes a plan may ask this victim for: never below its floor."""
        return max(0, v.alloc - max(0, v.floor))

    @staticmethod
    def eligible_victims(tenants: Sequence[Tenant], claimant: Tenant
                         ) -> Tuple[List[Tenant], List[Tenant]]:
        """(batch, latency) victims an urgent claim may legally drain:
        every batch tenant, and latency tenants strictly below the
        claimant's priority class (a lower-priority latency department can
        never preempt a higher-priority one)."""
        batch = [t for t in tenants if t.kind == "batch"]
        latency = [t for t in tenants
                   if t.kind == "latency" and t.name != claimant.name
                   and t.priority > claimant.priority]
        return batch, latency

    # ----------------------------------------------------------- bookkeeping
    def _note_plan(self, plan: List[ReclaimStep]):
        self.reclaim_plans += 1
        self.last_plan = [s.victim for s in plan]
        if len(self.plan_samples) < STATE_SAMPLES_MAX:
            self.plan_samples.append(self.last_plan)
        else:
            self.plan_samples_dropped += 1

    def reclaim_cap(self, victim: Tenant, take: int, claimant: Tenant
                    ) -> int:
        """Apply-time cap on one plan step (called by the service with the
        live ``take`` right before the victim's release hook runs). The
        default engine imposes nothing extra; budget engines cap at what
        the claimant can still afford at this victim's price."""
        return take

    def note_reclaimed(self, victim: str, n: int,
                       granted: Optional[int] = None):
        """The service reports nodes actually taken from a plan victim.

        ``n`` is the victim's full release (drain statistics); ``granted``
        is how many of them the claimant actually received — a victim may
        over-release (e.g. a trainer shrinking by whole DP groups), and
        the surplus flows back to the free pool, so money engines must
        charge on ``granted``, never ``n``. Defaults to ``n``."""
        if n <= 0:
            return
        self.victim_counts[victim] = self.victim_counts.get(victim, 0) + 1
        self.victim_nodes[victim] = self.victim_nodes.get(victim, 0) + n

    def state_snapshot(self) -> Dict:
        """JSON-safe per-run engine state for results and artifacts."""
        return {
            "engine": self.name,
            "reclaim_plans": self.reclaim_plans,
            "victim_counts": dict(self.victim_counts),
            "victim_nodes": dict(self.victim_nodes),
            "last_plan": list(self.last_plan),
        }

    # ------------------------------------------------------------- phase 2
    def idle_grants(self, free: int, batch: Sequence[Tenant]
                    ) -> List[Tuple[Tenant, int]]:
        raise NotImplementedError

    @staticmethod
    def _fill_demand(free: int, batch: Sequence[Tenant]) -> Dict[str, int]:
        """Priority-ordered fill of unmet demand, capped at ``free``."""
        grants: Dict[str, int] = {}
        for t in batch:
            if free <= 0:
                break
            give = min(max(0, t.demand - t.alloc), free)
            if give > 0:
                grants[t.name] = grants.get(t.name, 0) + give
                free -= give
        return grants


# back-compat alias: the pre-engine name for the policy base class
CooperativePolicy = PolicyEngine


class PaperPolicy(PolicyEngine):
    """The paper's verbatim configuration: WS preempts, ALL idle to ST.

    Phase 1 is the default reverse-priority victim chain; phase 2 first
    covers declared batch demand in priority order (a no-op in the paper's
    two-tenant wiring, where demand is never declared), then EVERYTHING
    left is dumped on the highest-priority batch tenant whether it asked
    or not."""

    name = "paper"
    demand_driven = False

    def idle_grants(self, free, batch):
        grants = self._fill_demand(free, batch)
        leftover = free - sum(grants.values())
        if leftover > 0 and batch:
            top = batch[0].name
            grants[top] = grants.get(top, 0) + leftover
        return [(t, grants[t.name]) for t in batch if grants.get(t.name)]


class DemandCappedIdlePolicy(PolicyEngine):
    """Idle flows to batch tenants by priority but stops at declared demand;
    the remainder stays free (cheap to claim later — no kills)."""

    name = "demand_capped"

    def idle_grants(self, free, batch):
        grants = self._fill_demand(free, batch)
        return [(t, grants[t.name]) for t in batch if grants.get(t.name)]


class ProportionalSharePolicy(PolicyEngine):
    """Idle is split across batch tenants with unmet demand in proportion to
    their ``weight`` (water-filling: a tenant whose demand saturates early
    frees its share for the others). Leftover beyond total demand stays
    free."""

    name = "proportional_share"

    def idle_grants(self, free, batch):
        want = {t.name: max(0, t.demand - t.alloc) for t in batch}
        grants = {t.name: 0 for t in batch}
        remaining = free
        while remaining > 0:
            active = [t for t in batch if want[t.name] > 0]
            if not active:
                break
            weights = {t.name: max(t.weight, 0.0) for t in active}
            wsum = sum(weights.values())
            if wsum <= 0:
                weights = {t.name: 1.0 for t in active}
                wsum = float(len(active))
            granted_round = 0
            for t in active:
                share = min(want[t.name],
                            int(remaining * weights[t.name] / wsum))
                if share > 0:
                    grants[t.name] += share
                    want[t.name] -= share
                    granted_round += share
            if granted_round == 0:
                # integer floors all rounded to zero: hand out single nodes
                # in priority order so the loop always makes progress
                for t in active:
                    if granted_round >= remaining:
                        break
                    grants[t.name] += 1
                    want[t.name] -= 1
                    granted_round += 1
            remaining -= granted_round
        return [(t, grants[t.name]) for t in batch if grants.get(t.name)]


class SLOHeadroomEngine(PolicyEngine):
    """SLO-aware reclaim planning over runtime signals (ROADMAP item).

    Phase-1 plan, three bands:

      1. latency victims' *surplus* replicas (allocation above demand),
         the tenant with the most latency headroom first — draining them
         costs nothing while their SLO is comfortably met;
      2. batch tenants by cheapest preemption (idle-absorbing or
         just-started jobs before long-running ones), ties by reverse
         priority;
      3. latency victims below their demand (down to their floor, never
         further), again most-headroom-first — the last resort, ordered so
         the department with the most slack to its SLO target absorbs the
         violation risk.

    Phase 2 is demand-capped (idle stays free beyond declared demand, so
    future claims are cheap)."""

    name = "slo_headroom"

    def plan_reclaim(self, deficit, tenants, claimant):
        batch, latency = self.eligible_victims(tenants, claimant)
        sig = {t.name: tenant_signals(t) for t in tenants}
        plan: List[ReclaimStep] = []
        # band 1: free surplus above demand, most headroom first (demand
        # comes from the CMS signal — latency demand is not mirrored on the
        # registry record, which only tracks batch demand). The WS proxy
        # headroom clamps at zero, so replica-short tenants tie with
        # exactly-met ones; the RELATIVE-shortfall tiebreak (shortfall as a
        # fraction of demand — the quantity the pre-clamp proxy scaled by)
        # keeps the most relatively starved department drained LAST in
        # band 3, preserving the pre-clamp protection order.
        def shortfall_frac(t):
            s = sig[t.name]
            return s.queue_depth / max(s.demand, 1)

        by_headroom = sorted(
            latency, key=lambda t: (-sig[t.name].latency_headroom_s,
                                    shortfall_frac(t),
                                    -t.priority))
        surplus_taken: Dict[str, int] = {}
        for v in by_headroom:
            surplus = min(self.reclaimable(v),
                          max(0, v.alloc - max(sig[v.name].demand, v.floor)))
            if surplus > 0:
                surplus_taken[v.name] = surplus
                plan.append(ReclaimStep(
                    v.name, surplus,
                    f"surplus headroom={sig[v.name].latency_headroom_s:.1f}s"))
        # band 2: batch by cheapest preemption
        for v in sorted(batch,
                        key=lambda t: (sig[t.name].preemption_cost_s,
                                       -t.priority)):
            take = self.reclaimable(v)
            if take > 0:
                plan.append(ReclaimStep(
                    v.name, take,
                    f"preempt cost={sig[v.name].preemption_cost_s:.1f}s"))
        # band 3: dig into latency demand down to the floor
        for v in by_headroom:
            take = self.reclaimable(v) - surplus_taken.get(v.name, 0)
            if take > 0:
                plan.append(ReclaimStep(
                    v.name, take,
                    f"drain headroom={sig[v.name].latency_headroom_s:.1f}s"))
        self._note_plan(plan)
        return plan

    def idle_grants(self, free, batch):
        grants = self._fill_demand(free, batch)
        return [(t, grants[t.name]) for t in batch if grants.get(t.name)]


class AuctionEngine(PolicyEngine):
    """Market-style engine: per-interval bids clear both phases.

    Every decision interval each tenant's bid is ``bid_weight x unmet
    demand`` (recomputed from live signals, so bids track load). Phase 2
    sells idle nodes to batch tenants in descending-bid order, capped at
    demand; the *clearing price* is the lowest winning bid and is recorded
    per interval in the engine state. Phase 1 drains victims in
    ASCENDING-bid order (the tenant that values marginal nodes least sells
    first) — batch victims before latency victims, so the market reorders
    the paper's chain without letting a cheap bid strip a latency
    department of replicas while batch capacity remains — still respecting
    priority-class eligibility and floors, and records the marginal
    (clearing) bid of each plan."""

    name = "auction"
    stateful = True

    def __init__(self):
        super().__init__()
        self.intervals = 0
        self.price_sum = 0.0
        self.price_max = 0.0
        self.price_samples: List[float] = []
        self.price_samples_dropped = 0
        self.last_bids: Dict[str, float] = {}
        self.last_clearing_price: Optional[float] = None
        self.reclaim_price_sum = 0.0
        self.reclaim_price_n = 0

    def _record_price(self, price: float):
        self.intervals += 1
        self.price_sum += price
        self.price_max = max(self.price_max, price)
        self.last_clearing_price = price
        if len(self.price_samples) < STATE_SAMPLES_MAX:
            self.price_samples.append(price)
        else:
            self.price_samples_dropped += 1
        if self.tracer.enabled:
            self.tracer.emit("auction_clear", price=float(price),
                             interval=self.intervals, engine=self.name)

    def _note_reclaim_price(self, plan: List[ReclaimStep],
                            prices: Dict[str, float], deficit: int):
        """Record the claim's clearing price: the marginal victim bid
        needed to cover the deficit (0 when the chain cannot cover it)."""
        need, price = deficit, 0.0
        for step in plan:
            if need <= 0:
                break
            price = prices[step.victim]
            need -= step.take
        if need > 0:
            price = 0.0          # chain cannot cover the deficit: no clear
        self.reclaim_price_sum += price
        self.reclaim_price_n += 1

    def plan_reclaim(self, deficit, tenants, claimant):
        batch, latency = self.eligible_victims(tenants, claimant)
        bids = {t.name: tenant_signals(t).bid for t in tenants}
        self.last_bids = dict(bids)
        victims = sorted(
            batch + latency,
            key=lambda t: (0 if t.kind == "batch" else 1, bids[t.name],
                           -t.priority))
        plan = [ReclaimStep(v.name, self.reclaimable(v),
                            f"bid={bids[v.name]:.2f}")
                for v in victims if self.reclaimable(v) > 0]
        self._note_reclaim_price(plan, bids, deficit)
        self._note_plan(plan)
        return plan

    def idle_grants(self, free, batch):
        bids = {t.name: tenant_signals(t).bid for t in batch}
        self.last_bids.update(bids)
        order = sorted(batch, key=lambda t: (-bids[t.name], t.priority))
        grants: Dict[str, int] = {}
        price = 0.0
        remaining = free
        for t in order:
            if remaining <= 0:
                break
            give = min(max(0, t.demand - t.alloc), remaining)
            if give > 0:
                grants[t.name] = give
                remaining -= give
                price = bids[t.name]          # lowest winning bid so far
        if grants:
            self._record_price(price)
        return [(t, grants[t.name]) for t in batch if grants.get(t.name)]

    def state_snapshot(self) -> Dict:
        out = super().state_snapshot()
        out.update({
            "intervals": self.intervals,
            "clearing_price_mean":
                self.price_sum / self.intervals if self.intervals else 0.0,
            "clearing_price_max": self.price_max,
            "clearing_price_samples": list(self.price_samples),
            "reclaim_price_mean":
                self.reclaim_price_sum / self.reclaim_price_n
                if self.reclaim_price_n else 0.0,
            "last_bids": dict(self.last_bids),
        })
        return out


class BudgetAuctionEngine(AuctionEngine):
    """Budget-constrained market engine, first-price clearing (the ROADMAP
    market item: budgets spendable over time + SLO-elastic bids).

    Every tenant starts with ``budget`` tokens (None = unlimited), held in
    a :class:`~repro.core.types.MarketState` that the engine threads
    through both phases and serializes into ``policy_state["market"]``.
    Bids are per-NODE prices: ``bid_weight`` (default ``weight``), scaled
    by the ``slo_elastic`` urgency factor when the tenant opted in.

    Phase 2 sells idle nodes per interval: highest per-node bidders first,
    each capped at unmet demand AND at what it can afford at its own bid;
    every winner pays the interval's *clearing price* per node — the
    lowest winning bid (the winning side's "first price") — debited from
    its budget. A broke tenant wins nothing and erodes toward its floor.

    Phase 1 (urgent claims) drains victims in ascending per-node-bid
    order, batch before latency, floors respected; the claimant pays each
    victim's per-node bid for every node it RECEIVES beyond its own floor
    entitlement (nodes up to ``floor`` are a free guarantee — a broke
    claimant "falls back to its floor"; an over-releasing victim's
    surplus reflows to the free pool unpaid and is sold there instead).
    The plan lists every victim at its full floor-capped take — the same
    under-release resilience as the plain auction — and affordability is
    enforced exactly at APPLY time: the service asks ``reclaim_cap`` for
    each step's allowance against the claimant's LIVE remaining budget,
    and the debit lands in ``note_reclaimed`` at the same price, so
    budgets can never be overspent and a victim that refuses to release
    never starves affordable victims later in the plan.
    """

    name = "budget_auction"
    demand_satiating = False

    def __init__(self):
        super().__init__()
        self.market = MarketState()
        self.last_unit_bids: Dict[str, float] = {}
        # pending-claim charge book: per-victim per-node prices + the
        # claimant's free floor quota, consumed by reclaim_cap /
        # note_reclaimed as the service applies the plan step by step
        self._claimant: Optional[str] = None
        self._claim_prices: Dict[str, float] = {}
        self._claim_free_left = 0

    def _sync_market(self, tenants: Sequence[Tenant]):
        for t in tenants:
            self.market.register(t.name, getattr(t, "budget", None))

    def _record_price(self, price: float):
        super()._record_price(price)
        self.market.note_price(price)

    # ------------------------------------------------------------- phase 1
    def plan_reclaim(self, deficit, tenants, claimant):
        self._sync_market(tenants)
        batch, latency = self.eligible_victims(tenants, claimant)
        sig = {t.name: tenant_signals(t) for t in tenants}
        prices = {t.name: unit_bid(t, sig[t.name]) for t in tenants}
        self.last_bids = {n: s.bid for n, s in sig.items()}
        self.last_unit_bids.update(prices)
        victims = sorted(
            batch + latency,
            key=lambda t: (0 if t.kind == "batch" else 1, prices[t.name],
                           -t.priority))
        plan = [ReclaimStep(v.name, self.reclaimable(v),
                            f"price={prices[v.name]:.2f}")
                for v in victims if self.reclaimable(v) > 0]
        # open the claim's charge book: nodes up to the claimant's floor
        # are free; everything further is capped and debited at apply time
        self._claimant = claimant.name
        self._claim_prices = {s.victim: prices[s.victim] for s in plan}
        self._claim_free_left = max(0, claimant.floor - claimant.alloc)
        self._note_reclaim_price(plan, prices, deficit)
        self._note_plan(plan)
        return plan

    def reclaim_cap(self, victim, take, claimant):
        """Live affordability cap for one plan step: the claimant's free
        floor quota plus what its remaining budget buys at this victim's
        per-node price (previous steps' debits already reflected)."""
        if self._claimant != claimant.name or \
                victim.name not in self._claim_prices:
            return take
        price = self._claim_prices[victim.name]
        can_pay = self.market.affordable_nodes(claimant.name, price)
        return min(take, self._claim_free_left + can_pay)

    def note_reclaimed(self, victim: str, n: int,
                       granted: Optional[int] = None):
        super().note_reclaimed(victim, n, granted)
        granted = n if granted is None else granted
        if granted <= 0 or self._claimant is None or \
                victim not in self._claim_prices:
            return
        # free floor-entitled nodes first (apply order == plan order),
        # then charge the claimant at this victim's per-node bid — only
        # for nodes it actually received (an over-releasing victim's
        # surplus reflows to the free pool and is sold there, not here)
        free_used = min(self._claim_free_left, granted)
        self._claim_free_left -= free_used
        paid = granted - free_used
        if paid > 0:
            price = self._claim_prices[victim]
            # a victim over-releasing past the reclaim_cap (DP-group
            # rounding) can hand the claimant more than it can afford;
            # the debit clamps at the live budget so it can never go
            # negative — the bounded excess rides free
            paid = min(paid, self.market.affordable_nodes(
                self._claimant, price))
            if paid > 0:
                self.market.debit(self._claimant, paid, price, "reclaim",
                                  self.intervals)

    # ------------------------------------------------------------- phase 2
    def _clearing_price(self, winner_prices: List[float],
                        loser_prices: List[float]) -> float:
        """First-price clearing: the lowest winning per-node bid."""
        return min(winner_prices) if winner_prices else 0.0

    def idle_grants(self, free, batch):
        self._sync_market(batch)
        sig = {t.name: tenant_signals(t) for t in batch}
        prices = {t.name: unit_bid(t, sig[t.name]) for t in batch}
        self.last_bids.update({n: s.bid for n, s in sig.items()})
        self.last_unit_bids.update(prices)
        order = sorted(batch, key=lambda t: (-prices[t.name], t.priority))
        grants: Dict[str, int] = {}
        winner_prices: List[float] = []
        loser_prices: List[float] = []
        remaining = free
        for t in order:
            want = max(0, t.demand - t.alloc)
            if want <= 0:
                continue
            # affordability is judged at the tenant's own bid; the actual
            # debit happens at the clearing price, which never exceeds it
            can_pay = self.market.affordable_nodes(t.name, prices[t.name])
            give = min(want, can_pay, remaining)
            if give > 0:
                grants[t.name] = give
                winner_prices.append(prices[t.name])
                remaining -= give
            if give < min(want, can_pay):
                loser_prices.append(prices[t.name])
        if grants:
            price = self._clearing_price(winner_prices, loser_prices)
            self._record_price(price)
            for name, n in grants.items():
                self.market.debit(name, n, price, "idle", self.intervals)
        return [(t, grants[t.name]) for t in batch if grants.get(t.name)]

    def state_snapshot(self) -> Dict:
        out = super().state_snapshot()
        out["market"] = self.market.snapshot()
        out["last_unit_bids"] = dict(self.last_unit_bids)
        return out


class SecondPriceEngine(BudgetAuctionEngine):
    """Vickrey variant of :class:`BudgetAuctionEngine`: idle winners pay
    the highest LOSING per-node bid (0 when every bidder is fully served).

    Truthful ``bid_weight``s become dominant for the idle sale: a fully
    served winner's payment is set by the best rejected bid, not its own,
    so inflating a bid can only change *whether* it wins, never what it
    pays — pinned by the golden tests. Second-price payments are ≤
    first-price payments on identical bids (property-tested): the highest
    losing bid can never exceed the lowest winning one. The reclaim side
    (budgets, floor entitlements, victim pricing) is inherited unchanged.
    """

    name = "second_price"

    def _clearing_price(self, winner_prices, loser_prices):
        return max(loser_prices) if loser_prices else 0.0


POLICIES: Dict[str, Callable[[], PolicyEngine]] = {
    PaperPolicy.name: PaperPolicy,
    DemandCappedIdlePolicy.name: DemandCappedIdlePolicy,
    ProportionalSharePolicy.name: ProportionalSharePolicy,
    SLOHeadroomEngine.name: SLOHeadroomEngine,
    AuctionEngine.name: AuctionEngine,
    BudgetAuctionEngine.name: BudgetAuctionEngine,
    SecondPriceEngine.name: SecondPriceEngine,
}
# alias: the registry IS the engine registry
ENGINES = POLICIES


def get_policy(policy) -> PolicyEngine:
    """Resolve an engine name, class or instance to a PolicyEngine."""
    if isinstance(policy, PolicyEngine):
        return policy
    if isinstance(policy, type) and issubclass(policy, PolicyEngine):
        return policy()
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown cooperative policy {policy!r}; "
            f"have {sorted(POLICIES)}") from None


# alias kept so call sites can say what they mean
get_engine = get_policy


def __getattr__(name):
    # Historical home of the multi-tenant service (now built on the registry
    # state machine in core/provision.py); re-exported lazily so the two
    # modules can import in either order.
    if name == "MultiTenantProvisionService":
        from repro_torch.core.provision import MultiTenantProvisionService
        return MultiTenantProvisionService
    raise AttributeError(name)
