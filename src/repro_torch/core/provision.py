"""Resource Provision Service — the organization's proxy (paper §II-B),
generalized from the paper's fixed ST/WS pair to an N-tenant registry.

``TenantProvisionService`` is a pure state machine over node *counts*
(nodes are fungible; ``runtime/device_pool.py`` maps counts to concrete
device slices). Departments register as :class:`~repro.core.policies.Tenant`
records; a pluggable two-phase :class:`~repro.core.policies.PolicyEngine`
decides how idle nodes are distributed (phase 2) and plans the ordered
reclaim chain when a latency-class tenant claims urgently (phase 1, from
per-tenant runtime signals):

  * latency tenants claim urgently; the free pool is drained first, then the
    engine's reclaim plan (paper default: batch tenants in reverse priority
    order, then lower-priority latency tenants; ``slo_headroom``/``auction``
    order by latency headroom / bids instead) is applied step by step —
    never taking a victim below its declared ``floor``;
  * released nodes flow back to batch tenants per the policy's idle rule;
  * node failures shrink capacity until repair, attributed to the pool that
    lost the node (with deterministic reattribution if the named pool is
    empty — a misattributed failure must never desync ``total`` from the
    pool sum).

``ResourceProvisionService`` keeps the paper's literal two-tenant API
(``st_alloc``/``ws_alloc``, ``on_grant_st``, ``force_st_release``, …) as a
thin facade over a 2-tenant registry running the ``"paper"`` policy, so the
2009 experiment stays reproducible bit-for-bit as the degenerate case.

The port's own copy of ``repro.core.provision`` with the same logic.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core.nodes import DRAIN_POOL, NodeInventory, NodeState
from repro_torch.core.policies import (CooperativePolicy, PaperPolicy,
                                 PolicyEngine, Tenant, get_policy)
from repro_torch.core.telemetry import NULL_TRACER, Tracer
from repro_torch.core.types import TenantSignals, TenantSpec


class TenantProvisionService:
    """Registry state machine with per-tenant allocations and a pluggable
    cooperative policy."""

    def __init__(self, total_nodes: int, *, policy="paper",
                 tracer: Optional[Tracer] = None):
        self.total = total_nodes
        self.free = total_nodes
        self.policy: PolicyEngine = get_policy(policy)
        # insertion-ordered: registration order is the deterministic
        # attribution order for node failures and timeline columns
        self.tenants: Dict[str, Tenant] = {}
        self.tracer = NULL_TRACER
        self.set_tracer(tracer or NULL_TRACER)
        # node-lifecycle layer (optional): an attached NodeInventory
        # mirrors every count move with identified nodes; None keeps the
        # pure count machine (zero overhead, the paper's model)
        self.inventory: Optional[NodeInventory] = None
        # forced-reclaim drain windows: nodes mid-drain serve neither the
        # victim nor the claimant; configure_drain wires the clock owner
        self.draining = 0
        self.drain_time_s = 0.0
        self._drain_schedule: Optional[
            Callable[[float, Callable[[], None]], None]] = None
        # FIFO of open node_fail spans for the count-only path (constant
        # repair delay => FIFO pairing is exact); with an inventory the
        # span rides on the Node record instead
        self._fail_span_fifo: List[int] = []

    def set_tracer(self, tracer: Tracer) -> None:
        """Point the service AND its engine (and the engine's market, for
        budget engines) at one event bus; the clock owner (simulator /
        orchestrator) keeps ``tracer.now`` current."""
        self.tracer = tracer
        self.policy.tracer = tracer
        market = getattr(self.policy, "market", None)
        if market is not None:
            market.tracer = tracer

    # ------------------------------------------------------------- wiring
    def register(self, tenant: Tenant) -> Tenant:
        assert tenant.name not in self.tenants, tenant.name
        assert tenant.name not in ("free", DRAIN_POOL), \
            f"{tenant.name!r} is a reserved pool name"
        self.tenants[tenant.name] = tenant
        return tenant

    def attach_inventory(self, inventory: NodeInventory) -> None:
        """Mirror every count move into an identified-node inventory.
        Must happen before any provisioning (all nodes free) so pools and
        counts start — and stay — in lockstep."""
        assert inventory.total == self.total, \
            (inventory.total, self.total)
        assert self.free == self.total, \
            "attach_inventory before any provisioning"
        self.inventory = inventory

    def configure_drain(self, drain_time_s: float,
                        schedule: Callable[[float, Callable[[], None]],
                                           None]) -> None:
        """Enable reclaim drain windows: each forced reclaim step's nodes
        sit in the drain pool for ``drain_time_s`` (serving neither
        tenant) before the claimant receives them. ``schedule(delay, fn)``
        is the clock owner's callback (the simulator pushes a DRAIN_DONE
        event). 0 disables (instant handover, the paper's assumption)."""
        self.drain_time_s = float(drain_time_s)
        self._drain_schedule = schedule if drain_time_s > 0 else None

    def register_spec(self, spec: TenantSpec, *,
                      on_grant: Optional[Callable[[int], None]] = None,
                      on_force_release: Optional[Callable[[int], int]] = None,
                      signals: Optional[Callable[[], TenantSignals]] = None
                      ) -> Tenant:
        """Register a declarative ``TenantSpec`` (core/types.py)."""
        return self.register(Tenant(
            name=spec.name, kind=spec.kind, priority=spec.priority,
            weight=spec.weight, floor=getattr(spec, "floor", 0),
            bid_weight=getattr(spec, "bid_weight", None),
            budget=getattr(spec, "budget", None),
            bid_policy=getattr(spec, "bid_policy", "linear"),
            on_grant=on_grant, on_force_release=on_force_release,
            signals=signals))

    # ----------------------------------------------------------- invariants
    def check(self):
        used = sum(t.alloc for t in self.tenants.values())
        assert used + self.free + self.draining == self.total, \
            (used, self.free, self.draining, self.total)
        assert self.free >= 0 and self.draining >= 0
        assert all(t.alloc >= 0 for t in self.tenants.values()), \
            {t.name: t.alloc for t in self.tenants.values()}
        if self.policy.demand_driven and self.policy.demand_satiating:
            # demand-capped invariant: nodes sit free only when every batch
            # tenant's declared demand is already covered (claims only drain
            # `free`, and every demand/release change reruns provision_idle,
            # so this holds at every quiescent point). Budget engines unset
            # demand_satiating: a broke tenant legitimately leaves demand
            # uncovered while nodes sit free (it cannot pay for them).
            assert self.free == 0 or all(
                t.alloc >= t.demand for t in self.tenants.values()
                if t.kind == "batch"), \
                (self.free, {t.name: (t.alloc, t.demand)
                             for t in self.tenants.values()
                             if t.kind == "batch"})

    def _batch_by_priority(self) -> List[Tenant]:
        return sorted((t for t in self.tenants.values()
                       if t.kind == "batch"), key=lambda t: t.priority)

    # ------------------------------------------------------------ requests
    def claim(self, name: str, n: int) -> int:
        """A latency tenant urgently claims n more nodes (paper rules 1/3).

        Drains the free pool first; the shortfall is forcibly reclaimed
        along the engine's phase-1 reclaim plan (``PolicyEngine.
        plan_reclaim``): an ordered list of per-victim caps the service
        applies step by step, never exceeding the live deficit, a victim's
        allocation, or the plan's floor-respecting cap. Batch victims
        release through their ``on_force_release`` hook (kill/preempt
        happens synchronously inside it); a batch tenant without the hook
        is skipped — the service never silently confiscates nodes it
        cannot make the CMS give up. Latency victims are reclaimed by
        count (their replicas are fungible); their hook, when present, is
        still notified. Returns the number of nodes actually granted.
        """
        t = self.tenants[name]
        assert t.kind == "latency", f"{name} is not a latency tenant"
        if n <= 0:
            return 0
        tr = self.tracer
        traced = tr.enabled
        inv = self.inventory
        # drain windows apply to forced reclaims only: free-pool nodes are
        # already idle and hand over instantly
        drain_s = self.drain_time_s if self._drain_schedule is not None \
            else 0.0
        claim_span = tr.new_span() if traced else 0
        granted = min(self.free, n)
        self.free -= granted
        t.alloc += granted
        if inv is not None and granted > 0:
            inv.transfer("free", name, granted)
        short = n - granted
        deficit = short
        surplus = 0
        pending = 0
        plan_span = 0
        if short > 0:
            plan = self.policy.plan_reclaim(
                short, list(self.tenants.values()), t)
            if traced:
                # claim-path emits are fully inlined (dict literal +
                # bounds-checked list append) — this is the hottest traced
                # region and the < 5 % bench gate rides on it
                plan_span = tr.new_span()
                evs = tr.events
                if len(evs) < tr.max_events:
                    evs.append({"type": "reclaim_plan", "ts": tr.now,
                                "span": plan_span, "parent": claim_span,
                                "tenant": name,
                                "engine": self.policy.name,
                                "deficit": short,
                                "steps": [{"victim": s.victim,
                                           "take": s.take,
                                           "reason": s.reason}
                                          for s in plan]})
                else:
                    tr.dropped_events += 1
            for step in plan:
                if short <= 0:
                    break
                v = self.tenants[step.victim]
                # the floor cap is re-derived at apply time: a reentrant
                # node_failed inside an earlier victim's hook may have
                # shrunk this victim's alloc since the plan was made
                take = min(short, step.take, self.policy.reclaimable(v))
                # engine apply-time cap (budget engines: what the claimant
                # can still afford at this victim's price, live — earlier
                # steps' debits are already reflected)
                take = min(take, self.policy.reclaim_cap(v, take, t))
                if take <= 0:
                    continue
                if v.on_force_release is not None:
                    # a victim may release MORE than asked (e.g. a trainer
                    # shrinks by whole DP groups): credit the full release
                    # so counts never desync from the devices it gave up
                    got = min(v.on_force_release(take), v.alloc)
                elif v.kind == "latency":
                    got = take
                else:
                    continue        # unwired batch tenant: not reclaimable
                v.alloc -= got
                give = min(got, short)
                short -= give
                surplus += got - give
                # full release for drain stats, `give` for money engines
                self.policy.note_reclaimed(v.name, got, granted=give)
                step_span = 0
                if drain_s > 0.0 and give > 0:
                    # reclaimed nodes pay the drain window before the
                    # claimant sees them: they serve neither tenant until
                    # _drain_done fires (the deficit is committed — short
                    # already dropped — but delivery is delayed)
                    self.draining += give
                    pending += give
                    step_span = tr.new_span() if traced else 0
                    ids = None
                    if inv is not None:
                        ids = inv.transfer(v.name, DRAIN_POOL, give,
                                           state=NodeState.DRAINING,
                                           parent=step_span or None)
                    self._drain_schedule(
                        drain_s,
                        lambda c=name, g=give, i=ids, s=step_span:
                            self._drain_done(c, g, i, s))
                else:
                    t.alloc += give
                    if inv is not None and give > 0:
                        inv.transfer(v.name, name, give)
                if inv is not None and got - give > 0:
                    inv.transfer(v.name, "free", got - give)
                if traced:
                    evs = tr.events
                    if len(evs) < tr.max_events:
                        ev = {"type": "reclaim_step", "ts": tr.now,
                              "parent": plan_span, "tenant": v.name,
                              "claimant": name, "asked": take,
                              "released": got, "granted": give}
                        if step_span:
                            # drain-delayed step: its span is the parent
                            # the eventual drain_complete links back to
                            ev["span"] = step_span
                            ev["drain_s"] = drain_s
                        evs.append(ev)
                    else:
                        tr.dropped_events += 1
        if traced:
            # emitted after the plan/steps so the whole chain shares one
            # decision instant; `short` here is the FINAL unmet remainder
            evs = tr.events
            if len(evs) < tr.max_events:
                ev = {"type": "claim", "ts": tr.now,
                      "span": claim_span, "tenant": name,
                      "requested": n, "from_free": granted,
                      "deficit": deficit, "granted": n - short,
                      "short": short}
                if pending:
                    # committed but still draining — delivered later by
                    # drain_complete events (granted includes pending)
                    ev["pending"] = pending
                evs.append(ev)
            else:
                tr.dropped_events += 1
            tr.last_claim_span[name] = claim_span
        if surplus > 0:
            # over-released nodes go back through the idle policy (they are
            # typically re-granted to the very tenant that shed them)
            self.free += surplus
            if traced:
                tr.append({"type": "surplus_reflow", "parent": claim_span,
                           "nodes": surplus})
            self.provision_idle()
        self.check()
        return n - short - pending

    def _drain_done(self, claimant: str, n: int,
                    ids: Optional[List[int]], step_span: int) -> None:
        """A reclaim step's drain window elapsed: deliver the surviving
        nodes to the claimant. With an inventory attached, nodes that
        failed mid-drain (drain_node_failed) are skipped — only ids still
        in the drain pool are credited."""
        inv = self.inventory
        if inv is not None:
            ids = [i for i in ids if inv.nodes[i].owner == DRAIN_POOL]
            n = len(ids)
            if n:
                inv.move_nodes(ids, claimant, state=NodeState.HEALTHY,
                               parent=step_span or None)
        self.draining -= n
        t = self.tenants[claimant]
        t.alloc += n
        if self.tracer.enabled:
            self.tracer.append({"type": "drain_complete",
                                "tenant": claimant, "nodes": n,
                                "parent": step_span or None})
        if n > 0 and t.on_grant is not None:
            t.on_grant(n)
        self.check()

    def release(self, name: str, n: int, *, reprovision: bool = True):
        """A tenant returns idle nodes; they flow back per the idle policy.

        provision_idle runs before check(): the freed nodes must first
        flow to batch tenants with unmet demand or the demand-capped
        invariant would trip mid-transition."""
        t = self.tenants[name]
        n = min(n, t.alloc)
        t.alloc -= n
        self.free += n
        if self.inventory is not None and n > 0:
            self.inventory.transfer(name, "free", n)
        if self.tracer.enabled and n > 0:
            self.tracer.append({"type": "release", "tenant": name,
                                "nodes": n})
        if reprovision:
            self.provision_idle()
        self.check()

    def set_demand(self, name: str, demand: int, *, provision: bool = True):
        self.tenants[name].demand = max(0, demand)
        if provision:
            self.provision_idle()

    # alias kept for the original multi-tenant API
    set_batch_demand = set_demand

    def provision_idle(self):
        """Distribute free nodes to batch tenants per the cooperative
        policy (paper rule 2 is the ``"paper"`` policy's version)."""
        batch = self._batch_by_priority()
        if not batch or self.free <= 0:
            self.check()
            return
        for t, give in self.policy.idle_grants(self.free, batch):
            if give <= 0:
                continue
            give = min(give, self.free)
            self.free -= give
            t.alloc += give
            if self.inventory is not None:
                self.inventory.transfer("free", t.name, give)
            if self.tracer.enabled:
                self.tracer.append({"type": "idle_grant", "tenant": t.name,
                                    "nodes": give})
            if t.on_grant is not None:
                t.on_grant(give)
        self.check()

    # ------------------------------------------------- failures (runtime)
    def node_failed(self, owner: str, *, node: Optional[int] = None,
                    cause: Optional[str] = None) -> Optional[int]:
        """A node died; capacity shrinks until repair.

        ``owner`` is a tenant name or ``"free"``. If the attributed pool is
        empty the failure is deterministically reattributed (free pool
        first, then tenants in registration order) so ``total`` can never
        desync from the pool sum; with no node anywhere a failure is
        impossible and raises. ``node`` names the failed node when an
        inventory is attached (lowest-id of the pool otherwise). Returns
        the failed node id (None without an inventory). The failure's
        telemetry span parents the eventual ``node_repair`` — one causal
        chain per outage."""
        pools = [("free", self.free)] + \
            [(t.name, t.alloc) for t in self.tenants.values()]
        by_name = dict(pools)
        if owner not in by_name:
            raise KeyError(f"unknown pool {owner!r}; have "
                           f"{[p for p, _ in pools]}")
        requested_owner = owner
        if by_name[owner] <= 0:
            owner = next((p for p, alloc in pools if alloc > 0), None)
            if owner is None:
                raise ValueError("node_failed on an empty cluster "
                                 f"(total={self.total})")
        if owner == "free":
            self.free -= 1
        else:
            self.tenants[owner].alloc -= 1
        self.total -= 1
        tr = self.tracer
        span = tr.new_span() if tr.enabled else 0
        if self.inventory is not None:
            if node is None:
                node = self.inventory.pick(owner)
            self.inventory.fail(node, span=span, cause=cause)
        elif tr.enabled:
            # count-only path: repair delay is constant, so FIFO pairing
            # of open failure spans with repairs is exact
            self._fail_span_fifo.append(span)
        if tr.enabled:
            ev = {"type": "node_fail", "owner": owner, "span": span,
                  "requested": requested_owner, "total": self.total}
            if node is not None:
                ev["node"] = node
            if cause is not None:
                ev["cause"] = cause
            tr.append(ev)
        if self.policy.demand_driven:
            # a failure can drop a batch tenant below its declared demand
            # while nodes sit free; rebalance to restore the invariant
            self.provision_idle()
        self.check()
        return node

    def drain_node_failed(self, node: int, *,
                          cause: Optional[str] = None) -> int:
        """A node died mid-drain: it was serving neither tenant, so only
        the drain pool and ``total`` shrink; the scheduled ``_drain_done``
        will skip it and credit the claimant only the survivors."""
        assert self.inventory is not None, \
            "drain_node_failed requires an attached inventory"
        assert self.draining > 0, self.draining
        self.draining -= 1
        self.total -= 1
        tr = self.tracer
        span = tr.new_span() if tr.enabled else 0
        self.inventory.fail(node, span=span, cause=cause)
        if tr.enabled:
            ev = {"type": "node_fail", "owner": DRAIN_POOL, "span": span,
                  "requested": DRAIN_POOL, "total": self.total,
                  "node": node}
            if cause is not None:
                ev["cause"] = cause
            tr.append(ev)
        if self.policy.demand_driven:
            self.provision_idle()
        self.check()
        return node

    def node_repaired(self, *, node: Optional[int] = None
                      ) -> Optional[int]:
        """Capacity returns after repair. ``node`` names the repaired node
        (lowest-id down node otherwise, with an inventory); the telemetry
        event parents the node's original ``node_fail`` span. Returns the
        repaired node id (None without an inventory)."""
        self.total += 1
        self.free += 1
        parent = None
        if self.inventory is not None:
            nd = self.inventory.repair(node)
            node = nd.id
            parent = nd.fail_span or None
        elif self._fail_span_fifo:
            parent = self._fail_span_fifo.pop(0)
        if self.tracer.enabled:
            ev = {"type": "node_repair", "parent": parent,
                  "total": self.total}
            if node is not None:
                ev["node"] = node
            self.tracer.append(ev)
        self.provision_idle()   # re-provision before the invariant check:
        self.check()            # the repaired node may cover unmet demand
        return node


class MultiTenantProvisionService(TenantProvisionService):
    """Original multi-tenant API (strict priorities, greedy/demand-capped
    idle) expressed over the policy framework. ``greedy_idle=True``
    reproduces the paper's two-tenant rule verbatim (ALL leftover idle
    nodes are dumped on the highest-priority batch tenant, demand or not);
    the default caps grants at declared demand and leaves the remainder
    free."""

    def __init__(self, total_nodes: int, *, greedy_idle: bool = False):
        super().__init__(
            total_nodes,
            policy="paper" if greedy_idle else "demand_capped")
        self.greedy_idle = greedy_idle


class ResourceProvisionService(TenantProvisionService):
    """The paper's two-tenant service (§II-B), verbatim policy:

      * WS demands have higher priority than ST demands.
      * All idle resources are provisioned to ST.
      * If WS claims urgent resources, the provision service FORCES ST to
        return the claimed amount and reallocates it to WS.

    Implemented as a fixed 2-tenant registry under the ``"paper"`` policy;
    the legacy attribute/callback API is preserved so the simulator, the
    runtime orchestrator and the seed experiments are bit-for-bit
    unchanged.
    """

    def __init__(self, total_nodes: int, *,
                 tracer: Optional[Tracer] = None):
        super().__init__(total_nodes, policy=PaperPolicy(), tracer=tracer)
        # registration order (st, ws) is a compatibility contract: node
        # failures and timeline columns attribute in this order
        self._st = self.register(Tenant("st", "batch", priority=1))
        self._ws = self.register(Tenant("ws", "latency", priority=0))
        self.on_grant_ws: Optional[Callable[[int], None]] = None

    # ------------------------------------------------- legacy attributes
    @property
    def st_alloc(self) -> int:
        return self._st.alloc

    @property
    def ws_alloc(self) -> int:
        return self._ws.alloc

    @property
    def on_grant_st(self) -> Optional[Callable[[int], None]]:
        return self._st.on_grant

    @on_grant_st.setter
    def on_grant_st(self, fn: Optional[Callable[[int], None]]):
        self._st.on_grant = fn

    @property
    def force_st_release(self) -> Optional[Callable[[int], int]]:
        return self._st.on_force_release

    @force_st_release.setter
    def force_st_release(self, fn: Optional[Callable[[int], int]]):
        self._st.on_force_release = fn

    # --------------------------------------------------- legacy verbs
    def ws_request(self, n: int) -> int:
        """WS claims n more nodes (urgent, highest priority)."""
        return self.claim("ws", n)

    def ws_release(self, n: int):
        """WS releases idle nodes immediately (paper's WS policy)."""
        self.release("ws", n)

    def provision_idle_to_st(self):
        """All idle resources go to ST (paper's provision policy, rule 2)."""
        self.provision_idle()

    def st_release(self, n: int):
        """ST voluntarily returns nodes (idle beyond need); they stay free
        until the next provisioning decision."""
        self.release("st", n, reprovision=False)
