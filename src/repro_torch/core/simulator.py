"""Discrete-event consolidation simulator (paper §III-D), N-department.

Wires a tenant-registry provision service (core/provision.py) + one CMS per
department over a virtual-time event queue. Exact event ordering in virtual
seconds — the paper's 100x wall-clock acceleration is irrelevant here (no
wall-clock dependence at all).

The paper's experiment is the degenerate 2-department case (one ST batch
department + one WS latency department under the ``"paper"`` policy) and is
what the legacy ``ConsolidationSim(cfg, jobs, ws_demand, horizon)`` call
builds — bit-for-bit identical to the seed simulator (the regression test
in tests/test_tenancy.py pins its numbers). Passing ``tenants=[TenantSpec,
...]`` instead runs any department mix — e.g. 2 HPC + 2 request-level WS +
1 best-effort batch tenant — under any cooperative policy from
core/policies.py, with per-department accounting in ``SimResult.tenants``.

Supports the paper's experiment (kill-mode, first-fit, SC vs DC) plus the
beyond-paper knobs in ``SimConfig``: checkpoint-preemption, EASY backfill,
node failures/repairs, stragglers with speculative relaunch.

The port's own copy of ``repro.core.simulator`` with the same logic.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FaultSpec, make_injector
from repro_torch.core.nodes import DRAIN_POOL, NodeInventory
from repro_torch.core.provision import (ResourceProvisionService,
                                  TenantProvisionService)
from repro_torch.core.st_cms import STServer
from repro_torch.core.telemetry import NULL_TRACER, Tracer
from repro_torch.core.types import (Event, EventKind, Job, JobState, SimConfig,
                              TenantSpec)
from repro_torch.core.ws_cms import WSServer, resolve_demand_events

# util_timeline rows beyond this are stride-downsampled (never truncated:
# long-horizon runs keep early history at reduced resolution)
TIMELINE_MAX_POINTS = 2000


def downsample_timeline(timeline: List[tuple],
                        max_points: int = TIMELINE_MAX_POINTS) -> List[tuple]:
    """Stride-based downsampling preserving first and last rows."""
    n = len(timeline)
    if n <= max_points:
        return list(timeline)
    stride = math.ceil(n / max_points)
    out = list(timeline[::stride])
    if out[-1] != timeline[-1]:
        out.append(timeline[-1])
    return out


@dataclass
class TenantResult:
    """Per-department outcome of one consolidation run."""
    name: str
    kind: str                         # "batch" | "latency"
    priority: int
    avg_alloc: float = 0.0
    # batch departments
    submitted: int = 0
    completed: int = 0
    killed: int = 0
    preemptions: int = 0
    avg_turnaround: float = 0.0
    median_turnaround: float = 0.0
    node_seconds_used: float = 0.0
    # latency departments
    unmet_node_seconds: float = 0.0
    reclaim_events: int = 0
    preempted_nodes: int = 0
    latency: Optional[Dict[str, float]] = None
    # two-phase engine accounting: how often / how many nodes the reclaim
    # planner drained FROM this department, and its last auction bid
    reclaimed_events: int = 0
    reclaimed_nodes: int = 0
    last_bid: float = 0.0
    # market engine accounting: tokens spent over the run and what is left
    # of the declared budget (None = unlimited or no market engine)
    spend: float = 0.0
    budget_remaining: Optional[float] = None

    @property
    def benefit(self) -> Dict[str, float]:
        """Paper §III-A benefit metrics, per department.

        Batch: provider benefit = completed jobs, user benefit = 1/avg
        turnaround. Latency: demand coverage (plus SLO attainment when the
        demand source is request-level)."""
        if self.kind == "batch":
            return {
                "provider_completed_jobs": float(self.completed),
                "user_inv_turnaround":
                    1.0 / self.avg_turnaround if self.avg_turnaround > 0
                    else 0.0,
            }
        out = {"unmet_node_seconds": self.unmet_node_seconds,
               "demand_met": 1.0 if self.unmet_node_seconds == 0.0 else 0.0}
        if self.latency:
            out["p99_s"] = float(self.latency.get("p99_s", 0.0))
            out["violation_rate"] = \
                float(self.latency.get("violation_rate", 0.0))
            out["slo_met"] = float(bool(self.latency.get("slo_met", False)))
        return out


@dataclass
class SimResult:
    total_nodes: int
    submitted: int
    completed: int
    killed: int
    preemptions: int
    avg_turnaround: float
    median_turnaround: float
    ws_unmet_node_seconds: float
    ws_reclaim_events: int
    st_node_seconds_used: float
    st_avg_alloc: float
    ws_avg_alloc: float
    util_timeline: List[Tuple[float, ...]] = field(repr=False,
                                                   default_factory=list)
    # request-level WS metrics (only when ws_demand is a WSDemandProvider
    # with realized_metrics): p50/p95/p99 latency, violation rate, ...
    ws_latency: Optional[Dict[str, float]] = None
    # N-department accounting: one TenantResult per registered department
    # (the legacy scalar fields above are the batch/latency aggregates)
    tenants: Dict[str, TenantResult] = field(default_factory=dict)
    policy: str = "paper"
    # engine state snapshot: reclaim plans made, per-victim drain counts,
    # and (auction) per-interval clearing prices
    policy_state: Dict = field(default_factory=dict)

    @property
    def benefit_provider(self) -> int:
        """Paper §III-A: ST provider benefit = completed jobs."""
        return self.completed

    @property
    def benefit_user(self) -> float:
        """Paper §III-A: end-user benefit = 1 / avg turnaround."""
        return 1.0 / self.avg_turnaround if self.avg_turnaround > 0 else 0.0

    def benefits(self) -> Dict[str, Dict[str, float]]:
        """Per-department benefit metrics (paper §III-A generalized)."""
        return {name: t.benefit for name, t in self.tenants.items()}


class _TenantRuntime:
    """One department wired into the simulator: spec + CMS + accounting."""

    def __init__(self, spec: TenantSpec):
        self.spec = spec
        self.server = None             # STServer | WSServer
        self.record = None             # Tenant record inside the service
        self.jobs: List[Job] = []      # batch: this department's job copies
        self.demand: List[Tuple[float, int]] = []     # latency: events
        self.provider = None           # latency: WSDemandProvider or None
        self.alloc_seconds = 0.0
        self.used_seconds = 0.0

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def is_batch(self) -> bool:
        return self.spec.kind == "batch"


class ConsolidationSim:
    def __init__(self, cfg: SimConfig, jobs: Optional[List[Job]] = None,
                 ws_demand=None, horizon: float = 0.0, *,
                 tenants: Optional[Sequence[TenantSpec]] = None,
                 policy=None, tracer: Optional[Tracer] = None,
                 defer_queue: bool = False):
        """Two calling conventions:

        * legacy / paper (degenerate 2-department): ``ConsolidationSim(cfg,
          jobs, ws_demand, horizon)``. ws_demand: [(t, n), ...] node-demand
          events OR a ``WSDemandProvider`` (e.g. ``workloads.
          RequestWorkload``), in which case demand comes from its SLO
          autoscaler and request-level latency metrics are attached.
        * N-department: ``ConsolidationSim(cfg, horizon=..., tenants=[...],
          policy="paper"|"demand_capped"|"proportional_share"|instance)``.
          Each batch spec carries a job trace; each latency spec a demand
          timeseries or provider.

        ``defer_queue=True`` skips the per-tenant request-queue simulation
        in the results: each would-be ``realized_metrics`` call is recorded
        in ``self.deferred_queue`` as ``(tenant_name, provider,
        alloc_events)`` and the tenant's ``latency`` stays None, so a
        caller owning many sims can dispatch every queue as one batched
        device program (see ``workloads.campaign``). Queue metrics never
        feed back into the consolidation dynamics, so deferral changes
        nothing else about the run.
        """
        self.cfg = cfg
        self.defer_queue = defer_queue
        self.deferred_queue: List[Tuple[str, object, list]] = []
        self.horizon = horizon
        self.now = 0.0
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.rng = random.Random(cfg.seed)
        self._q: List[Event] = []
        self._seq = 0
        self._job_epoch: Dict[Tuple[str, int], int] = {}

        self._degenerate = tenants is None
        if self._degenerate:
            # the paper's fixed wiring; registration order (st, ws) is part
            # of the reproducibility contract (failure attribution order,
            # timeline columns)
            tenants = [
                TenantSpec("st", "batch", priority=1,
                           jobs=list(jobs) if jobs is not None else []),
                TenantSpec("ws", "latency", priority=0,
                           demand=[] if ws_demand is None else ws_demand),
            ]
            assert policy is None or str(getattr(
                policy, "name", policy)) == "paper", \
                "the legacy 2-tenant call runs the paper policy; pass " \
                "tenants=[...] to choose another"
            policy = "paper"
        else:
            assert jobs is None and ws_demand is None, \
                "pass demand sources inside TenantSpec when using tenants=[]"
            policy = policy if policy is not None else "paper"
        names = [s.name for s in tenants]
        assert len(set(names)) == len(names), f"duplicate tenants: {names}"

        if self._degenerate:
            self.svc: TenantProvisionService = \
                ResourceProvisionService(cfg.total_nodes,
                                         tracer=self.tracer)
        else:
            self.svc = TenantProvisionService(cfg.total_nodes, policy=policy,
                                              tracer=self.tracer)
        self.rps = self.svc            # legacy attribute name
        self.policy_name = self.svc.policy.name
        self._demand_driven = self.svc.policy.demand_driven

        # fault-injection wiring: a FaultSpec supersedes the legacy
        # node_mtbf knob; it brings the identified-node inventory (and
        # with it per-node lifecycle telemetry + failure domains)
        spec_f: Optional[FaultSpec] = cfg.faults
        self.inventory: Optional[NodeInventory] = None
        self._injector = None
        if spec_f is not None:
            self.inventory = NodeInventory(cfg.total_nodes,
                                           rack_size=spec_f.rack_size,
                                           tracer=self.tracer)
            self.svc.attach_inventory(self.inventory)
            self._injector = make_injector(spec_f, cfg.seed,
                                           sim_rng=self.rng)
        # reclaim drain windows (SimConfig.drain_time_s or the profile's):
        # the service schedules DRAIN_DONE through our event queue
        drain_s = max(cfg.drain_time_s,
                      spec_f.drain_time_s if spec_f is not None else 0.0)
        if drain_s > 0:
            self.svc.configure_drain(
                drain_s,
                lambda dt, fn: self._push(self.now + dt,
                                          EventKind.DRAIN_DONE, fn))

        if self.tracer.enabled:
            self.tracer.meta.setdefault("policy", self.policy_name)
            self.tracer.meta.setdefault("total_nodes", cfg.total_nodes)
            self.tracer.meta.setdefault("horizon", horizon)
            self.tracer.meta.setdefault("seed", cfg.seed)
            if spec_f is not None:
                self.tracer.meta.setdefault("fault_profile", spec_f.profile)
        # open SLO-shortfall episodes: tenant -> (violation span, start ts)
        self._episodes: Dict[str, Tuple[int, float]] = {}
        self._next_sample = 0.0

        self._runtimes: List[_TenantRuntime] = []
        for spec in tenants:
            rt = _TenantRuntime(spec)
            if spec.kind == "batch":
                rt.jobs = [dataclasses.replace(j) for j in (spec.jobs or [])]
                rt.server = STServer(
                    cfg,
                    (lambda job, t, rt=rt: self._schedule_finish(rt, job, t)),
                    (lambda job, rt=rt: self._cancel_finish(rt, job)))
                on_grant = (lambda n, s=rt.server: s.grant(n, self.now))
                on_force = (lambda n, s=rt.server:
                            s.force_release(n, self.now))
            else:
                rt.demand, rt.provider = \
                    resolve_demand_events(spec.demand or [], horizon)
                rt.server = WSServer(
                    cfg,
                    request=(lambda n, name=spec.name:
                             self.svc.claim(name, n)),
                    release=(lambda n, name=spec.name:
                             self.svc.release(name, n)),
                    slo=spec.slo)
                # deferred drain-window deliveries land via on_grant
                # (plain claims credit synchronously through the claim()
                # return value, so this only fires when drains are active)
                on_grant = (lambda n, s=rt.server: s.grant(n, self.now))
                on_force = (lambda n, s=rt.server:
                            s.force_release(n, self.now))
            if spec.name in self.svc.tenants:   # degenerate: pre-registered
                rt.record = self.svc.tenants[spec.name]
                rt.record.on_grant = on_grant
                rt.record.on_force_release = on_force
                rt.record.weight = spec.weight
                rt.record.floor = spec.floor
                rt.record.bid_weight = spec.bid_weight
                rt.record.budget = spec.budget
                rt.record.bid_policy = spec.bid_policy
            else:
                rt.record = self.svc.register_spec(
                    spec, on_grant=on_grant, on_force_release=on_force)
            # live CMS signals feed the phase-1 reclaim planner
            rt.record.signals = (
                lambda rt=rt: rt.server.signals(
                    self.now, name=rt.name, weight=rt.record.weight))
            self._runtimes.append(rt)

        self._batch = [rt for rt in self._runtimes if rt.is_batch]
        self._latency = [rt for rt in self._runtimes if not rt.is_batch]
        self._rt_by_name = {rt.name: rt for rt in self._runtimes}
        # metric-sample fast path: the per-runtime attribute walk is
        # hoisted once (runtimes are fixed after construction), as is the
        # engine's market handle — _trace_sample runs inside the < 5 %
        # bench envelope
        self._sample_rows = [
            (rt.name, rt.record, rt.server, rt.is_batch,
             rt.is_batch and hasattr(rt.server, "queue"))
            for rt in self._runtimes]
        self._trace_market = getattr(self.svc.policy, "market", None)
        # legacy aliases (the paper wiring); first of each class otherwise
        self.st = self._batch[0].server if self._batch else None
        self.ws = self._latency[0].server if self._latency else None
        self.jobs: List[Job] = [j for rt in self._batch for j in rt.jobs]
        self.ws_demand = self._latency[0].demand if self._latency else []
        self.ws_provider = self._latency[0].provider if self._latency \
            else None

        # timeline accounting
        self._last_t = 0.0
        self.timeline: List[Tuple[float, ...]] = []

    # --------------------------------------------------------------- events
    def _push(self, t: float, kind: EventKind, payload=None):
        self._seq += 1
        heapq.heappush(self._q, Event(t, self._seq, kind, payload))

    def _schedule_finish(self, rt: _TenantRuntime, job: Job, t: float):
        key = (rt.name, job.job_id)
        epoch = self._job_epoch.get(key, 0) + 1
        self._job_epoch[key] = epoch
        t_eff = t
        if self.cfg.straggler_frac > 0 and \
                self.rng.random() < self.cfg.straggler_frac:
            slow = t + (self.cfg.straggler_slowdown - 1.0) * job.remaining()
            if self.cfg.speculative_relaunch:
                # detect at 1.2x nominal, relaunch a copy: finishes at
                # detection + fresh remaining work
                spec = self.now + 1.2 * job.remaining() + job.remaining()
                t_eff = min(slow, spec)
            else:
                t_eff = slow
        self._push(t_eff, EventKind.JOB_FINISH, (rt, job, epoch))

    def _cancel_finish(self, rt: _TenantRuntime, job: Job):
        key = (rt.name, job.job_id)
        self._job_epoch[key] = self._job_epoch.get(key, 0) + 1

    # ---------------------------------------------------------- accounting
    def _account(self, t: float):
        dt = t - self._last_t
        if dt > 0:
            for rt in self._runtimes:
                rt.alloc_seconds += rt.record.alloc * dt
                if rt.is_batch:
                    rt.used_seconds += rt.server.used * dt
            self._last_t = t

    def _update_demands(self):
        """Demand-aware policies: keep each batch department's declared
        demand current and voluntarily return surplus idle allocation (the
        paper's policy ignores demand, so this is skipped for it)."""
        if not self._demand_driven:
            return
        for rt in self._batch:
            self.svc.set_demand(rt.name, rt.server.demand_nodes(),
                                provision=False)
        self.svc.provision_idle()   # one pass after ALL demands are current
        for rt in self._batch:
            surplus = rt.record.alloc - max(rt.record.demand,
                                            rt.server.used)
            if surplus > 0:
                freed = rt.server.release_idle(surplus)
                if freed > 0:
                    self.svc.release(rt.name, freed)

    # ---------------------------------------------------------------- run
    def run(self) -> SimResult:
        for rt in self._batch:
            for job in rt.jobs:
                self._push(job.submit_time, EventKind.JOB_SUBMIT, (rt, job))
        for rt in self._latency:
            for t, n in rt.demand:
                self._push(t, EventKind.WS_DEMAND, (rt, n))
        if self._injector is not None:
            self._injector.start(self)
        elif self.cfg.node_mtbf > 0:
            self._push(self.rng.expovariate(
                self.cfg.total_nodes / self.cfg.node_mtbf),
                EventKind.NODE_FAIL)

        # initial provision: everything idle flows per the policy (paper:
        # all of it to the highest-priority batch department)
        self._update_demands()
        self.svc.provision_idle()

        # telemetry fast path: the traced-loop additions must stay near
        # one dict-append per emitted event (< 5% bench gate); episode
        # checks run only on events that can move a latency department's
        # alloc/demand (WS_DEMAND, NODE_FAIL/REPAIR — job events and idle
        # reflows only ever touch batch allocations)
        tr = self.tracer
        traced = tr.enabled
        while self._q:
            ev = heapq.heappop(self._q)
            if ev.time > self.horizon:
                break
            self._account(ev.time)
            self.now = ev.time
            if traced:
                tr.now = ev.time
            if ev.kind is EventKind.JOB_SUBMIT:
                rt, job = ev.payload
                rt.server.submit(job, self.now)
            elif ev.kind is EventKind.JOB_FINISH:
                rt, job, epoch = ev.payload
                if self._job_epoch.get((rt.name, job.job_id)) == epoch and \
                        job.state is JobState.RUNNING:
                    rt.server.job_finished(job, self.now)
            elif ev.kind is EventKind.WS_DEMAND:
                rt, n = ev.payload
                if traced:
                    # the demand event IS the autoscaler's decision when
                    # the source is a provider (its SLO autoscaler planned
                    # the node-demand series); raw timeseries otherwise.
                    # Inlined append: hottest traced site in the loop.
                    evs = tr.events
                    if len(evs) < tr.max_events:
                        evs.append({"type": "autoscale", "ts": tr.now,
                                    "tenant": rt.name,
                                    "prev": rt.server.demand, "demand": n,
                                    "source": "provider"
                                    if rt.provider is not None
                                    else "timeseries"})
                    else:
                        tr.dropped_events += 1
                rt.server.set_demand(n, self.now)
                if traced:
                    self._trace_episodes()
            elif ev.kind is EventKind.NODE_FAIL:
                if self._injector is not None:
                    self._injector.fire(self, ev.payload)
                else:
                    self._node_fail()
                    self._push(self.now + self.rng.expovariate(
                        self.cfg.total_nodes / self.cfg.node_mtbf),
                        EventKind.NODE_FAIL)
                if traced:
                    self._trace_episodes()
            elif ev.kind is EventKind.NODE_REPAIR:
                self.svc.node_repaired(node=ev.payload)
                if traced:
                    self._trace_episodes()
            elif ev.kind is EventKind.DRAIN_DONE:
                ev.payload()   # service closure: deliver surviving nodes
                if traced:
                    self._trace_episodes()
            self._update_demands()     # no-op under the paper policy
            if traced and self.now >= self._next_sample:
                self._trace_sample()
            self.timeline.append(
                (self.now,
                 *(rt.record.alloc for rt in self._runtimes),
                 self.svc.free))
        self._account(self.horizon)
        if traced:
            tr.now = self.horizon
            self._trace_episodes()
            self._trace_sample()       # closing sample at the horizon
        return self._result()

    # ------------------------------------------------------------ telemetry
    def _trace_episodes(self):
        """SLO shortfall episodes: open a ``slo_violation`` span when a
        latency department's granted allocation falls below its demand
        (parented to its most recent claim so the whole ``claim ->
        reclaim -> recovery`` chain links up), close it with a
        ``slo_recovery`` when the shortfall clears."""
        tr = self.tracer
        eps = self._episodes
        for rt in self._latency:
            shortfall = rt.server.demand - rt.record.alloc
            if shortfall > 0:
                if rt.name not in eps:
                    span = tr.new_span()
                    eps[rt.name] = (span, self.now)
                    tr.append({"type": "slo_violation", "span": span,
                               "parent": tr.last_claim_span.get(rt.name),
                               "tenant": rt.name,
                               "demand": rt.server.demand,
                               "alloc": rt.record.alloc,
                               "shortfall": shortfall})
            elif rt.name in eps:
                span, start = eps.pop(rt.name)
                tr.append({"type": "slo_recovery", "parent": span,
                           "tenant": rt.name,
                           "duration_s": self.now - start})

    def _trace_sample(self):
        """One ``metrics`` timeseries point: free pool + per-department
        alloc/demand/queue/headroom/spend. Reads registry fields and cheap
        CMS attributes only — never ``signals()`` (batch demand_nodes
        walks the whole job queue, which would blow the overhead gate)."""
        tr = self.tracer
        tenants: Dict[str, Dict] = {}
        market = self._trace_market
        for name, rec, server, is_batch, has_queue in self._sample_rows:
            spend = market.spend.get(name, 0.0) if market is not None \
                else 0.0
            if is_batch:
                # under demand-driven policies rec.demand is kept current
                # by _update_demands; the paper engine never declares it
                tenants[name] = {
                    "alloc": rec.alloc, "demand": rec.demand,
                    "queue_depth": len(server.queue) if has_queue else 0,
                    "headroom_s": 0.0, "spend": spend}
            else:
                demand = server.demand
                alloc = rec.alloc
                tenants[name] = {
                    "alloc": alloc, "demand": demand,
                    "queue_depth": demand - alloc if demand > alloc else 0,
                    "headroom_s": server.latency_headroom_s(),
                    "spend": spend}
        evs = tr.events
        if len(evs) < tr.max_events:
            evs.append({"type": "metrics", "ts": tr.now,
                        "free": self.svc.free, "tenants": tenants})
        else:
            tr.dropped_events += 1
        interval = tr.metric_interval_s
        if interval > 0:
            while self._next_sample <= self.now:
                self._next_sample += interval
        else:
            self._next_sample = math.inf

    # ------------------------------------------------------ fault injection
    # The injector-facing API: injectors (core/faults.py) own all fault
    # RNG and scheduling decisions; the simulator owns the clock, the
    # event queue and the count/CMS bookkeeping.

    def schedule_fault(self, delay: float, payload=None):
        self._push(self.now + delay, EventKind.NODE_FAIL, payload)

    def schedule_repair(self, delay: float, node: Optional[int] = None):
        self._push(self.now + delay, EventKind.NODE_REPAIR, node)

    def emit_suppressed(self, reason: str, **fields):
        """A fault event fired but could not take a node down (cluster at
        its one-node minimum, flapper already dark, ...). Traced instead
        of silently dropped so fail/repair events always pair up."""
        tr = self.tracer
        if tr.enabled:
            tr.emit("fault_suppressed", reason=reason, **fields)

    def apply_node_failure(self, node_id: int, cause: str,
                           domain: Optional[int] = None):
        """Take one identified node down, routing the loss through
        whichever layer currently holds it (free pool, a tenant's CMS, or
        the drain pool)."""
        owner = self.inventory.owner_of(node_id)
        if owner == DRAIN_POOL:
            self.svc.drain_node_failed(node_id, cause=cause)
            return
        if owner == "free":
            self.svc.node_failed("free", node=node_id, cause=cause)
            return
        rt = self._rt_by_name[owner]
        # route the loss through the CMS's own eviction path so the
        # server's alloc and the service's record cannot diverge (idle
        # nodes absorb the loss before any job/replica is evicted)
        rt.server.node_lost(self.now)
        self.svc.node_failed(owner, node=node_id, cause=cause)
        if not rt.is_batch:
            # a latency department immediately re-requests to cover demand
            rt.server.set_demand(rt.server.demand, self.now)

    def fail_pool_proportional(self, rng: random.Random,
                               repair_time_s: float,
                               cause: Optional[str] = None):
        """Legacy victim selection: one anonymous node fails, attributed
        to pools proportionally to their size (free pool first, then
        departments in registration order — the paper wiring's order is
        st, ws). Draw order is the reproducibility contract: a suppressed
        fault consumes NO draw from ``rng``."""
        total_alloc = self.svc.free + sum(rt.record.alloc
                                          for rt in self._runtimes)
        if total_alloc <= 1:
            # the cluster is at its one-node minimum: taking the node
            # would zero it out. Traced (never silently dropped) so
            # fail/repair events stay paired and repairs can never
            # over-repair past the configured total.
            self.emit_suppressed("cluster_at_minimum",
                                 total_alloc=total_alloc)
            return
        r = rng.random() * total_alloc
        if r < self.svc.free:
            node = self.svc.node_failed("free", cause=cause)
        else:
            acc = self.svc.free
            victim = self._runtimes[-1]
            for rt in self._runtimes:
                acc += rt.record.alloc
                if r < acc:
                    victim = rt
                    break
            victim.server.node_lost(self.now)
            node = self.svc.node_failed(victim.name, cause=cause)
            if not victim.is_batch:
                victim.server.set_demand(victim.server.demand, self.now)
        self.schedule_repair(repair_time_s, node)

    def _node_fail(self):
        """Legacy ``node_mtbf`` fault path (no FaultSpec configured)."""
        self.fail_pool_proportional(self.rng, self.cfg.node_repair_time)

    # ------------------------------------------------------------- results
    def _tenant_result(self, rt: _TenantRuntime) -> TenantResult:
        horizon = self.horizon
        res = TenantResult(name=rt.name, kind=rt.spec.kind,
                           priority=rt.spec.priority,
                           avg_alloc=rt.alloc_seconds / horizon
                           if horizon > 0 else 0.0)
        engine = self.svc.policy
        res.reclaimed_events = engine.victim_counts.get(rt.name, 0)
        res.reclaimed_nodes = engine.victim_nodes.get(rt.name, 0)
        res.last_bid = float(getattr(engine, "last_bids", {})
                             .get(rt.name, 0.0))
        market = getattr(engine, "market", None)
        if market is not None:
            res.spend = float(market.spend.get(rt.name, 0.0))
            rem = market.remaining.get(rt.name, math.inf)
            res.budget_remaining = None if math.isinf(rem) else float(rem)
        if rt.is_batch:
            completed = [j for j in rt.jobs if j.state is JobState.COMPLETED]
            tats = sorted(j.turnaround for j in completed)
            res.submitted = len(rt.jobs)
            res.completed = len(completed)
            res.killed = sum(j.state is JobState.KILLED for j in rt.jobs)
            res.preemptions = rt.server.preemptions
            res.avg_turnaround = float(np.mean(tats)) if tats else 0.0
            res.median_turnaround = float(np.median(tats)) if tats else 0.0
            res.node_seconds_used = rt.used_seconds
        else:
            res.unmet_node_seconds = rt.server.unmet_node_seconds
            res.reclaim_events = rt.server.reclaim_events
            res.preempted_nodes = rt.server.preempted_nodes
            if rt.provider is not None and \
                    hasattr(rt.provider, "realized_metrics"):
                if self.defer_queue:
                    self.deferred_queue.append(
                        (rt.name, rt.provider,
                         list(rt.server.alloc_events)))
                else:
                    res.latency = rt.provider.realized_metrics(
                        rt.server.alloc_events, horizon=horizon)
        return res

    def _result(self) -> SimResult:
        horizon = self.horizon
        tenants = {rt.name: self._tenant_result(rt)
                   for rt in self._runtimes}
        batch = [tenants[rt.name] for rt in self._batch]
        latency = [tenants[rt.name] for rt in self._latency]

        # cross-department aggregates (for the degenerate paper wiring
        # these ARE the single ST/WS departments' numbers, bit-for-bit)
        completed = [j for rt in self._batch for j in rt.jobs
                     if j.state is JobState.COMPLETED]
        tats = sorted(j.turnaround for j in completed)
        return SimResult(
            total_nodes=self.cfg.total_nodes,
            submitted=sum(t.submitted for t in batch),
            completed=len(completed),
            killed=sum(t.killed for t in batch),
            preemptions=sum(t.preemptions for t in batch),
            avg_turnaround=float(np.mean(tats)) if tats else 0.0,
            median_turnaround=float(np.median(tats)) if tats else 0.0,
            ws_unmet_node_seconds=sum(t.unmet_node_seconds
                                      for t in latency),
            ws_reclaim_events=sum(t.reclaim_events for t in latency),
            st_node_seconds_used=sum(t.node_seconds_used for t in batch),
            st_avg_alloc=sum(rt.alloc_seconds for rt in self._batch)
            / horizon if horizon > 0 else 0.0,
            ws_avg_alloc=sum(rt.alloc_seconds for rt in self._latency)
            / horizon if horizon > 0 else 0.0,
            util_timeline=downsample_timeline(self.timeline),
            ws_latency=latency[0].latency if latency else None,
            tenants=tenants,
            policy=self.policy_name,
            policy_state=self.svc.policy.state_snapshot(),
        )
