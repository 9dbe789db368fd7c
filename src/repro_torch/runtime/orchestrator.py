"""Runtime orchestrator: the paper's policies driving the port's workloads
(counterpart of ``repro.runtime.orchestrator``).

Glues the provision service (counts) + DevicePool (devices) + elastic
trainers (batch departments) + serving pools (latency departments). The
provisioning rules are the same objects the simulator uses — this is
Phoenix Cloud's layered architecture with the cluster replaced by a pool
of CUDA devices:

  WS load rises  -> autoscaler wants more replicas -> provision service
  grants free devices or FORCES a trainer to shrink (checkpoint-resize);
  WS load falls  -> replicas released -> idle devices flow back to the
  trainers per the cooperative policy, growing them at the next step
  boundary.

``PhoenixOrchestrator`` is the paper's two-department wiring (one trainer +
one serving pool over ``ResourceProvisionService``); ``MultiTenant
Orchestrator`` runs any department mix over ``TenantProvisionService`` with
a pluggable cooperative policy — the runtime twin of the N-department
``ConsolidationSim``.

With no ``devices`` the pool is every CUDA device (``DevicePool()``), and
it raises ``RuntimeError`` when there is none; the CPU is used only when
the caller lists it (``devices=["cpu"]``). A port ``ElasticTrainer``
trains on its batch group's devices (``repro_torch.runtime.elastic``): one
in this process, N as data-parallel ranks. Stub trainers and pools with
the same methods run any device count.

The port's own copy of ``repro.runtime.orchestrator`` with the same logic.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.core.cms import proxy_headroom_s
from repro_torch.core.nodes import NodeInventory
from repro_torch.core.provision import (ResourceProvisionService,
                                        TenantProvisionService)
from repro_torch.core.telemetry import NULL_TRACER, Tracer
from repro_torch.core.types import TenantSignals, TenantSpec
from repro_torch.runtime.device_pool import DevicePool
from repro_torch.runtime.elastic import ElasticTrainer
from repro_torch.runtime.serving_pool import ServingPool


class _BatchDept:
    """A batch department: an elastic trainer behind the CMS protocol."""

    def __init__(self, name: str, trainer: ElasticTrainer,
                 min_devices: int = 0):
        self.name = name
        self.trainer = trainer
        self.min_devices = max(min_devices, trainer.model_size)
        self.started = False


class _LatencyDept:
    """A latency department: a serving replica pool + optional SLO scaler."""

    def __init__(self, name: str, pool: ServingPool, slo_autoscaler=None):
        self.name = name
        self.pool = pool
        self.slo_autoscaler = slo_autoscaler
        # most recent latency percentile: measured (observe_latency) or
        # predicted by the SLO autoscaler at the realized replica count —
        # feeds the TenantSignals headroom channel for reclaim planning
        self.observed_latency_s: Optional[float] = None
        self.demand = 0                # last requested replica count


class MultiTenantOrchestrator:
    """N departments sharing one device pool under a cooperative policy.

    Register departments before ``start()``: each batch department wraps an
    ``ElasticTrainer`` (shrinks/grows by whole DP groups so TP collectives
    stay intact); each latency department wraps a ``ServingPool`` (one
    device per replica). Then drive latency departments with
    ``latency_tick``/``latency_tick_slo`` and batch ones with
    ``train_steps`` — grants, forced reclaims and idle reflows all run
    through the same ``TenantProvisionService`` the simulator uses.
    """

    def __init__(self, *, devices=None, policy="paper",
                 tracer: Optional[Tracer] = None, rack_size: int = 16):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.devs = DevicePool(devices, groups=())
        self.svc = TenantProvisionService(self.devs.total, policy=policy,
                                          tracer=self.tracer)
        # identified-node layer: the orchestrator always carries the
        # inventory so operators see node-level grants/losses (which node
        # each department holds, its failure domain and lifecycle state),
        # not bare counts
        self.inventory = NodeInventory(self.devs.total,
                                       rack_size=rack_size,
                                       tracer=self.tracer)
        self.svc.attach_inventory(self.inventory)
        self.batch: Dict[str, _BatchDept] = {}
        self.latency: Dict[str, _LatencyDept] = {}
        self.events: List[Dict] = []
        self._started = False
        # the runtime has no virtual clock: control intervals are the time
        # axis, one tick per latency_tick/train_steps call
        self._ticks = 0

    def _tick_clock(self):
        self._ticks += 1
        if self.tracer.enabled:
            self.tracer.now = float(self._ticks)

    # ------------------------------------------------------------ registry
    def add_batch(self, name: str, trainer: ElasticTrainer, *,
                  priority: int = 1, weight: float = 1.0,
                  min_devices: int = 0, bid_weight: Optional[float] = None,
                  budget: Optional[float] = None, bid_policy: str = "linear"
                  ) -> None:
        assert not self._started, "register departments before start()"
        dept = _BatchDept(name, trainer, min_devices)
        self.batch[name] = dept
        self.devs.add_group(name)
        self.svc.register_spec(
            TenantSpec(name, "batch", priority=priority, weight=weight,
                       floor=dept.min_devices, bid_weight=bid_weight,
                       budget=budget, bid_policy=bid_policy),
            on_grant=lambda n, d=dept: self._grant_batch(d, n),
            on_force_release=lambda n, d=dept: self._force_release_batch(
                d, n),
            signals=lambda nm=name: self._batch_signals(nm))

    def add_latency(self, name: str, pool: ServingPool, *,
                    priority: int = 0, weight: float = 1.0,
                    slo_autoscaler=None, floor: int = 0,
                    bid_weight: Optional[float] = None,
                    budget: Optional[float] = None,
                    bid_policy: str = "linear") -> None:
        assert not self._started, "register departments before start()"
        self.latency[name] = _LatencyDept(name, pool, slo_autoscaler)
        self.devs.add_group(name)
        self.svc.register_spec(
            TenantSpec(name, "latency", priority=priority, weight=weight,
                       floor=floor, bid_weight=bid_weight,
                       budget=budget, bid_policy=bid_policy),
            on_force_release=lambda n, nm=name: self._force_release_latency(
                nm, n),
            signals=lambda nm=name: self._latency_signals(nm))

    def market_state(self) -> Optional[Dict]:
        """JSON-safe market snapshot (budgets, remaining, spend ledger,
        clearing prices) when a budget engine is active, else None."""
        market = getattr(self.svc.policy, "market", None)
        return None if market is None else market.snapshot()

    # ------------------------------------------------------------- signals
    def observe_latency(self, name: str, latency_s: float) -> None:
        """Feed a measured serving-pool latency percentile; reclaim
        planners see ``slo_target - latency`` as this department's
        headroom from the next decision on."""
        self.latency[name].observed_latency_s = latency_s

    def _latency_signals(self, name: str) -> TenantSignals:
        dept = self.latency[name]
        rec = self.svc.tenants[name]
        slo = getattr(dept.slo_autoscaler, "slo", None)
        target = slo.latency_target_s if slo is not None else 0.0
        if dept.observed_latency_s is not None and target > 0.0:
            headroom = target - dept.observed_latency_s
        else:
            # the simulator WS CMS's zero-clamped surplus proxy, shared so
            # runtime and simulated slo_elastic bids can never diverge
            headroom = proxy_headroom_s(rec.alloc, dept.demand, target)
        return TenantSignals(
            name=name, kind="latency", alloc=rec.alloc, demand=dept.demand,
            weight=rec.weight, latency_headroom_s=headroom,
            slo_target_s=target,
            queue_depth=max(0, dept.demand - rec.alloc))

    def _batch_signals(self, name: str) -> TenantSignals:
        dept = self.batch[name]
        rec = self.svc.tenants[name]
        # preemption cost in node-seconds: shrinking costs one checkpoint-
        # resize round of the current step time per affected DP group
        step_s = float(getattr(dept.trainer, "last_step_time_s", 0.0) or 0.0)
        return TenantSignals(
            name=name, kind="batch", alloc=rec.alloc, demand=rec.demand,
            weight=rec.weight, preemption_cost_s=step_s,
            queue_depth=max(0, rec.demand - rec.alloc))

    # ------------------------------------------------------------- wiring
    def _grant_batch(self, dept: _BatchDept, n: int):
        self.devs.grant(dept.name, n)
        devs = self.devs.groups[dept.name]
        if dept.started:
            dept.trainer.resize(devs)
        elif len(devs) >= dept.min_devices and devs:
            dept.trainer.start(devs)
            dept.started = True
        self.events.append({"kind": "grant", "dept": dept.name,
                            "devices": n})

    def _force_release_batch(self, dept: _BatchDept, n: int) -> int:
        """Shrink the trainer by n devices, rounded UP to a whole DP group
        (TP width is preserved) — surplus stays idle and is re-granted."""
        tp = dept.trainer.model_size
        have = len(self.devs.groups[dept.name])
        groups = math.ceil(n / tp)
        max_groups = (have - dept.min_devices) // tp
        groups = min(groups, max_groups)
        take = groups * tp
        if take <= 0:
            return 0
        self.devs.reclaim(dept.name, take)
        if dept.started and self.devs.groups[dept.name]:
            dept.trainer.resize(self.devs.groups[dept.name])
        self.events.append({"kind": "shrink", "dept": dept.name,
                            "devices": take, "step": dept.trainer.step})
        return take

    def _force_release_latency(self, name: str, n: int) -> int:
        """A higher-priority claim takes n replicas from this department."""
        dept = self.latency[name]
        got = len(self.devs.reclaim(name, n))
        dept.pool.scale_to(self.devs.groups[name])
        self.events.append({"kind": "preempt", "dept": name, "devices": got})
        return got

    # ------------------------------------------------------------- control
    def start(self):
        """Initial provision: batch demand declared, idle flows per policy."""
        self._started = True
        for name, dept in self.batch.items():
            # declared demand = the trainer's max useful scale (model width
            # x global batch caps the data-parallel extent); demand-aware
            # policies split idle between departments from these
            t = dept.trainer
            useful = t.model_size * max(1, getattr(t, "global_batch", 1))
            self.svc.set_demand(name, min(self.devs.total, useful),
                                provision=False)
        self.svc.provision_idle()

    def latency_tick(self, name: str, offered_load_tokens: float):
        """One control interval for a latency department: autoscale replicas
        to the offered load (paper §III-C utilization rule)."""
        self._tick_clock()
        dept = self.latency[name]
        self._scale_latency(name,
                            dept.pool.desired_replicas(offered_load_tokens))

    def latency_tick_slo(self, name: str, rate_rps: float,
                         mean_service_s: float, scv_service: float = 1.0,
                         p99_service_s: Optional[float] = None):
        """One control interval driven by the department's latency SLO."""
        self._tick_clock()
        dept = self.latency[name]
        assert dept.slo_autoscaler is not None, \
            f"add_latency({name!r}, ..., slo_autoscaler=...) first"
        if p99_service_s is None:
            # gamma-tail estimate from the SCV; using the mean here would
            # make the predicted percentile systematically optimistic
            p99_service_s = mean_service_s * (
                1.0 + 2.33 * math.sqrt(max(scv_service, 0.0)))
        want = dept.slo_autoscaler.desired_nodes(
            rate_rps, mean_service_s, scv_service, p99_service_s,
            current=len(dept.pool.replicas))
        self._scale_latency(name, want)
        # refresh the headroom signal with the predicted percentile at the
        # replica count actually realized (a claim may have granted less);
        # an explicit observe_latency() call overrides it until next tick
        dept.observed_latency_s = dept.slo_autoscaler.predicted_latency_s(
            rate_rps, mean_service_s, scv_service, p99_service_s,
            len(dept.pool.replicas))

    def _scale_latency(self, name: str, want: int):
        dept = self.latency[name]
        if self.tracer.enabled and want != dept.demand:
            self.tracer.emit("autoscale", tenant=name, prev=dept.demand,
                             demand=want, source="slo_autoscaler"
                             if dept.slo_autoscaler is not None
                             else "utilization")
        dept.demand = want
        have = len(dept.pool.replicas)
        if want > have:
            got = self.svc.claim(name, want - have)
            self.devs.grant(name, got)
        elif want < have:
            give = have - want
            self.devs.reclaim(name, give)
            self.svc.release(name, give)
        dept.pool.scale_to(self.devs.groups[name])
        self.events.append({"kind": "scale", "dept": name,
                            "replicas": len(dept.pool.replicas)})

    def train_steps(self, name: str, n: int) -> Dict:
        self._tick_clock()
        return self.batch[name].trainer.train_steps(n)

    # ----------------------------------------------------- node lifecycle
    def nodes_of(self, name: str) -> List[int]:
        """Sorted node ids a department (or ``"free"``) currently holds."""
        return self.inventory.pool(name)

    def node_states(self) -> Dict[str, int]:
        """Cluster-wide lifecycle census, e.g. {"healthy": 14, ...}."""
        return self.inventory.state_counts()

    def fail_node(self, node_id: Optional[int] = None) -> int:
        """Take one node down (operator drill / chaos hook). Default is
        the lowest-id up node; the owning department's devices shrink
        through its own resize path, exactly as a forced reclaim would.
        Returns the failed node id."""
        self._tick_clock()
        inv = self.inventory
        if node_id is None:
            up = inv.up_ids()
            assert up, "no up node to fail"
            node_id = up[0]
        owner = inv.owner_of(node_id)
        # shrink the owner's devices BEFORE the count layer hears of the
        # failure: node_failed may immediately re-provision (demand-driven
        # policies), and grants must find the device already free
        if owner in self.latency:
            dept = self.latency[owner]
            self.devs.reclaim(owner, 1)
            dept.pool.scale_to(self.devs.groups[owner])
        elif owner in self.batch:
            dept = self.batch[owner]
            self.devs.reclaim(owner, 1)
            if dept.started and self.devs.groups[owner]:
                dept.trainer.resize(self.devs.groups[owner])
        self.svc.node_failed(owner, node=node_id)
        self.events.append({"kind": "node_fail", "node": node_id,
                            "dept": owner})
        return node_id

    def repair_node(self, node_id: Optional[int] = None) -> int:
        """Bring a failed node back (lowest-id down node by default); it
        re-enters the free pool and flows out per the idle policy."""
        self._tick_clock()
        node_id = self.svc.node_repaired(node=node_id)
        self.events.append({"kind": "node_repair", "node": node_id})
        return node_id


class PhoenixOrchestrator:
    """The paper's two-department wiring: one ST trainer + one WS pool."""

    def __init__(self, trainer: ElasticTrainer, pool: ServingPool, *,
                 devices=None, min_st_devices: int = 0,
                 slo_autoscaler=None):
        """slo_autoscaler: optional ``workloads.SLOAutoscaler``. When set,
        ``ws_tick_slo`` scales replicas from request-level load statistics
        against the latency SLO instead of the §III-C utilization rule."""
        self.devs = DevicePool(devices)
        self.rps = ResourceProvisionService(self.devs.total)
        self.trainer = trainer
        self.pool = pool
        self.min_st = max(min_st_devices, trainer.model_size)
        self.slo_autoscaler = slo_autoscaler
        self.rps.force_st_release = self._force_st_release
        self.rps.on_grant_st = self._grant_st
        self.events: List[Dict] = []
        self._started = False

    # ------------------------------------------------------------- wiring
    def _grant_st(self, n: int):
        self.devs.grant_st(n)
        if self._started:
            self._resize_trainer()
        else:
            self.trainer.start(self.devs.st)
            self._started = True

    def _force_st_release(self, n: int) -> int:
        """Shrink the trainer by n devices, rounded UP to a whole DP group
        (TP width is preserved) — surplus stays idle and is re-granted."""
        tp = self.trainer.model_size
        groups = math.ceil(n / tp)
        max_groups = (len(self.devs.st) - self.min_st) // tp
        groups = min(groups, max_groups)
        take = groups * tp
        if take <= 0:
            return 0
        self.devs.reclaim_st(take)
        self._resize_trainer()
        self.events.append({"kind": "st_shrink", "devices": take,
                            "step": self.trainer.step})
        return take

    def _resize_trainer(self):
        if self._started and self.devs.st:
            self.trainer.resize(self.devs.st)

    # ------------------------------------------------------------- control
    def start(self):
        self.rps.provision_idle_to_st()

    def ws_tick(self, offered_load_tokens: float):
        """One WS control interval: autoscale replicas to the offered load
        (paper §III-C utilization rule)."""
        self._scale_ws(self.pool.desired_replicas(offered_load_tokens))

    def ws_tick_slo(self, rate_rps: float, mean_service_s: float,
                    scv_service: float = 1.0,
                    p99_service_s: Optional[float] = None):
        """One WS control interval driven by the latency SLO.

        Takes the window's request-level load statistics (arrival rate and
        service-time shape, e.g. from ``ServiceTimeModel.service_times`` over
        the window's token counts) and asks the SLO autoscaler for the
        replica count whose predicted latency percentile meets the target.
        """
        assert self.slo_autoscaler is not None, \
            "construct PhoenixOrchestrator(..., slo_autoscaler=...) first"
        if p99_service_s is None:
            # gamma-tail estimate from the SCV; using the mean here would
            # make the predicted percentile systematically optimistic
            p99_service_s = mean_service_s * (
                1.0 + 2.33 * math.sqrt(max(scv_service, 0.0)))
        want = self.slo_autoscaler.desired_nodes(
            rate_rps, mean_service_s, scv_service, p99_service_s,
            current=len(self.pool.replicas))
        self._scale_ws(want)

    def _scale_ws(self, want: int):
        have = len(self.pool.replicas)
        if want > have:
            got = self.rps.ws_request(want - have)
            self.devs.grant_ws(got)
        elif want < have:
            give = have - want
            self.devs.release_ws(give)
            self.rps.ws_release(give)
        self.pool.scale_to(self.devs.ws)
        self.events.append({"kind": "ws_scale", "replicas":
                            len(self.pool.replicas)})

    def train_steps(self, n: int) -> Dict:
        return self.trainer.train_steps(n)
