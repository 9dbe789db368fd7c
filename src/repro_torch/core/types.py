"""Core entity types of Phoenix Cloud (paper §II).

The unit of provisioning is a *node*: in the 2009 paper a Xen VM / physical
node, in the runtime bridge a TPU device slice (``runtime/device_pool.py``).
All times are virtual seconds in the discrete-event simulator.

The port's own copy of ``repro.core.types`` with the same logic.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable


class JobState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    KILLED = "killed"
    PREEMPTED = "preempted"   # beyond-paper checkpoint-preempt mode


@dataclass
class Job:
    """An HPC batch job (ST CMS workload)."""
    job_id: int
    submit_time: float
    size: int                 # nodes requested
    runtime: float            # required service seconds (on `size` nodes)
    state: JobState = JobState.QUEUED
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    done_work: float = 0.0    # completed service seconds (checkpoint mode)
    kills: int = 0
    # set in checkpoint-preempt mode: work surviving the last preemption
    checkpointed_work: float = 0.0

    @property
    def turnaround(self) -> Optional[float]:
        if self.end_time is None or self.state is not JobState.COMPLETED:
            return None
        return self.end_time - self.submit_time

    def remaining(self) -> float:
        return max(0.0, self.runtime - self.checkpointed_work)


@dataclass
class Request:
    """One WS request (request-level workload model, ``repro.workloads``).

    The 2009 paper models WS load as an instance-demand timeseries; the
    follow-up PhoenixCloud evaluation (arXiv:1006.1401) is per-request. A
    request carries token counts so continuous-batching service times can be
    derived from ``serving/batching.py``'s model.
    """
    req_id: int
    arrival: float            # virtual seconds
    prompt_tokens: int
    decode_tokens: int
    start: Optional[float] = None
    finish: Optional[float] = None

    @property
    def latency(self) -> Optional[float]:
        if self.finish is None:
            return None
        return self.finish - self.arrival


@dataclass(frozen=True)
class SLOConfig:
    """Latency service-level objective for the WS department.

    The SLO is stated on a latency percentile (default p99): the autoscaler
    provisions so the predicted percentile stays under ``latency_target_s``,
    and the queue simulator reports the fraction of requests exceeding it
    (``violation`` = request latency > latency_target_s).
    """
    latency_target_s: float = 30.0
    percentile: float = 99.0
    # campaign bookkeeping: a scenario cell "meets SLO" iff the realized
    # violation rate stays under this fraction.
    max_violation_rate: float = 0.01


@runtime_checkable
class WSDemandProvider(Protocol):
    """Anything that can stand in for the raw ``ws_demand`` timeseries.

    ``ConsolidationSim`` accepts either a plain ``[(t, n), ...]`` list or a
    provider. Providers that also implement ``realized_metrics`` get called
    back with the realized WS allocation timeline so request-level latency
    can be measured against what the cluster actually granted.
    """

    def demand_events(self, horizon: float) -> List[Tuple[float, int]]:
        """Planned node-demand change events over [0, horizon)."""
        ...


@dataclass
class TenantSignals:
    """Per-tenant runtime snapshot consumed by reclaim planners.

    The two-phase ``PolicyEngine`` (core/policies.py) plans *who gives up
    nodes* from these signals instead of a fixed priority chain: a latency
    department far under its SLO target is a cheap victim, a batch
    department about to checkpoint a huge job is an expensive one, and an
    auction engine turns ``bid`` into both the reclaim order and the idle
    clearing price. Signals are produced by the CMSes (``CMSBase.signals``)
    in the simulator and by ``MultiTenantOrchestrator`` from real
    serving-pool latency in the runtime — the same vocabulary either way.
    """
    name: str
    kind: str = "batch"               # "batch" | "latency"
    alloc: int = 0
    demand: int = 0
    weight: float = 1.0
    # latency tenants: seconds of slack between the SLO target and the
    # currently observed/predicted latency percentile (positive = under
    # target, safe to drain; negative = already violating)
    latency_headroom_s: float = 0.0
    slo_target_s: float = 0.0
    # batch tenants: queued jobs; latency tenants: replica shortfall
    queue_depth: int = 0
    # estimated seconds of work lost per node freed by forced reclaim
    # (0 while idle nodes can absorb the reclaim)
    preemption_cost_s: float = 0.0
    # auction engines: this interval's bid (default weight x unmet demand)
    bid: float = 0.0

    @property
    def unmet(self) -> int:
        return max(0, self.demand - self.alloc)


# MarketState.ledger / .clearing_prices retain at most this many samples
# (aggregates — spend, remaining, transactions — are always exact)
MARKET_SAMPLES_MAX = 64


@dataclass
class MarketState:
    """Per-run money bookkeeping of the budget-constrained market engines.

    Tenants declare a ``budget`` (tokens spendable across the horizon;
    ``None`` = unlimited). The market engines (``budget_auction``,
    ``second_price`` in core/policies.py) debit it whenever acquiring a
    node displaces someone else's claim on it: idle purchases at the
    interval's clearing price, forced reclaims at the displaced victim's
    per-node bid (beyond the claimant's free ``floor`` entitlement).
    Nodes granted straight from the free pool are free — nobody was
    outbid for them. The state is threaded through ``claim()``/
    ``provision_idle`` (the engine carries it across both phases) and
    lands, JSON-safe, in ``SimResult.policy_state["market"]`` and the v5
    campaign artifact.
    """
    budgets: Dict[str, Optional[float]] = field(default_factory=dict)
    remaining: Dict[str, float] = field(default_factory=dict)  # inf = no cap
    spend: Dict[str, float] = field(default_factory=dict)
    transactions: int = 0
    # capped inspection samples; aggregates above are exact, and entries
    # dropped past the cap are COUNTED (no silent caps: a capped trace
    # must be distinguishable from a short one)
    ledger: List[Dict] = field(default_factory=list)
    clearing_prices: List[float] = field(default_factory=list)
    ledger_dropped: int = 0
    clearing_prices_dropped: int = 0
    # telemetry sink (core/telemetry.py); every debit lands in the trace
    # even after the ledger sample cap. Excluded from ==/repr: two runs
    # with identical money flows are equal regardless of tracing.
    tracer: object = field(default=None, repr=False, compare=False)

    def register(self, name: str, budget: Optional[float]) -> None:
        """First sight of a tenant: seed its remaining budget. Later calls
        are no-ops — the pot never refills mid-run."""
        if name in self.budgets:
            return
        self.budgets[name] = None if budget is None else float(budget)
        self.remaining[name] = math.inf if budget is None else float(budget)
        self.spend[name] = 0.0

    def affordable_nodes(self, name: str, unit_price: float) -> int:
        """How many nodes this tenant can pay for at ``unit_price``."""
        rem = self.remaining.get(name, math.inf)
        if unit_price <= 0.0 or math.isinf(rem):
            return 1 << 30
        return int(math.floor(rem / unit_price + 1e-9))

    def debit(self, name: str, nodes: int, unit_price: float,
              kind: str, interval: int) -> float:
        """Charge ``nodes x unit_price`` against the tenant's budget and
        record it in the (capped) ledger. Returns the cost."""
        cost = float(nodes) * float(unit_price)
        if nodes <= 0 or cost <= 0.0:
            return 0.0
        self.remaining[name] -= cost          # inf stays inf (unlimited)
        self.spend[name] = self.spend.get(name, 0.0) + cost
        self.transactions += 1
        if len(self.ledger) < MARKET_SAMPLES_MAX:
            self.ledger.append({"tenant": name, "nodes": int(nodes),
                                "unit_price": float(unit_price),
                                "cost": cost, "kind": kind,
                                "interval": int(interval)})
        else:
            self.ledger_dropped += 1
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.emit("debit", tenant=name, nodes=int(nodes),
                             unit_price=float(unit_price), cost=cost,
                             kind=kind, interval=int(interval))
        return cost

    def note_price(self, price: float) -> None:
        if len(self.clearing_prices) < MARKET_SAMPLES_MAX:
            self.clearing_prices.append(float(price))
        else:
            self.clearing_prices_dropped += 1

    def snapshot(self) -> Dict:
        """JSON-safe snapshot (unlimited budgets serialize as null)."""
        return {
            "budgets": dict(self.budgets),
            "remaining": {n: (None if math.isinf(v) else v)
                          for n, v in self.remaining.items()},
            "spend": dict(self.spend),
            "transactions": self.transactions,
            "ledger": [dict(e) for e in self.ledger],
            "clearing_prices": list(self.clearing_prices),
            "dropped_entries": {"ledger": self.ledger_dropped,
                                "clearing_prices":
                                    self.clearing_prices_dropped},
        }


@dataclass
class TenantSpec:
    """Declaration of one department (tenant) sharing the cluster.

    The 2009 paper wires exactly two departments — one HPC/batch (ST) and
    one Web-service (WS). ``TenantSpec`` is the N-department generalization:
    a registry of these specs drives ``TenantProvisionService``
    (core/provision.py), ``ConsolidationSim`` and the runtime orchestrator.

    kind:
      * ``"batch"``    — throughput-oriented CMS (an ST department): demand
        comes from a job trace (``jobs``); receives idle nodes passively.
      * ``"latency"``  — latency-sensitive CMS (a WS department): demand
        comes from a node-demand timeseries or a ``WSDemandProvider``
        (``demand``); claims urgently, preempting lower-priority tenants.

    priority: lower number = higher priority, used both for urgent claims
    (who may preempt whom) and for idle distribution order. A best-effort
    department is simply a batch tenant with the largest priority number.

    weight: relative share for proportional-share policies (ignored by the
    paper's policy).

    floor: nodes forced reclaim may never take (a latency department's
    minimum replica set survives any preemption chain; 0 = fully drainable,
    the paper's behaviour).

    bid_weight: auction engines bid ``bid_weight x unmet demand`` per
    interval; defaults to ``weight`` when unset, so a department can value
    marginal nodes differently from its proportional share.

    budget: tokens this department may spend across the whole horizon
    under the budget-constrained market engines (``budget_auction``,
    ``second_price``): idle purchases and forced reclaims debit it (see
    :class:`MarketState`); once broke the department falls back to its
    ``floor``. ``None`` = unlimited (every non-market engine ignores it).

    bid_policy: how the per-interval bid is derived from runtime signals —
    ``"linear"`` (bid_weight x unmet demand, the default) or
    ``"slo_elastic"`` (the bid rises as latency headroom shrinks: scaled
    by 1x at full headroom up to 2x at zero headroom and beyond when the
    SLO is violated, so a department under latency pressure outbids
    comfortable ones).
    """
    name: str
    kind: str = "batch"                    # "batch" | "latency"
    priority: int = 0
    weight: float = 1.0
    floor: int = 0
    bid_weight: Optional[float] = None
    budget: Optional[float] = None
    bid_policy: str = "linear"             # "linear" | "slo_elastic"
    # demand sources --------------------------------------------------
    jobs: Optional[List["Job"]] = None     # batch: HPC job trace
    demand: object = None                  # latency: [(t, n), ...] or provider
    slo: Optional[SLOConfig] = None        # latency: SLO for the autoscaler

    def __post_init__(self):
        assert self.kind in ("batch", "latency"), self.kind
        assert self.bid_policy in ("linear", "slo_elastic"), self.bid_policy


class EventKind(enum.Enum):
    JOB_SUBMIT = 1
    JOB_FINISH = 2
    WS_DEMAND = 3
    REALLOC_DONE = 4
    NODE_FAIL = 5
    NODE_REPAIR = 6
    HEARTBEAT = 7
    DRAIN_DONE = 8     # a reclaim step's drain window elapsed


@dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: EventKind = field(compare=False)
    payload: object = field(compare=False, default=None)


@dataclass
class SimConfig:
    """Knobs of the consolidation simulation (paper §III + beyond-paper)."""
    total_nodes: int = 208
    # seconds to repurpose a node ST->WS (paper: "only seconds" — software
    # pre-deployed); charged before WS can use reclaimed nodes.
    reallocation_latency: float = 5.0
    # kill (paper) loses all work; checkpoint (beyond-paper) requeues the job
    # with checkpointed progress, paying checkpoint_cost seconds.
    preempt_mode: str = "kill"            # kill | checkpoint
    checkpoint_cost: float = 30.0
    scheduler: str = "first_fit"          # first_fit | fcfs | easy_backfill
    # fault injection (large-scale runnability): mean time between node
    # failures across the whole cluster; 0 disables. The legacy anonymous
    # path; `faults` below supersedes it when set.
    node_mtbf: float = 0.0
    node_repair_time: float = 3600.0
    # declarative fault injection (core/faults.py FaultSpec): builds a
    # NodeInventory (identified nodes, failure domains, per-node state
    # machines) and the profile's injector. The degenerate
    # FaultSpec("independent", seed=None) reproduces the node_mtbf path
    # bit-for-bit. Typed as object to keep core/types dependency-free.
    faults: Optional[object] = None
    # forced-reclaim drain window in seconds: every reclaim step's nodes
    # serve NEITHER tenant for this long before the claimant gets them
    # (0 = instant handover, the paper's assumption). The active window is
    # max(drain_time_s, faults.drain_time_s).
    drain_time_s: float = 0.0
    # straggler mitigation: fraction of job launches that straggle, slowdown
    # factor, and whether speculative relaunch is enabled.
    straggler_frac: float = 0.0
    straggler_slowdown: float = 2.0
    speculative_relaunch: bool = True
    seed: int = 0
