"""Vectorized, sharded, resumable scenario campaign runner.

Sweeps (policy x department-mix x arrival process x cluster size x SLO)
grids over the consolidation simulator: each cell runs the full Phoenix
pipeline — arrival trace -> SLO autoscaler -> ConsolidationSim under the
chosen cooperative policy and department mix -> realized request latency —
then per-cell metric vectors are stacked into numpy arrays for batched
reduction (marginal means over every axis). One JSON artifact comes out,
consumed by ``benchmarks/paper_figs.py`` and CI's smoke campaigns.

    PYTHONPATH=src python -m repro_torch.workloads.campaign --grid tiny \
        --out campaign.json --workers 2
    PYTHONPATH=src python -m repro_torch.workloads.campaign --grid mix_tiny \
        --device cpu

Sharded / resumable execution for the big grids (``full`` is ~4k cells):
every finished cell is streamed as one JSON line to a *spool* file, keyed
by a content hash of the entire ``ScenarioCell``; ``--resume`` skips cells
already spooled and the ``merge`` subcommand folds shard spools into the
final artifact (reductions are recomputed from the spooled rows, never
from in-memory state, so a merge of N shards is bit-identical to a
single-shot run):

    campaign --grid full --shard 0/8 --spool s0.jsonl   # one per host
    campaign --grid full --shard 1/8 --spool s1.jsonl --resume
    campaign merge --grid full --out full.json s*.jsonl

Department mixes (``--grid mix*``): ``paper2`` is the paper's 1 HPC + 1 WS
wiring (the degenerate case); ``2hpc2ws`` consolidates 2 HPC + 2
request-level WS departments; ``2hpc2ws1be`` adds a best-effort batch
tenant. Cells are independent; ``--workers N`` fans them out over
processes (spawn: a forked child cannot use a CUDA context its parent
made, and the kernel is built once in the parent before the pool starts),
falling back to in-process execution if a pool cannot start.

WS request queues (v6): cells run in chunks and each chunk's queues —
every tenant's realized allocation, constant and piecewise capacity alike
— flush as ONE launch of the ``kernels.queue_core`` CUDA kernel, every
job one block of it (``queue_impl='batched'``, float32, golden tolerance
vs the exact paths; the per-impl split lands in the artifact's
``throughput.queue_impls``). ``--device`` (default ``cuda``) says where
the batched flush runs; ``cpu`` runs the kernel's plain PyTorch version,
and a run asked for the card raises when there is none.
``--queue-impl exact`` keeps the inline per-tenant float64 numpy sweep.
Batched metrics are composition-independent — a job's row depends on
that job alone — so chunking/sharding never changes a row.

Fault profiles (v7): ``--fault-profile`` / the ``fault_profile`` cell
axis injects node failures from ``core.faults.FAULT_PROFILES`` (``none``
keeps cells fault-free; ``independent`` | ``rack_corr`` | ``flapping``).
The fault stream is seeded independently of the policy/budget axes, so
robustness frontiers — completions and WS p99 vs fault severity, per
policy engine — are apples-to-apples across every other axis. The
``faults_tiny`` grid is mix_tiny x every profile.

The port's copy of ``repro.workloads.campaign``: the same logic and the
same ``SCHEMA`` (so the same cell keys and trace file names), with the
device threaded through to the queue flush.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from concurrent.futures.process import BrokenProcessPool
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FAULT_PROFILES, get_fault_spec
from repro_torch.core.policies import POLICIES
from repro_torch.core.simulator import ConsolidationSim
from repro_torch.core.telemetry import Tracer, summarize_events
from repro_torch.core.traces import synthetic_sdsc_blue
from repro_torch.core.types import SimConfig, SLOConfig, TenantSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.queue_core import ops as queue_core_ops
from repro_torch.serving.batching import ServiceTimeModel
from repro_torch.workloads.arrivals import GENERATORS, make_trace
from repro_torch.workloads.autoscaler import RequestWorkload
from repro_torch.workloads.queueing import (QueueJob, SIM_COUNTERS, counters_delta,
                                      simulate_queue_batch,
                                      snapshot_counters)

SCHEMA = "phoenix-campaign-v7"

# cells dispatched per batched queue flush: every WS tenant queue from a
# chunk of sims rides one kernel launch (bigger chunks amortize better;
# smaller chunks keep spool streaming fine-grained)
QUEUE_CHUNK = 8

# department mixes: name -> (n_hpc, n_ws, n_best_effort)
MIXES: Dict[str, tuple] = {
    "paper2": (1, 1, 0),        # the paper's wiring (degenerate 2-tenant)
    "2hpc2ws": (2, 2, 0),
    "2hpc2ws1be": (2, 2, 1),
}


@dataclasses.dataclass(frozen=True)
class ScenarioCell:
    """One point of the campaign grid (fully picklable)."""
    preempt: str                 # kill | checkpoint
    scheduler: str               # first_fit | fcfs | easy_backfill
    arrival: str                 # key into workloads.arrivals.GENERATORS
    total_nodes: int
    slo_target_s: float
    rate_rps: float = 2.0        # mean WS arrival rate (split across WS depts)
    horizon_s: float = 7200.0
    n_jobs: int = 80             # total HPC jobs (split across HPC depts)
    st_max_nodes: int = 32       # batch-trace size calibration
    policy: str = "paper"        # key into core.policies.POLICIES
    mix: str = "paper2"          # key into MIXES
    # per-department market budget (tokens over the horizon); 0 = unlimited.
    # When set, latency departments bid slo_elastic (v5 market axis).
    budget: float = 0.0
    # WS request-queue backend (v6): "batched" defers every tenant queue to
    # its chunk's one queue_core kernel launch (float32, golden tolerance);
    # "exact" keeps the inline per-tenant float64 numpy sweep.
    queue_impl: str = "batched"
    # fault-injection profile (v7): key into core.faults.FAULT_PROFILES;
    # "none" keeps the cell fault-free (the pre-v7 behaviour)
    fault_profile: str = "none"
    seed: int = 0

    def cell_id(self) -> str:
        """Human-readable id. Non-default load knobs are appended so custom
        grids varying them don't collide (the spool/resume key is the full
        content hash from ``cell_key`` regardless)."""
        base = (f"{self.preempt}-{self.scheduler}-{self.arrival}"
                f"-n{self.total_nodes}-slo{self.slo_target_s:g}"
                f"-s{self.seed}")
        if self.policy != "paper" or self.mix != "paper2":
            base += f"-{self.policy}-{self.mix}"
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        extra = [(tag, getattr(self, name))
                 for tag, name in (("r", "rate_rps"), ("h", "horizon_s"),
                                   ("j", "n_jobs"), ("x", "st_max_nodes"),
                                   ("b", "budget"), ("q", "queue_impl"),
                                   ("f", "fault_profile"))
                 if getattr(self, name) != defaults[name]]
        if extra:
            base += "".join(f"-{tag}{v:g}" if isinstance(v, float)
                            else f"-{tag}{v}" for tag, v in extra)
        return base

    def cell_key(self) -> str:
        """Content hash of every field AND the artifact schema — the
        spool/resume/cache key. Including the schema means spools written
        by an older row format can never be silently reused in a
        newer-schema artifact (their rows would lack the new columns)."""
        blob = json.dumps({"schema": SCHEMA, **dataclasses.asdict(self)},
                          sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


# metric columns extracted per cell, in a fixed order so the reduction is
# one stacked [n_cells, n_metrics] array
METRIC_KEYS = ("completed", "killed", "preemptions", "avg_turnaround_s",
               "ws_p50_s", "ws_p95_s", "ws_p99_s", "ws_violation_rate",
               "ws_unserved", "ws_unmet_node_seconds", "ws_peak_nodes",
               "st_avg_alloc", "ws_avg_alloc", "queue_sim_s", "wall_s")
# the subset reductions marginalize over: deterministic simulation outcomes
# only, so a merge of shard spools is bit-identical to a single-shot run
# (timing lives per-cell and in the artifact's `throughput` section)
REDUCE_KEYS = tuple(k for k in METRIC_KEYS
                    if k not in ("queue_sim_s", "wall_s"))
# axes a reduction marginalizes over
AXIS_KEYS = ("preempt", "scheduler", "arrival", "total_nodes",
             "slo_target_s", "policy", "mix", "budget", "fault_profile")


def _policy_axis(policies: Optional[Sequence[str]],
                 default: Sequence[str]) -> List[str]:
    """Validate an explicit ``--policy`` subset against the registry."""
    if policies is None:
        return list(default)
    unknown = [p for p in policies if p not in POLICIES]
    if unknown:
        raise ValueError(f"unknown policies {unknown}; "
                         f"have {sorted(POLICIES)}")
    return list(policies)


def make_grid(name: str, seed: int = 0,
              policies: Optional[Sequence[str]] = None,
              budget: float = 0.0,
              queue_impl: Optional[str] = None,
              fault_profile: Optional[str] = None) -> List[ScenarioCell]:
    """Named grids. `tiny` is the CI smoke grid (8 cells, < 60 s serial);
    `mix_tiny` smokes the policy x department-mix matrix; `faults_tiny`
    crosses mix_tiny with every fault profile. ``policies`` overrides
    each grid's policy axis (CLI ``--policy a,b,c``); ``budget`` sets
    every cell's per-department market budget (CLI ``--budget``, 0 =
    unlimited); ``queue_impl`` overrides every cell's WS queue backend
    (CLI ``--queue-impl batched|exact``); ``fault_profile`` overrides
    every cell's fault-injection profile (CLI ``--fault-profile``, a key
    of ``core.faults.FAULT_PROFILES``)."""
    cells = _make_grid_cells(name, seed, policies)
    if budget:
        cells = [dataclasses.replace(c, budget=budget) for c in cells]
    if queue_impl is not None:
        if queue_impl not in ("batched", "exact"):
            raise ValueError(f"unknown queue_impl {queue_impl!r}; "
                             "have batched/exact")
        cells = [dataclasses.replace(c, queue_impl=queue_impl)
                 for c in cells]
    if fault_profile is not None:
        get_fault_spec(fault_profile)       # raises on unknown profile
        cells = [dataclasses.replace(c, fault_profile=fault_profile)
                 for c in cells]
    return cells


def _make_grid_cells(name: str, seed: int,
                     policies: Optional[Sequence[str]]) -> List[ScenarioCell]:
    if name == "tiny":
        pols = _policy_axis(policies, ["paper"])
        return [ScenarioCell(preempt=p, scheduler="first_fit", arrival=a,
                             total_nodes=n, slo_target_s=30.0, policy=pol,
                             seed=seed)
                for p in ("kill", "checkpoint")
                for a in ("poisson", "flash_crowd")
                for n in (48, 64)
                for pol in pols]
    if name == "small":
        pols = _policy_axis(policies, ["paper"])
        return [ScenarioCell(preempt=p, scheduler=s, arrival=a,
                             total_nodes=n, slo_target_s=slo, policy=pol,
                             seed=seed)
                for p in ("kill", "checkpoint")
                for s in ("first_fit", "easy_backfill")
                for a in ("poisson", "mmpp", "flash_crowd")
                for n in (48, 64)
                for slo in (30.0,)
                for pol in pols]
    if name == "mix_tiny":
        return [ScenarioCell(preempt="kill", scheduler="first_fit",
                             arrival="poisson", total_nodes=96,
                             slo_target_s=30.0, policy=pol, mix="2hpc2ws",
                             seed=seed)
                for pol in _policy_axis(policies, sorted(POLICIES))]
    if name == "faults_tiny":
        # robustness frontier: mix_tiny's policy axis x every fault
        # profile (the "none" column is the fault-free baseline)
        return [ScenarioCell(preempt="kill", scheduler="first_fit",
                             arrival="poisson", total_nodes=96,
                             slo_target_s=30.0, policy=pol, mix="2hpc2ws",
                             fault_profile=fp, seed=seed)
                for pol in _policy_axis(policies, sorted(POLICIES))
                for fp in sorted(FAULT_PROFILES)]
    if name == "mix":
        return [ScenarioCell(preempt=p, scheduler="first_fit",
                             arrival="flash_crowd", total_nodes=n,
                             slo_target_s=30.0, policy=pol, mix=m, seed=seed)
                for p in ("kill", "checkpoint")
                for pol in _policy_axis(policies, sorted(POLICIES))
                for m in ("2hpc2ws", "2hpc2ws1be")
                for n in (96, 128)]
    if name == "full":
        return [ScenarioCell(preempt=p, scheduler=s, arrival=a,
                             total_nodes=n, slo_target_s=slo,
                             horizon_s=14400.0, n_jobs=160, policy=pol,
                             mix=m, seed=seed)
                for p in ("kill", "checkpoint")
                for s in ("first_fit", "fcfs", "easy_backfill")
                for a in sorted(GENERATORS)
                for n in (40, 48, 64, 96)
                for slo in (20.0, 30.0, 60.0)
                for pol in _policy_axis(policies, sorted(POLICIES))
                for m in sorted(MIXES)]
    raise ValueError(f"unknown grid {name!r}; "
                     f"have tiny/small/mix_tiny/faults_tiny/mix/full")


def shard_cells(cells: Sequence[ScenarioCell],
                shard: Optional[str]) -> List[ScenarioCell]:
    """Deterministic round-robin partition: ``--shard i/N`` keeps cells at
    grid index i, i+N, i+2N, ... so every shard sees a representative slice
    of the axes (not a contiguous block of one policy)."""
    if not shard:
        return list(cells)
    try:
        idx_s, n_s = shard.split("/")
        idx, n = int(idx_s), int(n_s)
    except ValueError as e:
        raise ValueError(f"bad --shard {shard!r}; expected i/N") from e
    if not (n >= 1 and 0 <= idx < n):
        raise ValueError(f"bad --shard {shard!r}; need 0 <= i < N")
    return [c for j, c in enumerate(cells) if j % n == idx]


def make_tenants(cell: ScenarioCell) -> List[TenantSpec]:
    """Build the department mix for one cell: HPC departments split the job
    trace, WS departments split the request rate, an optional best-effort
    batch tenant rides at the lowest priority."""
    n_hpc, n_ws, n_be = MIXES[cell.mix]
    # market axis (v5): a finite budget makes every department pay for
    # nodes under the budget engines; latency departments then also bid
    # slo_elastic so urgency shapes the clearing prices
    budget = cell.budget if cell.budget > 0 else None
    bid_policy = "slo_elastic" if budget is not None else "linear"
    specs: List[TenantSpec] = []
    for i in range(n_ws):
        trace = make_trace(cell.arrival, cell.rate_rps / n_ws,
                           cell.horizon_s, cell.seed + 101 * i)
        specs.append(TenantSpec(
            f"ws-{i}", "latency", priority=i,
            budget=budget, bid_policy=bid_policy,
            slo=SLOConfig(latency_target_s=cell.slo_target_s),
            demand=RequestWorkload(
                trace=trace, model=ServiceTimeModel(),
                slo=SLOConfig(latency_target_s=cell.slo_target_s))))
    for i in range(n_hpc):
        jobs = synthetic_sdsc_blue(seed=cell.seed + 31 * i,
                                   n_jobs=max(1, cell.n_jobs // n_hpc),
                                   horizon=cell.horizon_s,
                                   max_nodes=cell.st_max_nodes)
        specs.append(TenantSpec(
            f"hpc-{i}", "batch", priority=n_ws + i,
            weight=float(n_hpc - i), budget=budget, jobs=jobs))
    for i in range(n_be):
        jobs = synthetic_sdsc_blue(seed=cell.seed + 997 + i,
                                   n_jobs=max(1, cell.n_jobs // 4),
                                   horizon=cell.horizon_s,
                                   max_nodes=max(4, cell.st_max_nodes // 4))
        specs.append(TenantSpec(
            f"be-{i}", "batch", priority=100 + i, weight=0.5,
            budget=budget, jobs=jobs))
    return specs


class _PendingCell:
    """A cell whose consolidation sim has run but whose WS request queues
    are still waiting for the chunk's batched device dispatch."""

    __slots__ = ("cell", "tracer", "res", "names", "jobs", "ws_requests",
                 "peak", "queue_acct", "wall_start_s")

    def __init__(self, cell, tracer, res, names, jobs, ws_requests, peak,
                 queue_acct, wall_start_s):
        self.cell = cell
        self.tracer = tracer
        self.res = res
        self.names = names          # tenant name per deferred job
        self.jobs = jobs            # List[QueueJob], same order
        self.ws_requests = ws_requests
        self.peak = peak
        self.queue_acct = queue_acct    # counters delta of the start phase
        self.wall_start_s = wall_start_s


def _cell_start(cell: ScenarioCell,
                trace_dir: Optional[str] = None) -> _PendingCell:
    """Run one scenario's consolidation sim, deferring the WS request-queue
    sims (``queue_impl='batched'``) so a chunk of cells can flush them in
    one kernel launch."""
    t0 = time.time()
    q0 = snapshot_counters()
    defer = cell.queue_impl == "batched"
    tracer = None
    if trace_dir is not None:
        tracer = Tracer(meta={"cell_id": cell.cell_id(),
                              "cell_key": cell.cell_key(),
                              "schema": SCHEMA})
    if tracer is not None and cell.fault_profile != "none":
        tracer.meta["fault_profile"] = cell.fault_profile
    cfg = SimConfig(total_nodes=cell.total_nodes,
                    preempt_mode=cell.preempt,
                    scheduler=cell.scheduler, seed=cell.seed,
                    faults=get_fault_spec(cell.fault_profile))
    if cell.mix == "paper2" and cell.policy == "paper":
        # the degenerate 2-tenant path (bit-identical to the seed pipeline)
        jobs = synthetic_sdsc_blue(seed=cell.seed, n_jobs=cell.n_jobs,
                                   horizon=cell.horizon_s,
                                   max_nodes=cell.st_max_nodes)
        trace = make_trace(cell.arrival, cell.rate_rps, cell.horizon_s,
                           cell.seed)
        workload = RequestWorkload(
            trace=trace, model=ServiceTimeModel(),
            slo=SLOConfig(latency_target_s=cell.slo_target_s))
        sim = ConsolidationSim(cfg, jobs, workload, horizon=cell.horizon_s,
                               tracer=tracer, defer_queue=defer)
        ws_requests = len(trace)
        peak = max((n for _, n in workload.demand_events(cell.horizon_s)),
                   default=0)
    else:
        tenants = make_tenants(cell)
        sim = ConsolidationSim(cfg, horizon=cell.horizon_s, tenants=tenants,
                               policy=cell.policy, tracer=tracer,
                               defer_queue=defer)
        ws_requests = sum(len(s.demand.trace) for s in tenants
                          if s.kind == "latency")
        peak = sum(max((n for _, n in s.demand.demand_events(cell.horizon_s)),
                       default=0)
                   for s in tenants if s.kind == "latency")
    res = sim.run()

    names: List[str] = []
    qjobs: List[QueueJob] = []
    for name, provider, alloc_events in sim.deferred_queue:
        if not all(hasattr(provider, a) for a in ("trace", "model", "slo")):
            # unknown provider: honor the deferral contract inline
            res.tenants[name].latency = provider.realized_metrics(
                alloc_events, horizon=cell.horizon_s)
            continue
        names.append(name)
        qjobs.append(QueueJob(trace=provider.trace,
                              capacity_events=tuple(alloc_events),
                              model=provider.model, slo=provider.slo,
                              horizon=cell.horizon_s))
    return _PendingCell(cell, tracer, res, names, qjobs, ws_requests, peak,
                        counters_delta(q0), time.time() - t0)


def _cell_finish(p: _PendingCell, metrics: Sequence, tags: Sequence[str],
                 queue_wall_s: float,
                 trace_dir: Optional[str] = None) -> Dict:
    """Attach the batch results for a pending cell's deferred queue jobs
    (metrics/tags/queue_wall_s cover exactly ``p.jobs``) and build its row."""
    cell, res = p.cell, p.res
    for name, m in zip(p.names, metrics):
        res.tenants[name].latency = m.as_dict()

    latency_res = [t for t in res.tenants.values() if t.kind == "latency"]
    lats = [t.latency or {} for t in latency_res]
    slo_met = all(bool(lat.get("slo_met", False)) for lat in lats) \
        if lats else False

    def worst(key):     # headline latency metrics are worst-department
        return max((float(lat.get(key, 0.0)) for lat in lats), default=0.0)

    # queue accounting: inline sims from the start phase (counter deltas)
    # plus this cell's share of the chunk's batched dispatch
    qd = p.queue_acct
    q_calls = int(qd["calls"]) + len(p.jobs)
    q_requests = int(qd["requests"]) + sum(len(j.trace) for j in p.jobs)
    q_seconds = float(qd["seconds"]) + queue_wall_s
    impls = {k: int(qd[k]) for k in SIM_COUNTERS
             if k not in ("calls", "requests", "seconds") and qd[k]}
    for tag in tags:
        impls[tag] = impls.get(tag, 0) + 1
    wall_s = p.wall_start_s + queue_wall_s

    out = {k: getattr(cell, k) for k in AXIS_KEYS}
    out["cell_id"] = cell.cell_id()
    out["cell_key"] = cell.cell_key()
    out["seed"] = cell.seed
    out["queue_impl"] = cell.queue_impl
    out["metrics"] = {
        "completed": res.completed,
        "killed": res.killed,
        "preemptions": res.preemptions,
        "avg_turnaround_s": res.avg_turnaround,
        "ws_p50_s": worst("p50_s"),
        "ws_p95_s": worst("p95_s"),
        "ws_p99_s": worst("p99_s"),
        "ws_violation_rate": worst("violation_rate"),
        "ws_unserved": sum(int(lat.get("unserved", 0)) for lat in lats),
        "ws_unmet_node_seconds": res.ws_unmet_node_seconds,
        "ws_peak_nodes": p.peak,
        "st_avg_alloc": res.st_avg_alloc,
        "ws_avg_alloc": res.ws_avg_alloc,
        "queue_sim_s": q_seconds,
        "wall_s": wall_s,
    }
    out["ws_requests"] = p.ws_requests
    out["slo_met"] = slo_met
    out["queue_sim"] = {"calls": q_calls,
                        "requests": q_requests,
                        "seconds": q_seconds,
                        "impls": impls}
    out["tenant_metrics"] = {
        name: {"kind": t.kind, "priority": t.priority,
               "avg_alloc": t.avg_alloc,
               "reclaimed_events": t.reclaimed_events,
               "reclaimed_nodes": t.reclaimed_nodes,
               "last_bid": t.last_bid,
               "spend": t.spend,
               "budget_remaining": t.budget_remaining, **t.benefit}
        for name, t in res.tenants.items()}
    # v4+: per-cell engine state — reclaim orderings taken and (auction)
    # clearing prices; v5 adds the market ledger (budgets, remaining,
    # spend, clearing prices) for the budget engines
    out["policy_state"] = res.policy_state
    if p.tracer is not None:
        # optional keys only — absent with tracing off, excluded from
        # REDUCE_KEYS, so reductions and untraced artifacts are unchanged
        # filename is cell_key — the collision-proof spool/resume/merge
        # identity — matching the documented contract; the human-readable
        # cell_id stays available in the tracer header meta
        trace_file = os.path.join(trace_dir,
                                  f"{cell.cell_key()}.trace.jsonl")
        p.tracer.to_jsonl(trace_file)
        out["trace_file"] = trace_file
        out["trace_summary"] = summarize_events(
            [p.tracer.header()] + p.tracer.events)
    return out


def _flush_pending(pending: Sequence[_PendingCell],
                   trace_dir: Optional[str] = None,
                   device: Optional[str] = None) -> List[Dict]:
    """Dispatch every pending cell's deferred queue jobs as ONE batched
    call, then finish all rows. The batch wall clock is apportioned to
    cells by their request share (timing is reporting-only — it never
    enters reductions, which stay independent of chunking)."""
    all_jobs: List[QueueJob] = []
    for p in pending:
        all_jobs.extend(p.jobs)
    tags: List[str] = []
    t0 = time.time()
    metrics = simulate_queue_batch(all_jobs, stats_out=tags,
                                   device=device) \
        if all_jobs else []
    queue_wall = time.time() - t0
    total_req = sum(len(j.trace) for j in all_jobs) or 1
    rows: List[Dict] = []
    off = 0
    for p in pending:
        k = len(p.jobs)
        share = queue_wall * sum(len(j.trace) for j in p.jobs) / total_req
        rows.append(_cell_finish(p, metrics[off:off + k],
                                 tags[off:off + k], share, trace_dir))
        off += k
    return rows


def run_cell(cell: ScenarioCell, trace_dir: Optional[str] = None,
             device: Optional[str] = None) -> Dict:
    """Run one scenario end-to-end; returns axes + metrics as a flat dict.

    ``trace_dir`` (the runner's ``--trace``) enables control-plane
    telemetry for the cell: the full causal trace is spooled to
    ``<trace_dir>/<cell_key>.trace.jsonl`` (the collision-proof content
    hash; the human-readable cell_id is in the trace header's meta) and
    a compact summary
    (reclaim-latency p50/p99, SLO-violation durations, spend attribution)
    is folded into the row under ``trace_summary``. Tracing is a RUNNER
    flag, not a cell field: cell_key — the spool/resume/merge identity —
    is unchanged, and with tracing off the row is bit-identical to an
    untraced run.

    Equivalent to ``run_cell_chunk([cell])[0]``: the batched queue path is
    composition-independent (a job's row depends on that job alone), so a
    cell's metrics are bitwise the same whether its queues flush alone or
    with a chunk.
    """
    device = str(resolve_device(device))
    return _flush_pending([_cell_start(cell, trace_dir)], trace_dir,
                          device)[0]


def run_cell_chunk(cells: Sequence[ScenarioCell],
                   trace_dir: Optional[str] = None,
                   device: Optional[str] = None) -> List[Dict]:
    """Run a chunk of cells, flushing all their WS request queues as one
    batched device dispatch on ``device`` (default the card). Row order
    matches ``cells``."""
    device = str(resolve_device(device))
    pending = [_cell_start(c, trace_dir) for c in cells]
    return _flush_pending(pending, trace_dir, device)


# ------------------------------------------------------------- spooling


def spool_append(path: str, row: Dict) -> None:
    """Append one finished cell to the JSONL spool (crash-durable: each
    line is self-contained and keyed by the cell's content hash)."""
    with open(path, "a") as f:
        f.write(json.dumps(row, default=float) + "\n")
        f.flush()


def spool_load(path: str) -> Dict[str, Dict]:
    """Load spooled rows keyed by cell_key; later duplicates win, truncated
    trailing lines (killed mid-write) are skipped."""
    rows: Dict[str, Dict] = {}
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue                        # torn write at kill time
            key = row.get("cell_key")
            if key:
                rows[key] = row
    return rows


# ------------------------------------------------------------ reduction


def reduce_metrics(results: List[Dict]) -> Dict:
    """Numpy-batched reduction: stack all cells, marginalize per axis.

    Returns {"overall": {...}, "by_<axis>": {level: {...}}} with the
    finite-masked mean of every metric column — a single cell with
    unserved requests has inf percentiles, which must not poison every
    marginal mean containing it — plus an explicit ``inf_rate`` column
    (fraction of cells with any non-finite metric). Rows are re-ordered by
    cell_key before stacking so shard merges reduce bit-identically to
    single-shot runs regardless of completion order.
    """
    if not results:
        return {}
    results = sorted(results,
                     key=lambda r: r.get("cell_key", r.get("cell_id", "")))
    mat = np.array([[float(r["metrics"][k]) for k in REDUCE_KEYS]
                    for r in results])                 # [cells, metrics]
    slo_met = np.array([r["slo_met"] for r in results], dtype=bool)
    finite = np.isfinite(mat)

    def stats(mask: np.ndarray) -> Dict:
        sub = mat[mask]
        fin = finite[mask]
        cnt = fin.sum(axis=0)
        sums = np.where(fin, sub, 0.0).sum(axis=0)
        means = np.where(cnt > 0, sums / np.maximum(cnt, 1), np.inf)
        d = {k: float(v) for k, v in zip(REDUCE_KEYS, means)}
        d["cells"] = int(mask.sum())
        d["slo_met_rate"] = float(slo_met[mask].mean())
        d["inf_rate"] = float((~fin.all(axis=1)).mean())
        return d

    red = {"overall": stats(np.ones(len(results), dtype=bool))}
    for axis in AXIS_KEYS:
        # .get(): hand-built rows may predate a newly added axis column —
        # a single (absent) level is skipped like any non-varying axis
        levels = sorted({r.get(axis) for r in results}, key=str)
        if len(levels) < 2:
            continue
        vals = np.array([str(r.get(axis)) for r in results])
        red[f"by_{axis}"] = {str(lv): stats(vals == str(lv))
                             for lv in levels}
    return red


def _throughput(rows: Sequence[Dict], executed: int, skipped: int,
                run_wall: float) -> Dict:
    """Cells/sec + queue-sim requests/sec over the rows' own accounting
    (works identically for live runs and spool merges). ``queue_impls``
    counts queue-sim calls per implementation (v6), so BENCH numbers say
    which path — ``cuda_batched`` kernel launches, their plain
    ``torch_batched`` version on the CPU, or the numpy sweeps —
    actually served the campaign's queues."""
    q_req = sum(int(r.get("queue_sim", {}).get("requests", 0)) for r in rows)
    q_s = sum(float(r.get("queue_sim", {}).get("seconds", 0.0))
              for r in rows)
    cell_s = sum(float(r["metrics"].get("wall_s", 0.0)) for r in rows)
    impls: Dict[str, int] = {}
    for r in rows:
        for k, v in r.get("queue_sim", {}).get("impls", {}).items():
            impls[k] = impls.get(k, 0) + int(v)
    return {
        "executed": executed,
        "skipped": skipped,
        "run_wall_s": run_wall,
        "cells_per_s": executed / run_wall if run_wall > 0 else 0.0,
        "serial_cells_per_s": len(rows) / cell_s if cell_s > 0 else 0.0,
        "queue_requests": q_req,
        "queue_sim_s": q_s,
        "queue_requests_per_s": q_req / q_s if q_s > 0 else 0.0,
        "queue_impls": impls,
    }


# ------------------------------------------------------------ execution


def _run_cells_streaming(cells: Sequence[ScenarioCell], workers: int,
                         spool_path: Optional[str],
                         trace_dir: Optional[str] = None, *,
                         device: str) -> List[Dict]:
    """Run cells in QUEUE_CHUNK-sized chunks — each chunk flushes all its
    WS request queues as one batched device dispatch — appending each
    finished row to the spool immediately so an interrupted run loses at
    most the in-flight chunk. Workers are spawned, not forked, and each
    runs its chunks on ``device`` itself: a worker never falls back to the
    CPU."""
    rows: List[Dict] = []

    def emit(chunk_rows: Sequence[Dict]) -> None:
        for row in chunk_rows:
            rows.append(row)
            if spool_path:
                spool_append(spool_path, row)

    chunks = [list(cells[i:i + QUEUE_CHUNK])
              for i in range(0, len(cells), QUEUE_CHUNK)]
    if workers > 1 and len(chunks) > 1:
        try:
            import multiprocessing
            from concurrent.futures import (ProcessPoolExecutor,
                                            as_completed)
            if device.startswith("cuda"):
                queue_core_ops.build()      # once, before workers race to
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=workers,
                                     mp_context=ctx) as pool:
                futs = {pool.submit(run_cell_chunk, ch, trace_dir, device): ch
                        for ch in chunks}
                for fut in as_completed(futs):
                    emit(fut.result())
            return rows
        except (OSError, ImportError, BrokenProcessPool) as e:
            # no spawn / restricted env / workers died on first submission
            print(f"[campaign] process pool unavailable ({e!r}); "
                  f"running serial", file=sys.stderr)
            rows = []
    for ch in chunks:
        emit(run_cell_chunk(ch, trace_dir, device))
    return rows


def _assemble(rows_by_key: Dict[str, Dict],
              ordered_keys: Sequence[str]) -> List[Dict]:
    return [rows_by_key[k] for k in ordered_keys if k in rows_by_key]


def run_campaign(cells: Sequence[ScenarioCell], *, workers: int = 1,
                 out_path: Optional[str] = None,
                 grid_name: str = "custom",
                 spool_path: Optional[str] = None,
                 resume: bool = False,
                 shard: Optional[str] = None,
                 trace_dir: Optional[str] = None,
                 device: Optional[str] = None) -> Dict:
    """Run (a shard of) a campaign grid, optionally resuming from a spool.

    The artifact's ``cells`` keep the grid order and its ``reductions``
    are order-independent, so sharded spools merged later reproduce a
    single-shot artifact's reductions exactly. ``trace_dir`` enables
    per-cell control-plane traces (see ``run_cell``); it changes neither
    cell keys nor any reduced column, so traced and untraced runs of the
    same grid stay merge-compatible. A traced ``--resume`` re-runs any
    spooled cell whose ``<cell_key>.trace.jsonl`` is missing from
    ``trace_dir`` — a cell spooled by an earlier UNTRACED run would
    otherwise be skipped, leaving the trace set silently incomplete and
    the artifact with a mix of rows with/without ``trace_summary``.
    ``device`` (default the card, which must be present whatever the cells'
    ``queue_impl``) runs every batched queue flush.
    """
    device = str(resolve_device(device))
    t0 = time.time()
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
    cells = shard_cells(cells, shard)
    keys = [c.cell_key() for c in cells]
    done: Dict[str, Dict] = {}
    if resume and spool_path:
        spooled = spool_load(spool_path)
        done = {k: spooled[k] for k in keys if k in spooled}
        if trace_dir is not None:
            untraced = [k for k in done if not os.path.exists(
                os.path.join(trace_dir, f"{k}.trace.jsonl"))]
            for k in untraced:
                del done[k]
            if untraced:
                print(f"resume: re-running {len(untraced)} spooled "
                      f"cell(s) with no trace in {trace_dir}",
                      file=sys.stderr)
    todo = [c for c, k in zip(cells, keys) if k not in done]
    new_rows = _run_cells_streaming(todo, workers, spool_path, trace_dir,
                                    device=device)
    by_key = dict(done)
    by_key.update({r["cell_key"]: r for r in new_rows})
    results = _assemble(by_key, keys)
    wall = time.time() - t0
    artifact = {
        "schema": SCHEMA,
        "grid": grid_name,
        "shard": shard,
        "n_cells": len(results),
        "workers": workers,
        "wall_s": wall,
        "metric_keys": list(METRIC_KEYS),
        "throughput": _throughput(results, executed=len(new_rows),
                                  skipped=len(done), run_wall=wall),
        "cells": results,
        "reductions": reduce_metrics(results),
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=1, default=float)
    return artifact


def merge_spools(spool_paths: Sequence[str],
                 grid_cells: Optional[Sequence[ScenarioCell]] = None,
                 grid_name: str = "merged"
                 ) -> Tuple[Dict, List[str]]:
    """Fold shard spools into one artifact; reductions are recomputed from
    the spooled rows. Returns (artifact, missing_cell_ids): when
    ``grid_cells`` is given, rows are ordered by the grid and cells absent
    from every spool are reported (their ids) instead of silently dropped.
    """
    by_key: Dict[str, Dict] = {}
    for p in spool_paths:
        by_key.update(spool_load(p))
    missing: List[str] = []
    if grid_cells is not None:
        keys = [c.cell_key() for c in grid_cells]
        missing = [c.cell_id() for c, k in zip(grid_cells, keys)
                   if k not in by_key]
        results = _assemble(by_key, keys)
    else:
        results = [by_key[k] for k in sorted(by_key)]
    cell_wall = sum(float(r["metrics"].get("wall_s", 0.0)) for r in results)
    artifact = {
        "schema": SCHEMA,
        "grid": grid_name,
        "shard": None,
        "n_cells": len(results),
        "workers": 0,
        "wall_s": cell_wall,
        "metric_keys": list(METRIC_KEYS),
        "throughput": _throughput(results, executed=len(results), skipped=0,
                                  run_wall=cell_wall),
        "cells": results,
        "reductions": reduce_metrics(results),
    }
    return artifact, missing


# ------------------------------------------------------------------ CLI


def _print_summary(art: Dict, out: str) -> None:
    ov = art["reductions"].get("overall", {})
    tp = art.get("throughput", {})
    print(f"campaign grid={art['grid']} cells={art['n_cells']} "
          f"wall={art['wall_s']:.1f}s -> {out}")
    if ov:
        print(f"  slo_met_rate={ov['slo_met_rate']:.2f}  "
              f"mean ws_p99={ov['ws_p99_s']:.1f}s  "
              f"mean violation_rate={ov['ws_violation_rate']:.4f}  "
              f"mean completed={ov['completed']:.1f}  "
              f"inf_rate={ov.get('inf_rate', 0.0):.3f}")
    if tp:
        print(f"  executed={tp['executed']} skipped={tp['skipped']}  "
              f"cells/s={tp['cells_per_s']:.2f}  "
              f"queue req/s={tp['queue_requests_per_s']:.0f}")


def _main_run(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default="tiny",
                    choices=["tiny", "small", "mix_tiny", "faults_tiny",
                             "mix", "full"])
    ap.add_argument("--policy", default=None, metavar="P1,P2,...",
                    help="override the grid's policy axis with this "
                         f"comma-separated subset of {sorted(POLICIES)}")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="per-department market budget (tokens over the "
                         "horizon) for the budget engines; 0 = unlimited")
    ap.add_argument("--queue-impl", default=None,
                    choices=["batched", "exact"],
                    help="WS request-queue backend: 'batched' (default) "
                         "flushes each chunk's queues through the "
                         "queue_core kernel; 'exact' keeps the inline "
                         "float64 numpy sweep per tenant")
    ap.add_argument("--fault-profile", default=None,
                    choices=sorted(FAULT_PROFILES),
                    help="override every cell's fault-injection profile "
                         "(core.faults.FAULT_PROFILES); 'none' = fault-"
                         "free (default for all grids except faults_tiny)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the batched queue flush runs: the card "
                         "(default; raises without one) or the CPU (the "
                         "kernel's plain PyTorch version)")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="campaign.json")
    ap.add_argument("--shard", default=None, metavar="i/N",
                    help="run only cells with grid_index %% N == i")
    ap.add_argument("--spool", default=None,
                    help="JSONL spool path (default derived from --out "
                         "when --shard/--resume is used)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in the spool")
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="spool a control-plane trace per cell (JSONL, "
                         "analyzable with `python -m repro_torch.trace`) into "
                         "DIR (default: <out>.traces/) and fold a "
                         "trace_summary into each row")
    args = ap.parse_args(argv)

    spool = args.spool
    if spool is None and (args.shard or args.resume):
        tag = f".shard{args.shard.replace('/', 'of')}" if args.shard else ""
        spool = f"{args.out}{tag}.spool.jsonl"

    trace_dir = None
    if args.trace is not None:
        trace_dir = args.trace or f"{args.out}.traces"

    policies = args.policy.split(",") if args.policy else None
    cells = make_grid(args.grid, seed=args.seed, policies=policies,
                      budget=args.budget, queue_impl=args.queue_impl,
                      fault_profile=args.fault_profile)
    art = run_campaign(cells, workers=args.workers, out_path=args.out,
                       grid_name=args.grid, spool_path=spool,
                       resume=args.resume, shard=args.shard,
                       trace_dir=trace_dir, device=args.device)
    _print_summary(art, args.out)
    if trace_dir is not None:
        print(f"  traces -> {trace_dir}/")
    return 0


def _main_merge(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="campaign merge",
        description="Fold shard spools into one campaign artifact")
    ap.add_argument("spools", nargs="+", help="JSONL spool files")
    ap.add_argument("--out", default="campaign.json")
    ap.add_argument("--grid", default=None,
                    choices=["tiny", "small", "mix_tiny", "faults_tiny",
                             "mix", "full"],
                    help="order/verify rows against this named grid")
    ap.add_argument("--policy", default=None, metavar="P1,P2,...",
                    help="the --policy subset the shards ran with")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="the --budget the shards ran with")
    ap.add_argument("--queue-impl", default=None,
                    choices=["batched", "exact"],
                    help="the --queue-impl the shards ran with")
    ap.add_argument("--fault-profile", default=None,
                    choices=sorted(FAULT_PROFILES),
                    help="the --fault-profile the shards ran with")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--allow-partial", action="store_true",
                    help="merge even if grid cells are missing")
    args = ap.parse_args(argv)

    policies = args.policy.split(",") if args.policy else None
    grid_cells = make_grid(args.grid, seed=args.seed, policies=policies,
                           budget=args.budget,
                           queue_impl=args.queue_impl,
                           fault_profile=args.fault_profile) \
        if args.grid else None
    art, missing = merge_spools(args.spools, grid_cells=grid_cells,
                                grid_name=args.grid or "merged")
    if missing:
        print(f"[merge] {len(missing)} grid cells missing from spools: "
              + ", ".join(missing[:5])
              + (" ..." if len(missing) > 5 else ""), file=sys.stderr)
        if not args.allow_partial:
            return 2
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1, default=float)
    _print_summary(art, args.out)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "merge":
        return _main_merge(argv[1:])
    return _main_run(argv)


if __name__ == "__main__":
    sys.exit(main())
