"""End-to-end N-department runtime demo: 2 elastic trainers + 1 serving
pool consolidated on ONE DevicePool, driven by ``MultiTenantOrchestrator``
under the ``slo_headroom`` reclaim engine.

A WS load spike makes the serving department claim devices; the phase-1
reclaim planner orders victims by live ``TenantSignals`` (the predicted
latency headroom fed back by ``latency_tick_slo``, trainer preemption
costs), shrinking trainers by whole DP groups; when the spike passes, idle
devices reflow and the trainers grow back — no training work lost.

    PYTHONPATH=src python -m repro_torch.examples.multi_department_runtime
    PYTHONPATH=src python -m repro_torch.examples.multi_department_runtime --device cpu

With a budget-constrained market engine the serving department pays the
trainers' per-node bids for every device it preempts (beyond its floor);
watch its remaining budget drain across the spike until it can no longer
afford the replicas its SLO wants — the department throttles ITSELF:

    PYTHONPATH=src python -m repro_torch.examples.multi_department_runtime \\
        --device cpu --policy budget_auction --budget 3

The port's own copy of ``examples/multi_department_runtime.py``, with the
same control flow and printed lines. The pool is every card by default
(``MultiTenantOrchestrator()``; it raises without one); ``--device cpu``
gives it ``--devices`` CPU entries (8 by default, the JAX example's forced
host devices), on which each trainer runs one rank a device. The weights
are drawn on the CPU from seed 0.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.types import SLOConfig
from repro_torch.examples.elastic_train import add_device_args, devices_of
from repro_torch.models import model as M
from repro_torch.runtime.elastic import ElasticTrainer
from repro_torch.runtime.orchestrator import MultiTenantOrchestrator
from repro_torch.runtime.serving_pool import ServingPool
from repro_torch.serving.batching import ServiceTimeModel
from repro_torch.workloads.autoscaler import SLOAutoscaler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--policy", default="slo_headroom")
    ap.add_argument("--intervals", type=int, default=8)
    ap.add_argument("--budget", type=float, default=0.0,
                    help="serving department's market budget (tokens; "
                         "0 = unlimited) for the budget engines")
    add_device_args(ap)
    args = ap.parse_args(argv)
    budget = args.budget if args.budget > 0 else None

    cfg = reduced_config(get_config(args.arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def trainer():
        return ElasticTrainer(cfg, TrainConfig(learning_rate=1e-3),
                              global_batch=4, seq_len=32,
                              ckpt_dir=tempfile.mkdtemp(prefix="phx_"),
                              model_size=1, init_device="cpu")

    slo = SLOConfig(latency_target_s=2.0)
    scaler = SLOAutoscaler(ServiceTimeModel(), slo, n_min=1, n_max=6)
    pool = ServingPool(cfg, params, capacity_tokens_per_replica=200.0)

    orch = MultiTenantOrchestrator(devices=devices_of(args, 8), policy=args.policy)
    orch.add_latency("serve", pool, priority=0, slo_autoscaler=scaler,
                     floor=1, budget=budget,
                     bid_policy="slo_elastic" if budget else "linear")
    ta, tb = trainer(), trainer()
    orch.add_batch("train-a", ta, priority=1, weight=2.0, min_devices=1)
    orch.add_batch("train-b", tb, priority=2, weight=1.0, min_devices=1)
    try:
        orch.start()

        # WS request rate (req/s): trough -> spike -> trough
        rates = np.interp(np.arange(args.intervals),
                          [0, 2, 4, args.intervals - 1], [0.2, 0.2, 30.0, 0.2])
        mean_s, scv = 0.35, 1.0
        for i, rate in enumerate(rates):
            orch.latency_tick_slo("serve", float(rate), mean_s, scv)
            ma = orch.train_steps("train-a", 1)
            mb = orch.train_steps("train-b", 1)
            sig = orch.svc.tenants["serve"].signals()
            market = orch.market_state()
            wallet = ""
            if market is not None and budget is not None:
                wallet = (f"  budget={market['remaining']['serve']:6.1f}/"
                          f"{budget:g} left")
            print(f"interval {i}: rate={rate:5.1f} req/s  "
                  f"replicas={len(pool.replicas)}  "
                  f"headroom={sig.latency_headroom_s:+6.2f}s  "
                  f"train-a devs={ma['devices']} step={ma['step']}  "
                  f"train-b devs={mb['devices']} step={mb['step']}{wallet}")
    finally:
        ta.close()
        tb.close()

    print("\nper-department benefit summary")
    print("------------------------------")
    shrinks = [e for e in orch.events if e["kind"] == "shrink"]
    state = orch.svc.policy.state_snapshot()
    for name, dept in orch.batch.items():
        t = dept.trainer
        drained = state["victim_nodes"].get(name, 0)
        print(f"  {name:8s} batch   steps={t.step:3d}  "
              f"resizes={t.resizes}  devices={len(orch.devs.groups[name])}  "
              f"devices_reclaimed_from_it={drained} "
              f"(no work lost across resizes)")
    rec = orch.svc.tenants["serve"]
    print(f"  serve    latency replicas={len(pool.replicas)}  "
          f"alloc={rec.alloc}  floor={rec.floor}  "
          f"slo_target={slo.latency_target_s}s")
    print(f"  engine={state['engine']}  reclaim_plans="
          f"{state['reclaim_plans']}  last_plan={state['last_plan']}  "
          f"trainer_shrinks={len(shrinks)}")
    market = orch.market_state()
    if market is not None:
        spend = {n: round(v, 1) for n, v in market["spend"].items()}
        print(f"  market   spend={spend}  clearing_prices="
              f"{[round(p, 2) for p in market['clearing_prices'][:8]]}  "
              f"transactions={market['transactions']}")
    orch.devs.check()
    orch.svc.check()
    return 0


if __name__ == "__main__":
    sys.exit(main())
