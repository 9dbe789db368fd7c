"""Paper experiment end-to-end: SC vs DC consolidation (Fig. 5/7/8).

Default runs the request-level WS workload (``repro_torch.workloads``): requests
arrive via a flash-crowd process, an SLO autoscaler turns latency targets
into node demand, and each DC row reports p99 latency + SLO-violation rate
alongside the paper's benefit metrics. ``--ws timeseries`` reproduces the
paper's original instance-demand curve instead.

``--mix``/``--policy`` run an N-department consolidation instead of the
paper's two: e.g. ``--mix 2hpc2ws1be --policy proportional_share``
consolidates 2 HPC + 2 request-level WS + 1 best-effort batch department
under weighted proportional idle sharing, reporting per-department benefit
metrics for each DC size.

    PYTHONPATH=src python -m repro_torch.examples.consolidation_sim
    PYTHONPATH=src python -m repro_torch.examples.consolidation_sim --ws timeseries
    PYTHONPATH=src python -m repro_torch.examples.consolidation_sim --preempt checkpoint
    PYTHONPATH=src python -m repro_torch.examples.consolidation_sim --arrival mmpp --slo 20
    PYTHONPATH=src python -m repro_torch.examples.consolidation_sim \
        --mix 2hpc2ws1be --policy demand_capped

The port's own copy of ``examples/consolidation_sim.py``: the same flags and
the same printed lines. It is host work (the discrete-event simulator and
the exact float64 queue), so it has no ``--device``.
"""
import argparse
import sys

from repro_torch.core.experiment import (DC_SIZES, SC_TOTAL, run_experiment,
                                         validate_claims)
from repro_torch.core.policies import POLICIES
from repro_torch.core.simulator import ConsolidationSim
from repro_torch.core.traces import TWO_WEEKS_S, synthetic_sdsc_blue
from repro_torch.core.types import SimConfig, SLOConfig
from repro_torch.serving.batching import ServiceTimeModel
from repro_torch.workloads import RequestWorkload, make_trace
from repro_torch.workloads.arrivals import GENERATORS
from repro_torch.workloads.campaign import MIXES, ScenarioCell, make_tenants

WS_DEDICATED = 64           # SC: the WS department's own machine


def run_mix(args, cfg, sizes):
    """N-department consolidation sweep with per-department benefits."""
    horizon = args.days * 86400.0
    print(f"\n== N-department consolidation: mix={args.mix} "
          f"policy={args.policy} preempt={args.preempt} ==")
    for size in sizes:
        cell = ScenarioCell(preempt=args.preempt, scheduler=args.scheduler,
                            arrival=args.arrival, total_nodes=size,
                            slo_target_s=args.slo, rate_rps=args.rate,
                            horizon_s=horizon,
                            n_jobs=max(40, int(2672 * horizon / TWO_WEEKS_S)),
                            policy=args.policy, mix=args.mix, seed=args.seed)
        sim = ConsolidationSim(
            SimConfig(total_nodes=size, preempt_mode=args.preempt,
                      scheduler=args.scheduler, seed=args.seed),
            horizon=horizon, tenants=make_tenants(cell), policy=args.policy)
        res = sim.run()
        print(f"\n-- total_nodes={size} "
              f"(cost {100.0 * size / SC_TOTAL:.1f}% of SC {SC_TOTAL}) --")
        print(f"{'department':>12} {'kind':>8} {'prio':>5} {'avg_alloc':>10} "
              f"{'benefit':<48}")
        for name, t in res.tenants.items():
            ben = "  ".join(f"{k}={v:.4g}" for k, v in t.benefit.items())
            print(f"{name:>12} {t.kind:>8} {t.priority:>5} "
                  f"{t.avg_alloc:>10.1f} {ben:<48}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preempt", default="kill",
                    choices=["kill", "checkpoint"])
    ap.add_argument("--scheduler", default="first_fit",
                    choices=["first_fit", "fcfs", "easy_backfill"])
    ap.add_argument("--sizes", default=",".join(map(str, DC_SIZES)))
    ap.add_argument("--ws", default="requests",
                    choices=["requests", "timeseries"],
                    help="WS model: request-level + SLO autoscaler (new) "
                         "or the paper's instance-demand timeseries")
    ap.add_argument("--arrival", default="flash_crowd",
                    choices=sorted(GENERATORS))
    ap.add_argument("--rate", type=float, default=3.0,
                    help="mean WS request rate (req/s, requests mode)")
    ap.add_argument("--slo", type=float, default=30.0,
                    help="p99 latency target in seconds (requests mode)")
    ap.add_argument("--days", type=float, default=2.0,
                    help="horizon in days for requests mode (timeseries "
                         "mode always runs the paper's 14 days)")
    ap.add_argument("--mix", default="paper2", choices=sorted(MIXES),
                    help="department mix; paper2 = the paper's 1 HPC + 1 WS")
    ap.add_argument("--policy", default="paper", choices=sorted(POLICIES),
                    help="cooperative policy for the N-department mix")
    args = ap.parse_args(argv)

    cfg = SimConfig(preempt_mode=args.preempt, scheduler=args.scheduler,
                    seed=args.seed)
    sizes = tuple(int(s) for s in args.sizes.split(","))

    if args.mix != "paper2" or args.policy != "paper":
        return run_mix(args, cfg, sizes)

    workload = None
    if args.ws == "requests":
        horizon = args.days * 86400.0
        jobs = synthetic_sdsc_blue(
            args.seed, n_jobs=max(40, int(2672 * horizon / TWO_WEEKS_S)),
            horizon=horizon)
        trace = make_trace(args.arrival, args.rate, horizon, args.seed)
        workload = RequestWorkload(trace=trace, model=ServiceTimeModel(),
                                   slo=SLOConfig(latency_target_s=args.slo))
        res = run_experiment(seed=args.seed, cfg=cfg, sizes=sizes,
                             horizon=horizon, jobs=jobs, ws_demand=workload)
    else:
        res = run_experiment(seed=args.seed, cfg=cfg, sizes=sizes)

    sc = res["SC"]
    print(f"\n== Static configuration (SC): {SC_TOTAL} nodes "
          f"(144 HPC + {WS_DEDICATED} WS) ==")
    print(f"  completed={sc.completed}/{sc.submitted}  "
          f"avg_turnaround={sc.avg_turnaround:.0f}s  "
          f"benefit_user={sc.benefit_user:.2e}")
    if workload is not None:
        sc_lat = workload.realized_metrics([(0.0, WS_DEDICATED)],
                                           horizon=horizon)
        print(f"  WS on dedicated {WS_DEDICATED} nodes: "
              f"{len(workload.trace)} requests, "
              f"p99={sc_lat['p99_s']:.1f}s  "
              f"slo_violation={100 * sc_lat['violation_rate']:.2f}%")

    print(f"\n== Dynamic configuration (DC), policy={args.preempt}/"
          f"{args.scheduler}, ws={args.ws} ==")
    lat_hdr = f" {'ws_p99':>8} {'viol%':>6}" if workload is not None else ""
    print(f"{'size':>6} {'cost%':>6} {'completed':>10} {'killed':>7} "
          f"{'preempt':>8} {'turnaround':>11} {'ws_unmet':>9}{lat_hdr}")
    for size in sorted(res['DC'], reverse=True):
        r = res["DC"][size]
        lat = ""
        if r.ws_latency is not None:
            lat = (f" {r.ws_latency['p99_s']:>7.1f}s "
                   f"{100 * r.ws_latency['violation_rate']:>5.2f}%")
        print(f"{size:>6} {100.0*size/SC_TOTAL:>5.1f}% {r.completed:>10} "
              f"{r.killed:>7} {r.preemptions:>8} "
              f"{r.avg_turnaround:>10.0f}s {r.ws_unmet_node_seconds:>9.0f}"
              f"{lat}")
    if args.ws == "timeseries" and 160 in res["DC"]:
        print("\npaper-claim validation:", validate_claims(res))
    else:
        print("\n(paper-claim validation needs the calibrated 14-day "
              "trace: run with --ws timeseries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
