"""SC-vs-DC consolidation experiment (paper §III-D).

Static configuration (SC): each department runs a dedicated system —
144 nodes for HPC (the SDSC BLUE machine size) + 64 for Web services (the
peak demand of Fig. 5) = 208 nodes total.

Dynamic configuration (DC): one shared system of {200,190,180,170,160,150}
nodes under the cooperative policies.

Paper claims validated here (EXPERIMENTS.md §Paper-claims):
  * at DC=160 (76.9% of 208), ST completed jobs  >= SC completed jobs;
  * at DC=160, 1/avg-turnaround >= SC's;
  * killed jobs generally grow as the cluster shrinks (blips allowed — the
    paper itself reports a non-monotonicity at 170);
  * WS benefit unchanged (demand always met: unmet node-seconds == 0).

The port's own copy of ``repro.core.experiment`` with the same logic: host
Python over the discrete-event simulator, no tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.simulator import ConsolidationSim, SimResult
from repro_torch.core.traces import (SDSC_BLUE_NODES, TWO_WEEKS_S,
                               WORLDCUP_PEAK_INSTANCES, synthetic_sdsc_blue,
                               worldcup_demand_events)
from repro_torch.core.types import Job, SimConfig

SC_TOTAL = SDSC_BLUE_NODES + WORLDCUP_PEAK_INSTANCES  # 208
DC_SIZES = (200, 190, 180, 170, 160, 150)


def run_static(jobs: List[Job], *, cfg: Optional[SimConfig] = None,
               horizon: float = TWO_WEEKS_S) -> SimResult:
    """SC: dedicated 144-node HPC system (WS runs on its own 64 nodes; its
    benefit is load-independent, so only the ST side needs simulating)."""
    cfg = dataclasses.replace(cfg or SimConfig(),
                              total_nodes=SDSC_BLUE_NODES)
    sim = ConsolidationSim(cfg, jobs, ws_demand=[], horizon=horizon)
    return sim.run()


def run_dynamic(jobs: List[Job], ws_demand: List[Tuple[float, int]],
                total_nodes: int, *, cfg: Optional[SimConfig] = None,
                horizon: float = TWO_WEEKS_S) -> SimResult:
    cfg = dataclasses.replace(cfg or SimConfig(), total_nodes=total_nodes)
    sim = ConsolidationSim(cfg, jobs, ws_demand=ws_demand, horizon=horizon)
    return sim.run()


def run_experiment(*, seed: int = 0, cfg: Optional[SimConfig] = None,
                   sizes: Tuple[int, ...] = DC_SIZES,
                   horizon: float = TWO_WEEKS_S,
                   jobs: Optional[List[Job]] = None,
                   ws_demand=None) -> Dict:
    """Full Fig. 7/8 sweep. Returns {'SC': SimResult, 'DC': {size: SimResult}}."""
    jobs = jobs if jobs is not None else synthetic_sdsc_blue(seed)
    ws_demand = ws_demand if ws_demand is not None \
        else worldcup_demand_events(seed, horizon)
    out = {"SC": run_static(jobs, cfg=cfg, horizon=horizon), "DC": {}}
    for size in sizes:
        out["DC"][size] = run_dynamic(jobs, ws_demand, size, cfg=cfg,
                                      horizon=horizon)
    return out


def validate_claims(results: Dict, *, dc_ref: int = 160) -> Dict[str, bool]:
    sc: SimResult = results["SC"]
    dc: SimResult = results["DC"][dc_ref]
    sizes = sorted(results["DC"])
    kills = [results["DC"][s].killed for s in sizes]          # ascending size
    # "killed increases in general as size decreases": compare largest vs
    # smallest and allow local blips (the paper has one at 170).
    kill_trend = kills[0] >= kills[-1]
    return {
        "dc160_completed_ge_sc": dc.completed >= sc.completed,
        "dc160_user_benefit_ge_sc":
            dc.benefit_user >= sc.benefit_user,
        "ws_demand_always_met": all(
            results["DC"][s].ws_unmet_node_seconds == 0.0 for s in sizes),
        "killed_grows_as_cluster_shrinks": kill_trend,
        "cost_ratio_at_160": dc_ref / SC_TOTAL,  # 0.769...
    }
