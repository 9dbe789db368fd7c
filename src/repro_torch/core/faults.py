"""Fault-injection subsystem: pluggable injectors over the node inventory.

``SimConfig.node_mtbf`` (the legacy knob) injects anonymous exponential
single-node failures from the simulator's shared RNG stream. This module
generalizes that into declarative :class:`FaultSpec` profiles with three
injector families, all operating on identified nodes
(:class:`~repro.core.nodes.NodeInventory`):

  * ``independent`` — cluster-wide exponential single-node failures. With
    ``seed=None`` it *is* the legacy path: same shared RNG stream, same
    draw order, same pool-proportional victim attribution — bit-for-bit
    identical to ``SimConfig(node_mtbf=...)`` (pinned by
    tests/test_faults.py). With an explicit ``seed`` it switches to the
    isolated stream + node-uniform selection described below.
  * ``rack_corr`` — correlated rack blasts: an epicenter node is drawn
    uniformly over up nodes, then up to ``blast_radius`` nodes of its
    failure domain go down together, all repairing after
    ``repair_time_s``.
  * ``flapping`` — a designated fraction of nodes cycle up/down on their
    own exponential clocks (short ``flap_repair_s`` outages), returning
    to the FLAPPING state after each repair.

**Policy-axis independence** (the campaign contract): every profile other
than the degenerate legacy-compatible one draws from its own
``random.Random(f"phoenix-faults:{profile}:{seed}")`` stream and selects
victims uniformly over the inventory's *up* set — which depends only on
prior fault/repair events, never on which tenant owns a node. Changing
``--policy`` or ``--budget`` therefore cannot perturb the injected fault
sequence within a cell (pinned cross-axis determinism test).

:data:`FAULT_PROFILES` holds the named presets used by the campaign's
``fault_profile`` axis (severity calibrated for the ``mix_tiny`` cells:
96 nodes over a 7200 s horizon).

The port's own copy of ``repro.core.faults`` with the same logic.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.nodes import NodeState


@dataclass(frozen=True)
class FaultSpec:
    """Declarative fault-injection profile (a ``SimConfig.faults`` value
    and the payload behind a campaign cell's ``fault_profile`` axis)."""
    profile: str = "independent"   # independent | rack_corr | flapping
    # independent / rack_corr: cluster-wide MTBF in seconds — the event
    # rate is total_nodes / mtbf_s (legacy node_mtbf semantics); 0
    # disables the exponential clock (flapping ignores it).
    mtbf_s: float = 0.0
    repair_time_s: float = 3600.0
    # failure domains: node i belongs to rack i // rack_size
    rack_size: int = 16
    # rack_corr: nodes taken down per blast (epicenter + rack neighbours)
    blast_radius: int = 8
    # flapping: fraction of nodes designated flappers, mean up-time
    # between flaps, and the (short) per-flap outage
    flap_fraction: float = 0.04
    flap_period_s: float = 1200.0
    flap_repair_s: float = 120.0
    # drain window charged on every forced reclaim step while this profile
    # is active (0 = instant reclaim, the legacy behaviour); see
    # TenantProvisionService.configure_drain
    drain_time_s: float = 0.0
    # fault-stream seed. None on the "independent" profile means "share
    # the simulator's RNG stream" (the bit-for-bit legacy degenerate
    # case); None elsewhere derives the isolated stream from the sim seed.
    seed: Optional[int] = None


#: named presets for the campaign's ``fault_profile`` axis. "none" keeps
#: the cell fault-free (the pre-existing behaviour — every committed
#: artifact reproduces bit-for-bit). Severity is calibrated for mix_tiny
#: (96 nodes x 7200 s): independent ~4.6 single failures, rack_corr ~1.7
#: blasts x 8 nodes with a 30 s drain tax on reclaims, flapping ~5
#: flappers x ~5 short outages each.
FAULT_PROFILES: Dict[str, Optional[FaultSpec]] = {
    "none": None,
    "independent": FaultSpec(profile="independent", mtbf_s=150_000.0,
                             repair_time_s=1800.0),
    "rack_corr": FaultSpec(profile="rack_corr", mtbf_s=400_000.0,
                           repair_time_s=3600.0, rack_size=16,
                           blast_radius=8, drain_time_s=30.0),
    "flapping": FaultSpec(profile="flapping", flap_fraction=0.05,
                          flap_period_s=1500.0, flap_repair_s=120.0),
}


def get_fault_spec(name: str) -> Optional[FaultSpec]:
    if name not in FAULT_PROFILES:
        raise ValueError(f"unknown fault profile {name!r}; "
                         f"have {sorted(FAULT_PROFILES)}")
    return FAULT_PROFILES[name]


def fault_rng(spec: FaultSpec, sim_seed: int) -> random.Random:
    """The isolated, policy-axis-independent fault stream: seeded from the
    profile name + the cell/sim seed (or the spec's explicit seed), never
    from anything a policy or budget knob can reach."""
    seed = spec.seed if spec.seed is not None else sim_seed
    return random.Random(f"phoenix-faults:{spec.profile}:{seed}")


class FaultInjector:
    """Injector protocol: ``start(sim)`` schedules the first fault
    event(s); the simulator routes every NODE_FAIL event's payload back
    through ``fire(sim, payload)``. Injectors own all fault RNG and talk
    to the sim through its fault API (``schedule_fault``,
    ``schedule_repair``, ``apply_node_failure``, ``emit_suppressed``,
    ``fail_pool_proportional``)."""

    profile = "base"

    def __init__(self, spec: FaultSpec, rng: random.Random):
        self.spec = spec
        self.rng = rng

    def start(self, sim) -> None:
        raise NotImplementedError

    def fire(self, sim, payload) -> None:
        raise NotImplementedError


class IndependentInjector(FaultInjector):
    """Exponential single-node failures.

    ``legacy_pick=True`` (spec.seed is None): victims are attributed by
    pool share with the exact legacy draw order — bit-for-bit compatible
    with the ``node_mtbf`` path (the injector's ``rng`` IS the sim's
    shared stream then). Otherwise victims are uniform over up nodes from
    the isolated fault stream."""

    profile = "independent"

    def __init__(self, spec: FaultSpec, rng: random.Random,
                 legacy_pick: bool):
        super().__init__(spec, rng)
        self.legacy_pick = legacy_pick

    def _next(self, sim) -> float:
        return self.rng.expovariate(sim.cfg.total_nodes / self.spec.mtbf_s)

    def start(self, sim) -> None:
        if self.spec.mtbf_s > 0:
            sim.schedule_fault(self._next(sim))

    def fire(self, sim, payload) -> None:
        if self.legacy_pick:
            sim.fail_pool_proportional(self.rng, self.spec.repair_time_s,
                                       cause="independent")
        else:
            up = sim.inventory.up_ids()
            if len(up) <= 1:
                sim.emit_suppressed("cluster_at_minimum", up=len(up))
            else:
                node = up[int(self.rng.random() * len(up))]
                sim.apply_node_failure(node, cause="independent")
                sim.schedule_repair(self.spec.repair_time_s, node)
        sim.schedule_fault(self._next(sim))


class RackBlastInjector(FaultInjector):
    """Correlated failures: each event picks an epicenter uniformly over
    up nodes and takes down up to ``blast_radius`` up nodes of its rack
    (epicenter first, then ascending id), all repairing together. One
    up node always survives cluster-wide."""

    profile = "rack_corr"

    def _next(self, sim) -> float:
        return self.rng.expovariate(sim.cfg.total_nodes / self.spec.mtbf_s)

    def start(self, sim) -> None:
        if self.spec.mtbf_s > 0:
            sim.schedule_fault(self._next(sim))

    def fire(self, sim, payload) -> None:
        inv = sim.inventory
        up = inv.up_ids()
        if len(up) <= 1:
            sim.emit_suppressed("cluster_at_minimum", up=len(up))
        else:
            epicenter = up[int(self.rng.random() * len(up))]
            domain = inv.nodes[epicenter].domain
            targets = [epicenter] + [i for i in inv.domain_up_ids(domain)
                                     if i != epicenter]
            targets = targets[:min(self.spec.blast_radius, len(up) - 1)]
            for node in targets:
                sim.apply_node_failure(node, cause="rack_blast",
                                       domain=domain)
                sim.schedule_repair(self.spec.repair_time_s, node)
        sim.schedule_fault(self._next(sim))


class FlappingInjector(FaultInjector):
    """Designated flappers cycle up/down on independent exponential
    clocks: mean ``flap_period_s`` up-time, ``flap_repair_s`` outage.
    Repair returns a flapper to FLAPPING (not HEALTHY) — it stays
    unreliable for the whole run."""

    profile = "flapping"

    def start(self, sim) -> None:
        total = sim.cfg.total_nodes
        k = max(1, round(self.spec.flap_fraction * total))
        k = min(k, total)
        flappers = sorted(self.rng.sample(range(total), k))
        sim.inventory.designate_flappers(flappers)
        for node in flappers:
            sim.schedule_fault(
                self.rng.expovariate(1.0 / self.spec.flap_period_s), node)

    def fire(self, sim, payload) -> None:
        node = payload
        state = sim.inventory.state_of(node)
        up = sim.inventory.up_ids()
        if state in (NodeState.FAILED, NodeState.REPAIRING) or len(up) <= 1:
            # already down (e.g. the whole cluster shrank to one node) —
            # the flap is suppressed, the clock keeps ticking
            sim.emit_suppressed("flapper_unavailable", node=node,
                                state=state.value)
            delay = self.rng.expovariate(1.0 / self.spec.flap_period_s)
        else:
            sim.apply_node_failure(node, cause="flap")
            sim.schedule_repair(self.spec.flap_repair_s, node)
            delay = self.spec.flap_repair_s + \
                self.rng.expovariate(1.0 / self.spec.flap_period_s)
        sim.schedule_fault(delay, node)


def make_injector(spec: FaultSpec, sim_seed: int,
                  sim_rng: random.Random) -> FaultInjector:
    """Build the injector for a spec. The degenerate independent profile
    (seed=None) shares ``sim_rng`` — the legacy stream — so it reproduces
    the ``node_mtbf`` path bit-for-bit; everything else gets the isolated
    ``fault_rng`` stream."""
    if spec.profile == "independent":
        if spec.seed is None:
            return IndependentInjector(spec, sim_rng, legacy_pick=True)
        return IndependentInjector(spec, fault_rng(spec, sim_seed),
                                   legacy_pick=False)
    if spec.profile == "rack_corr":
        return RackBlastInjector(spec, fault_rng(spec, sim_seed))
    if spec.profile == "flapping":
        return FlappingInjector(spec, fault_rng(spec, sim_seed))
    raise ValueError(f"unknown fault profile {spec.profile!r}")
