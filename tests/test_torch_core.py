"""The port's control plane against the JAX package's, on the CPU.

``repro_torch.core`` is a copy of ``repro.core`` (framework-free Python), so
for every policy engine one ``mix_tiny`` cell -- 96 nodes, 2 HPC + 2 WS
departments, 7200 s -- must give the same ``SimResult``, field by field, and
the same trace, line by line. The inputs are carried across by seed: both
packages draw the same job and request traces.
"""
import dataclasses
import enum

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.policies import POLICIES  # noqa: E402
from repro.core.simulator import ConsolidationSim as JaxSim  # noqa: E402
from repro.core.telemetry import Tracer as JaxTracer  # noqa: E402
from repro.core.types import SimConfig as JaxSimConfig  # noqa: E402
from repro.workloads import campaign as jax_campaign  # noqa: E402
from repro_torch.core import policies as port_policies  # noqa: E402
from repro_torch.core.simulator import ConsolidationSim  # noqa: E402
from repro_torch.core.telemetry import Tracer  # noqa: E402
from repro_torch.core.types import SimConfig  # noqa: E402
from repro_torch.workloads import campaign  # noqa: E402


def _plain(job):
    """A job's fields, enums by value (each package has its own JobState)."""
    return tuple(x.value if isinstance(x, enum.Enum) else x
                 for x in dataclasses.astuple(job))


def _run(sim_cls, tracer_cls, cfg_cls, camp, cell):
    tracer = tracer_cls(meta={"cell_id": cell.cell_id()})
    cfg = cfg_cls(total_nodes=cell.total_nodes, preempt_mode=cell.preempt,
                  scheduler=cell.scheduler, seed=cell.seed)
    tenants = camp.make_tenants(cell)
    sim = sim_cls(cfg, horizon=cell.horizon_s, tenants=tenants, policy=cell.policy,
                  tracer=tracer)
    return sim.run(), tracer, tenants


def test_policy_registries_match():
    assert sorted(port_policies.POLICIES) == sorted(POLICIES) and len(POLICIES) == 7


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_consolidation_sim_matches_jax_package(policy):
    (cell,) = campaign.make_grid("mix_tiny", policies=[policy])
    (jcell,) = jax_campaign.make_grid("mix_tiny", policies=[policy])
    assert cell.cell_key() == jcell.cell_key()
    got, tracer, tenants = _run(ConsolidationSim, Tracer, SimConfig, campaign, cell)
    want, jtracer, jtenants = _run(JaxSim, JaxTracer, JaxSimConfig, jax_campaign, jcell)
    for a, b in zip(tenants, jtenants):                    # the same inputs
        if a.kind == "latency":
            assert np.array_equal(a.demand.trace.t, b.demand.trace.t)
        else:
            assert [_plain(j) for j in a.jobs] == [_plain(j) for j in b.jobs]
    assert got.completed > 0 and got.tenants["ws-0"].latency is not None
    for f in dataclasses.fields(want):
        if f.name == "tenants":
            assert got.tenants.keys() == want.tenants.keys()
            for name in want.tenants:
                assert dataclasses.asdict(got.tenants[name]) == \
                    dataclasses.asdict(want.tenants[name]), (policy, name)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), (policy, f.name)
    assert len(tracer.events) > 10
    assert tracer.lines() == jtracer.lines()
