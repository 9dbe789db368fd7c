"""The port's paper experiment and examples against the JAX package's, on
the CPU.

``repro_torch.core.experiment`` is a copy of ``repro.core.experiment``: the
same Python over the same RNG, so the SC-vs-DC sweep at the paper's full
scale (14 days, SC plus six DC sizes) gives every ``SimResult`` field
exactly, and the request-level mode's WS latency (the exact float64 host
queue in both) bit for bit. The port's ``consolidation_sim`` prints what
``examples/consolidation_sim.py`` prints, and its ``sharded_campaign`` merges
to the single-shot reductions on the CPU.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import experiment as jax_experiment  # noqa: E402
from repro.core.traces import TWO_WEEKS_S, synthetic_sdsc_blue  # noqa: E402
from repro.core.types import SLOConfig  # noqa: E402
from repro.serving.batching import ServiceTimeModel  # noqa: E402
from repro.workloads import RequestWorkload, make_trace  # noqa: E402
from repro_torch.core import experiment  # noqa: E402
from repro_torch.core import traces as port_traces  # noqa: E402
from repro_torch.core.types import SLOConfig as PortSLOConfig  # noqa: E402
from repro_torch.examples import consolidation_sim, sharded_campaign  # noqa: E402
from repro_torch.serving.batching import ServiceTimeModel as PortServiceTimeModel  # noqa: E402
from repro_torch.workloads import RequestWorkload as PortRequestWorkload  # noqa: E402
from repro_torch.workloads import make_trace as port_make_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RUNS = ["SC"] + list(experiment.DC_SIZES)


@pytest.fixture(scope="module")
def sweeps():
    return experiment.run_experiment(seed=0), jax_experiment.run_experiment(seed=0)


def _result(res, run):
    return res["SC"] if run == "SC" else res["DC"][run]


def test_constants_equal_jax():
    assert experiment.SC_TOTAL == jax_experiment.SC_TOTAL == 208
    assert experiment.DC_SIZES == jax_experiment.DC_SIZES == (200, 190, 180, 170, 160, 150)


@pytest.mark.parametrize("run", RUNS)
def test_paper_sweep_result_equals_jax(sweeps, run):
    got, want = (_result(r, run) for r in sweeps)
    assert type(got).__name__ == type(want).__name__ == "SimResult"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.submitted > 2000 and got.completed > 0


def test_paper_claims_hold_as_in_jax(sweeps):
    got, want = (experiment.validate_claims(r) for r in sweeps)
    assert got == want
    assert got["cost_ratio_at_160"] == 160 / 208
    assert all(v is True for k, v in got.items() if k != "cost_ratio_at_160"), got


@pytest.fixture(scope="module")
def request_level():
    horizon = 0.25 * 86400.0
    n_jobs = max(40, int(2672 * horizon / TWO_WEEKS_S))
    port = PortRequestWorkload(trace=port_make_trace("flash_crowd", 3.0, horizon, 0),
                               model=PortServiceTimeModel(),
                               slo=PortSLOConfig(latency_target_s=30.0))
    ref = RequestWorkload(trace=make_trace("flash_crowd", 3.0, horizon, 0),
                          model=ServiceTimeModel(), slo=SLOConfig(latency_target_s=30.0))
    got = experiment.run_experiment(
        seed=0, sizes=(170, 160), horizon=horizon, ws_demand=port,
        jobs=port_traces.synthetic_sdsc_blue(0, n_jobs=n_jobs, horizon=horizon))
    want = jax_experiment.run_experiment(
        seed=0, sizes=(170, 160), horizon=horizon, ws_demand=ref,
        jobs=synthetic_sdsc_blue(0, n_jobs=n_jobs, horizon=horizon))
    return got, want


@pytest.mark.parametrize("run", ["SC", 170, 160])
def test_request_level_mode_equals_jax(request_level, run):
    got, want = (_result(r, run) for r in request_level)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if run != "SC":
        assert got.ws_latency is not None and got.ws_latency == want.ws_latency
        assert set(got.ws_latency) >= {"p99_s", "violation_rate"}


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_consolidation_sim", ROOT / "examples" / "consolidation_sim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--sizes", "170,160", "--days", "0.25"],
    ["--ws", "timeseries", "--sizes", "160"],
    ["--mix", "2hpc2ws1be", "--policy", "demand_capped", "--sizes", "160", "--days", "0.25"],
], ids=["requests", "timeseries", "mix"])
def test_consolidation_sim_prints_what_the_jax_example_prints(argv, capsys):
    capsys.readouterr()
    assert _jax_example().main(list(argv)) == 0
    want = capsys.readouterr().out
    assert consolidation_sim.main(list(argv)) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "total_nodes=160" in got or "   160 " in got
    if "timeseries" in argv:
        assert "paper-claim validation:" in got


def test_sharded_campaign_merges_to_the_single_shot_on_the_cpu(capsys):
    argv = ["--grid", "mix_tiny", "--workers", "1", "--device", "cpu"]
    assert sharded_campaign.main(argv) == 0
    out = capsys.readouterr().out
    assert "grid=mix_tiny: 7 cells, 4+3 across 2 shards" in out
    assert "resume executed=2 skipped=1" in out
    assert "merged reductions == single-shot reductions" in out
