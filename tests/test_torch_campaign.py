"""The port's campaign runner against the JAX package's, on the CPU.

A traced ``mix_tiny`` run of the port (the queue core's plain version on the
CPU) must write the golden traces byte for byte and pass the trace
regression gate, the JAX package's and the port's own. Its rows, and those
of ``tiny``, must equal the JAX campaign's in every column the queues do not
produce, and agree within the golden tolerance of
``tests/test_queueing_equivalence.py`` in those they do (both batched cores
are float32). Shards merge to the single-shot
reductions bit for bit, as in the JAX package.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.trace import main as trace_main  # noqa: E402
from repro.workloads import campaign as jax_campaign  # noqa: E402
from repro_torch.trace import main as port_trace_main  # noqa: E402
from repro_torch.workloads import campaign  # noqa: E402

GOLDEN = Path(__file__).resolve().parents[1] / "goldens" / "mix_tiny_traces"
QUEUE_KEYS = ("ws_p50_s", "ws_p95_s", "ws_p99_s", "ws_violation_rate", "ws_unserved")


@pytest.fixture(scope="module")
def mix_tiny(tmp_path_factory):
    trace_dir = tmp_path_factory.mktemp("mix_tiny_traces")
    art = campaign.run_campaign(campaign.make_grid("mix_tiny"), grid_name="mix_tiny",
                                trace_dir=str(trace_dir), device="cpu")
    return art, trace_dir


@pytest.fixture(scope="module")
def tiny():
    return campaign.run_campaign(campaign.make_grid("tiny"), grid_name="tiny", device="cpu")


def test_mix_tiny_traces_equal_the_goldens(mix_tiny):
    art, trace_dir = mix_tiny
    names = sorted(p.name for p in GOLDEN.glob("*.trace.jsonl"))
    assert len(names) == 7
    assert sorted(p.name for p in trace_dir.glob("*.trace.jsonl")) == names
    for name in names:
        assert (trace_dir / name).read_bytes() == (GOLDEN / name).read_bytes(), name
    assert trace_main(["regress", str(GOLDEN), str(trace_dir)]) == 0
    assert port_trace_main(["regress", str(GOLDEN), str(trace_dir)]) == 0
    assert art["schema"] == jax_campaign.SCHEMA == "phoenix-campaign-v7"
    assert art["throughput"]["queue_impls"] == {"torch_batched": 14}


def _assert_rows_match(art, jax_art):
    assert [r["cell_key"] for r in art["cells"]] == [r["cell_key"] for r in jax_art["cells"]]
    for row, ref in zip(art["cells"], jax_art["cells"]):
        got, want = row["metrics"], ref["metrics"]
        for k in jax_campaign.REDUCE_KEYS:
            if k not in QUEUE_KEYS:
                assert got[k] == want[k], (row["cell_id"], k)
        requests = row["ws_requests"]
        assert abs(got["ws_unserved"] - want["ws_unserved"]) <= max(2, 0.002 * requests)
        for k in QUEUE_KEYS[:4]:
            assert np.isclose(got[k], want[k], rtol=3e-4, atol=2e-3), (row["cell_id"], k)
        assert row["tenant_metrics"].keys() == ref["tenant_metrics"].keys()
        assert row["policy_state"] == ref["policy_state"]
        assert set(row["queue_sim"]["impls"]) == {"torch_batched"}
        assert row["queue_sim"]["impls"]["torch_batched"] == ref["queue_sim"]["impls"][
            "jax_batched"]


def test_mix_tiny_rows_match_the_jax_campaign(mix_tiny):
    jax_art = jax_campaign.run_campaign(jax_campaign.make_grid("mix_tiny"),
                                        grid_name="mix_tiny")
    _assert_rows_match(mix_tiny[0], jax_art)


def test_tiny_rows_match_the_jax_campaign(tiny):
    jax_art = jax_campaign.run_campaign(jax_campaign.make_grid("tiny"), grid_name="tiny")
    _assert_rows_match(tiny, jax_art)


def test_shards_merge_to_the_single_shot_reductions(tiny, tmp_path):
    cells = campaign.make_grid("tiny")
    spools = []
    for i in range(2):
        spools.append(str(tmp_path / f"s{i}.jsonl"))
        campaign.run_campaign(cells, shard=f"{i}/2", spool_path=spools[i], device="cpu")
    merged, missing = campaign.merge_spools(spools, grid_cells=cells, grid_name="tiny")
    assert missing == []
    assert merged["reductions"] == tiny["reductions"]
    assert [r["cell_key"] for r in merged["cells"]] == [r["cell_key"] for r in tiny["cells"]]


def test_campaign_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cells = campaign.make_grid("mix_tiny", policies=["paper"])
    for impl in ("batched", "exact"):
        with pytest.raises(RuntimeError):
            campaign.main(["--grid", "mix_tiny", "--policy", "paper", "--queue-impl", impl,
                           "--out", str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError):
        campaign.run_campaign(cells, device="cuda")
    with pytest.raises(RuntimeError):
        campaign.run_cell(cells[0])
    assert not (tmp_path / "x.json").exists()


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "c.json"
    assert campaign.main(["--grid", "mix_tiny", "--policy", "paper,auction", "--device", "cpu",
                          "--out", str(out), "--trace", str(tmp_path / "tr")]) == 0
    art = json.loads(out.read_text())
    assert art["n_cells"] == 2 and art["throughput"]["queue_impls"] == {"torch_batched": 4}
    assert len(list((tmp_path / "tr").glob("*.trace.jsonl"))) == 2
    assert "campaign grid=mix_tiny cells=2" in capsys.readouterr().out
