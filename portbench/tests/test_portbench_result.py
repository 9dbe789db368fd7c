"""Whole runs of the harness on the CPU at a tiny size, with the look for a
card skipped: the result line's keys, a sound float32 program correct under
each cell's own limits, and each fault a cell can have making ``correct``
false (the timed path broken underneath, in the program)."""
import json

import pytest
import torch

from portbench.core import cli, registry

import portbench_tiny


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def line_of(run, trace=False):
    line = cli.result(run, trace)
    json.dumps(line)
    return line


@pytest.mark.parametrize("name", ["xlstm-train-2k", "musicgen-train-30s"])
def test_sound_run_is_correct_and_its_line_has_the_keys(bench, name):
    cell = registry.cell(bench, name)
    run = portbench_tiny.run_tiny(bench, cell)
    line = line_of(run)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.spec["limits"])
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_line_carries_the_per_layer_metrics(bench):
    run = portbench_tiny.run_tiny(bench, registry.cell(bench, "xlstm-train-2k"), trace=True)
    line = line_of(run, trace=True)
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    assert "train.mfu.xlstm" in line["metrics"] and "setup_s" not in line["metrics"]
    assert list(line)[-1] == "checks"


def test_the_forbidden_modules_are_named_by_their_top_level(monkeypatch):
    from types import SimpleNamespace
    loaded = {"repro_torch": 1, "repro_torch.models.model": 1, "numpy": 1, "jaxtyping": 1}
    monkeypatch.setattr(cli, "sys", SimpleNamespace(modules=loaded))
    assert cli.forbidden_modules() == []
    loaded.update({"repro.core.types": 1, "jaxlib.xla_client": 1})
    assert cli.forbidden_modules() == ["jaxlib", "repro"]


def _unchanged_state(monkeypatch):
    import repro_torch.training.train_step as ts

    def frozen(opt, grads, params, tcfg, groups=None):
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
        return params, opt._replace(step=opt.step + 1), {"grad_norm": gnorm}
    monkeypatch.setattr(ts, "adamw_update", frozen)


def _half_batch(monkeypatch):
    import repro_torch.runtime.elastic as elastic
    whole = elastic._global_batch
    monkeypatch.setattr(elastic, "_global_batch", lambda job, step: {
        k: t[: t.shape[0] // 2] for k, t in whole(job, step).items()})


def _update_off(monkeypatch, **wrong):
    """AdamW with some of its settings not the cell's: the gradients and the
    first step's change stay close to the reference's."""
    import dataclasses
    import repro_torch.training.optimizer as opt
    leaf = opt.adamw_leaf
    monkeypatch.setattr(opt, "adamw_leaf", lambda g, m, v, w, clip, bc1, bc2, tcfg: leaf(
        g, m, v, w, clip, bc1, bc2, dataclasses.replace(tcfg, **wrong)))


def _learning_rate_off(monkeypatch):
    _update_off(monkeypatch, learning_rate=3.15e-4)          # 5% over the cell's


def _beta2_off(monkeypatch):
    _update_off(monkeypatch, beta2=0.999)


@pytest.mark.parametrize("name", ["xlstm-train-2k", "musicgen-train-30s"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _learning_rate_off,
                                   _beta2_off])
def test_training_faults_are_not_correct(bench, monkeypatch, name, fault):
    fault(monkeypatch)
    line = line_of(portbench_tiny.run_tiny(bench, registry.cell(bench, name)))
    assert line["correct"] is False, line["checks"]
