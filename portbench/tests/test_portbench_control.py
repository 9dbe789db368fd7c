"""The control, the reference computed in float8 (every product's operands
and result, and the residual stream) put in the program's place, comes out
as not correct under each training cell's limits, at a size a test run
holds. ``portbench/control.py`` reads it on the card at the cells' sizes."""
import time

import pytest
import torch

from portbench.core import check, registry, train, traffic
from portbench.core.run import Run
from portbench.reference.common import fp8_matmul

import portbench_tiny


@pytest.mark.parametrize("name", ["xlstm-train-2k", "musicgen-train-30s"])
def test_the_float8_control_is_not_correct(name):
    bench = registry.benchmark()
    cell = registry.cell(bench, name)
    model, tr, spec = portbench_tiny.tiny(cell)
    run = Run(bench, cell, 77, 0.1, False, torch.device("cpu"), time.perf_counter(),
              model=model, traffic=tr, spec=spec)
    batches = traffic.train_batches(tr, model, run.seed, run.device)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = train.reference_readings(run, batches)
        control = train.reference_readings(run, batches, mm=fp8_matmul)
    finally:
        torch.set_num_threads(threads)
    checks = check.train(control, ref, cell.spec["limits"], model["num_layers"],
                         spec["grad_tail_layers"])
    assert not check.passed(checks), checks
    same = check.train(ref, ref, cell.spec["limits"], model["num_layers"],
                       spec["grad_tail_layers"])
    assert check.passed(same)
