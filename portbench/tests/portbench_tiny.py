"""Helpers of the benchmark's CPU tests (imported by them, not collected): a
cell of ``BENCHMARK.json`` cut to a tiny model and a tiny mix, run through
the harness on the CPU (the program's plain versions), with the look for a
card skipped."""
from __future__ import annotations

import time

import torch

from portbench.core import cli, registry

TINY_MODEL = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, vocab_size=256)


def tiny(cell: registry.Cell, float32: bool = True, limits=None, keep_traffic: bool = False):
    """(model, traffic, spec) of ``cell`` at a size a test run holds
    (``keep_traffic``: the cell's own mix)."""
    model = dict(cell.model, **TINY_MODEL)
    model["num_layers"] = 8 if "slstm" in model["block_pattern"] else 2
    if model["d_ff"]:
        model["d_ff"] = 128
    if float32:
        model.update(param_dtype="float32", compute_dtype="float32")
    traffic = dict(cell.traffic)
    spec = dict(cell.spec)
    if not keep_traffic:
        traffic.update(batch=2, seq_len=64, distinct_batches=4)
    spec.update(grad_tail_layers=2, trace_steps=1)
    if limits is not None:
        spec["limits"] = limits
    return model, traffic, spec


def run_tiny(bench: dict, cell: registry.Cell, seconds: float = 0.2, trace: bool = False,
             seed: int = 4294967311, **kw):
    """The harness's run of ``cell`` on the CPU at the tiny size, on one
    thread (the test runner's workers share the cores): the ``Run``."""
    model, traffic, spec = tiny(cell, **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cli.execute(bench, cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), model=model, traffic=traffic, spec=spec)
    finally:
        torch.set_num_threads(threads)
