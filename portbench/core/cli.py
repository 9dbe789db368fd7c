"""``portbench/run.py``'s work: run one cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's driver (``cells/<cell>.json``'s ``driver``: ``train``, the
module ``core/train.py``) sets up, measures for ``--seconds``, and checks the timed path's
output against the plain reference. With ``--trace 0`` the result carries
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from a profiled segment after the window. Each number that decides
``correct`` is printed beside its limit as the last lines of standard error
and under ``checks``, the last key of the result. Without enough CUDA cards
the run exits 2 and prints no result; if a module of JAX or of the JAX
package ``repro`` is loaded once the window has closed, it exits 3.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from typing import List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def chips(n: int):
    """The first card, or None where fewer than ``n`` cards are present."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        return None
    return torch.device("cuda", 0)


def execute(bench: dict, cell, seed: int, seconds: float, trace: bool, device,
            t0: float, **overrides):
    """Run ``cell`` (a ``registry.Cell``) on ``device``; returns the ``Run``."""
    from portbench.core.run import Run
    run = Run(bench, cell, seed, seconds, trace, device, t0, **overrides)
    importlib.import_module(f"portbench.core.{run.spec['driver']}").execute(run)
    return run


def metrics(run, trace: bool) -> dict:
    from portbench.core import registry
    out = {}
    for entry in registry.metrics_of(run.bench, run.cell.name, trace):
        value = registry.metric(entry["name"]).read(run)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def result(run, trace: bool) -> dict:
    from portbench.core.check import passed
    import torch
    line = {"correct": passed(run.checks) and run.failed == 0 and run.attempted > 0,
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics(run, trace)}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
              else "cpu",
              "count": run.cell.entry["chips"], "memory_peak_bytes": run.memory_peak}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
    line["device"] = device
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.top_ops(10),
                             "idle_gaps": run.trace.idle_gaps(10)}
    line["checks"] = run.checks
    return line


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(sys.argv[1:] if argv is None else argv)
    from portbench.core import registry
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    device = chips(cell.entry["chips"])
    if device is None:
        print(f"portbench: {args.workload} needs {cell.entry['chips']} CUDA card(s); "
              "none or too few here", file=sys.stderr)
        return 2
    run = execute(bench, cell, args.seed, args.seconds, bool(args.trace), device, t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of {found} were loaded; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    line = result(run, bool(args.trace))
    print(f"portbench: setup {run.setup_s:.3f} s, window {run.window.get('seconds', 0):.3f} s, "
          f"reference {run.window.get('reference_s', 0):.3f} s", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
