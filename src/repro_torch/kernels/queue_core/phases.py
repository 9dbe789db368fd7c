"""Where the queue kernel's time goes: a diagnostic build with phase clocks.

    PYTHONPATH=src python -m repro_torch.kernels.queue_core.phases

Builds ``csrc/queue_core.cu`` with ``-DREPRO_QUEUE_PHASES``, into
``_build.variant_dir`` beside the served library: thread 0 of each block adds
up the ``clock()`` cycles of each phase as it sees them (``PHASES``, the
order of the kernel's ``enum Phase``: the job's tables and checks, t and s
loads and each 32 requests' latencies, the interval search, the insert or
drain, the fold). Launches it once on a flush's flat tables and prints, for
the first chunk of ``--grid full --shard 0/252`` and for ``chip_smoke.py``'s
192-job piecewise set and many-interval set (read from the checkout's
``chip_smoke.py``), one JSON record each: each block's cycles by phase (the
jobs' requests beside them), each phase's share of the longest job's block
and of all blocks' cycles, cycles a request of the chain, and the device
time of the diagnostic and the served build (CUDA graphs of 20 flushes, 5
alternating turns, medians). Then one ``queue_tiers`` record: jobs at each
register tier's top K (``chip_smoke.tier_jobs`` over 7,200 s) timed on
their own instance and on the next one up, the same way (the rows of both
must be the same bits); then the card line from ``nvidia-smi`` with its SM
clock. Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.queue_core import ops

PHASES = ("prologue", "loads", "search", "insert", "fold")
CHAIN = ("loads", "search", "insert")


def build() -> ctypes.CDLL:
    """Build (once per source hash) and bind the diagnostic library."""
    lib = ops._bind(_build.load_variant("queue_core", "-DREPRO_QUEUE_PHASES"))
    lib.queue_phase_cycles_read.argtypes = [ctypes.POINTER(ctypes.c_uint), ctypes.c_int]
    lib.queue_phase_cycles_read.restype = ctypes.c_int
    return lib


def graph_ms(fns, turns: int = 5, iters: int = 20) -> dict:
    """name -> median device ms of one call, from CUDA graphs of ``iters``
    calls replayed in ``turns`` turns of alternating order."""
    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(iters):
                fn()
    times = {name: [] for name in fns}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for t in range(turns):
        for name in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            start.record()
            graphs[name].replay()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return {name: sorted(v)[len(v) // 2] for name, v in times.items()}


def measure(lib, args, k_max) -> dict:
    """Phase cycles of one flush (``args``: the flat tables on the card)."""
    J = args[0].shape[0]
    if J > 4096:
        raise ValueError("the phase build records 4096 blocks at most")
    got = ops._launch(*args, k_max, lib=lib)
    torch.cuda.synchronize()
    buf = (ctypes.c_uint * (J * len(PHASES)))()
    _build.check(lib, lib.queue_phase_cycles_read(buf, J), "queue phase read")
    c = torch.tensor(list(buf), dtype=torch.float64).view(J, len(PHASES))
    served = ops.queue_flush(*args, k_max)
    if not torch.equal(got.nan_to_num(), served.nan_to_num()):
        raise AssertionError("the phase build's rows differ from the served build's")
    off = args[3].cpu()
    n = (off[1:] - off[:-1]).to(torch.float64)
    total = c.sum(1)
    longest = int(n.argmax())
    chain = c[:, [PHASES.index(p) for p in CHAIN]].sum(1)
    times = graph_ms({"phases_build": lambda: ops._launch(*args, k_max, lib=lib),
                      "served_build": lambda: ops.queue_flush(*args, k_max)})
    return {"jobs": J, "instance": ops.INSTANCES[ops.slot_registers(k_max)],
            "requests": n.tolist(), "cycles": c.tolist(),
            "longest_job": {"requests": int(n[longest]),
                            "share": {p: (c[longest, i] / total[longest]).item()
                                      for i, p in enumerate(PHASES)},
                            "chain_cycles_per_request": (chain[longest] / n[longest]).item()},
            "share_all_blocks": {p: (c[:, i].sum() / total.sum()).item()
                                 for i, p in enumerate(PHASES)},
            "chain_cycles_per_request_all": (chain.sum() / n.sum()).item(),
            "ms": times}


def full_chunk_args(device="cuda"):
    """The flat tables of the first chunk of ``--grid full --shard 0/252``
    on ``device``, and k_max."""
    from repro_torch.workloads import campaign as C
    cells = C.shard_cells(C.make_grid("full"), "0/252")[:C.QUEUE_CHUNK]
    return jobs_args([j for c in cells for j in C._cell_start(c).jobs], device)


def chip_smoke_module():
    """The checkout's ``chip_smoke.py`` as a module (its queue job sets)."""
    path = Path(__file__).resolve().parents[4] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_sets", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jobs_args(jobs, device="cuda"):
    """The flat tables of one flush of ``jobs`` on ``device``, and k_max."""
    from repro_torch.workloads import queueing as Q
    caps = Q._job_caps(jobs)
    buf, spans, k_max = Q.flush_inputs(jobs, [i for i, c in enumerate(caps) if c is not None],
                                       caps)
    return Q.flush_tensors(buf.to(device), spans), k_max


def tier_times(smoke) -> dict:
    """K at each register tier's top -> device ms on its own instance and on
    the next one up (k_max 2K, or 513 above the last register tier)."""
    out = {}
    for K in (32, 64, 128, 256, 512):
        args, k_max = jobs_args(smoke.tier_jobs(K, horizon=7200.0))
        up = 513 if K == 512 else 2 * K
        rows = [ops.queue_flush(*args, k) for k in (k_max, up)]
        if not torch.equal(rows[0].nan_to_num(), rows[1].nan_to_num()):
            raise AssertionError(f"K {K}: the next instance up gives other rows")
        names = [ops.INSTANCES[ops.slot_registers(k)] for k in (k_max, up)]
        times = graph_ms({names[0]: lambda: ops.queue_flush(*args, k_max),
                          names[1]: lambda: ops.queue_flush(*args, up)})
        n = args[3][1:] - args[3][:-1]
        out[f"K {K}"] = {"longest_job": int(n.max()), "ms": times}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    print(json.dumps({"phase": "queue_phases", "set": "full, shard 0/252, first chunk",
                      **measure(lib, *full_chunk_args())}), flush=True)
    smoke = chip_smoke_module()
    sets = smoke.queue_sets()
    for name in ("piecewise_192", "many_intervals"):
        print(json.dumps({"phase": "queue_phases", "set": name,
                          **measure(lib, *jobs_args(sets[name]))}), flush=True)
    print(json.dumps({"phase": "queue_tiers", **tier_times(smoke)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
