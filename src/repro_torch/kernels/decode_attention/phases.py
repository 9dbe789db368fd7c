"""Where the decode kernel's time goes: a diagnostic build with phase clocks.

    PYTHONPATH=src python -m repro_torch.kernels.decode_attention.phases

Builds ``csrc/decode_attention.cu`` with ``-DREPRO_DECODE_PHASES``, into
``_build.variant_dir`` beside the served library: thread 0 of each block adds
up the ``clock()`` cycles of each phase as it sees them after the block's
barriers (``PHASES``, the order of the kernel's ``enum Phase``). Launches it
at the serving decode shapes (bf16, every slot valid, caches rotated so
that reads come from HBM, as ``chip_smoke.py`` times the kernel), one launch
per cache, and prints for each shape one JSON record: the split plan, the
median over blocks and launches of each phase's cycles, each phase's mean
share of a block's cycles, and the device time of the diagnostic and the
served build (CUDA graphs of 20 calls, 5 alternating turns, medians). Then
the diagnostic build's registers and spills, and the card line from
``nvidia-smi`` with its SM clock. Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops

PHASES = ("prologue", "wait", "scores", "softmax", "pv", "partial", "cluster_wait",
          "push", "combine")
# name -> (B, H, K, L, hd, caches): the serving decode shapes at their last step
SHAPES = {"qwen2-7b": (4, 28, 4, 544, 128, 16),
          "recurrentgemma-2b": (4, 10, 1, 544, 256, 48)}


FLAG = "-DREPRO_DECODE_PHASES"


def build() -> ctypes.CDLL:
    """Build (once per source hash) and bind the diagnostic library."""
    lib = ops._bind(_build.load_variant("decode_attention", FLAG))
    lib.decode_phase_cycles_read.argtypes = [ctypes.POINTER(ctypes.c_uint), ctypes.c_int]
    lib.decode_phase_cycles_read.restype = ctypes.c_int
    return lib


def graph_ms(fn, calls, turns: int = 5, iters: int = 20) -> dict:
    """name -> median device ms per call of ``iters`` calls in a CUDA graph,
    replayed in ``turns`` turns of alternating order."""
    graphs = {}
    for name, f in fn.items():
        for c in calls[:3]:
            f(*c)                                   # warm up outside the graph
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for i in range(iters):
                f(*calls[i % len(calls)])
    times = {name: [] for name in fn}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for t in range(turns):
        for name in (list(fn) if t % 2 == 0 else list(fn)[::-1]):
            start.record()
            graphs[name].replay()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return {name: sorted(v)[len(v) // 2] for name, v in times.items()}


def measure(lib: ctypes.CDLL, B: int, H: int, K: int, L: int, hd: int, caches: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    sp = torch.arange(L, device="cuda", dtype=torch.int32)
    calls = [tuple(torch.randn(*shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((B, H, hd), (B, L, K, hd), (B, L, K, hd)))
             for _ in range(caches)]
    plan = ops.split_plan(B, K, H // K, L, hd)
    blocks = plan.blocks(B, K)
    buf = (ctypes.c_uint * (blocks * len(PHASES)))()
    ops._launch(*calls[0], sp, L - 1, 0, lib=lib)  # first call: attributes, module load
    cycles = []
    for q, ck, cv in calls:
        ops._launch(q, ck, cv, sp, L - 1, 0, lib=lib)
        torch.cuda.synchronize()
        _build.check(lib, lib.decode_phase_cycles_read(buf, blocks), "decode phase read")
        cycles.append(torch.tensor(list(buf), dtype=torch.float64).view(blocks, len(PHASES)))
    c = torch.cat(cycles)
    total = c.sum(1)
    times = graph_ms({
        "phases_build": lambda q, ck, cv: ops._launch(q, ck, cv, sp, L - 1, 0, lib=lib),
        "served_build": lambda q, ck, cv: ops._launch(q, ck, cv, sp, L - 1, 0)}, calls)
    return {"shape": [B, H, K, L, hd], "split_plan": list(plan), "blocks": blocks,
            "launches": len(calls),
            "cycles_median": {p: c[:, i].median().item() for i, p in enumerate(PHASES)},
            "share_mean": {p: (c[:, i] / total).mean().item() for i, p in enumerate(PHASES)},
            "block_cycles_median": total.median().item(),
            "block_cycles_max": total.max().item(),
            "ms": times}


def registers() -> list:
    """(kernel, registers, spill stores) of the diagnostic build, from ptxas."""
    return _build.ptxas_registers(_build.variant_log("decode_attention", FLAG))


def main() -> int:
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    for name, shape in SHAPES.items():
        print(json.dumps({"phase": "decode_phases", "model": name,
                          **measure(lib, *shape)}), flush=True)
    print(json.dumps({"phase": "decode_phases_build", "registers_spills": registers()}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
