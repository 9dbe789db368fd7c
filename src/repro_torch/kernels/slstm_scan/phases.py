"""Where the sLSTM kernels' time goes: a diagnostic build with phase clocks,
and the served kernels' times at several batch sizes.

    PYTHONPATH=src python -m repro_torch.kernels.slstm_scan.phases
    PYTHONPATH=src python -m repro_torch.kernels.slstm_scan.phases --batches 1,4,8,35

Builds ``csrc/slstm_scan.cu`` with ``-DREPRO_SLSTM_PHASES`` into
``_build.variant_dir`` beside the served library: thread 0 of each block adds
up the ``clock()`` cycles of each phase as it sees them, ``PHASES`` in the
order of the kernel's ``enum Phase``. At xlstm-1.3b's layer shapes
[4, 512, 4, 512] and [1, 2048, 4, 512] it launches the phase build's forward
(keeping the saved values) and backward, and prints one JSON record a
kernel and shape: the plan, each phase's cycles a step (the median over
blocks, divided by S), its mean share of a block's cycles, ns a step at the
card's maximum SM clock (``nvidia-smi``'s ``clocks.max.sm``: an idle card
reads lower), and the device ms of the served and diagnostic builds (CUDA
graphs of 5 calls, 5 alternating turns, medians). Then the diagnostic
build's registers and spills and the card line.

``--batches`` instead times the served kernels alone at [B, 512, 4, 512]
for each B given: the forward without and with the saved values (serving,
training) and the backward, the same way, one JSON record a B with its plan.
It uses only the wrapper's ``card_plan``, ``_forward`` and
``_launch_backward``, which the sLSTM wrapper has had since its first
kernels, so the file run as a script with another checkout's ``src`` first
on the path times that checkout's kernels:

    PYTHONPATH=<checkout>/src python src/repro_torch/kernels/slstm_scan/phases.py --batches 8,35

Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.phases import graph_ms
from repro_torch.kernels.slstm_scan import ops

PHASES = ("prologue", "inputs", "scalars", "products", "gates", "stores", "wait")
FLAG = "-DREPRO_SLSTM_PHASES"
SHAPES = {"prefill": (4, 512, 4, 512), "training": (1, 2048, 4, 512)}


def build() -> ctypes.CDLL:
    """Build (once per source hash) and bind the diagnostic library."""
    lib = ops._bind(_build.load_variant("slstm_scan", FLAG))
    lib.slstm_phase_cycles_read.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint),
                                            ctypes.c_int]
    lib.slstm_phase_cycles_read.restype = ctypes.c_int
    return lib


def _cycles(lib: ctypes.CDLL, kernel: int, blocks: int) -> torch.Tensor:
    buf = (ctypes.c_uint * (blocks * len(PHASES)))()
    _build.check(lib, lib.slstm_phase_cycles_read(kernel, buf, blocks), "slstm phase read")
    return torch.tensor(list(buf), dtype=torch.float64).view(blocks, len(PHASES))


def _split(c: torch.Tensor, S: int, mhz: float) -> dict:
    total = c.sum(1)
    a_step = {p: c[:, i].median().item() / S for i, p in enumerate(PHASES)}
    return {"cycles_a_step_median": a_step,
            "ns_a_step": {p: v / mhz * 1e3 for p, v in a_step.items()},
            "share_mean": {p: (c[:, i] / total).mean().item() for i, p in enumerate(PHASES)},
            "block_cycles_median": total.median().item(), "block_cycles_max": total.max().item()}


def inputs(B: int, S: int, H: int, dh: int) -> tuple:
    """The gate inputs, rec, a zero state and an output gradient at [B, S, H,
    dh], from seed 0 on the card (chip_smoke's scales)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = [torch.randn(B, S, H, dh, generator=gen, device=dev) for _ in range(4)]
    rec = torch.randn(4, H, dh, dh, generator=gen, device=dev) / dh ** 0.5
    state = {k: torch.zeros((B, H, dh) if k != "m" else (B, H), device=dev) for k in "hcnm"}
    return x, rec, state, torch.randn(B, S, H, dh, generator=gen, device=dev)


def measure(lib: ctypes.CDLL, B: int, S: int, H: int, dh: int, mhz: float) -> list:
    x, rec, state, dy = inputs(B, S, H, dh)
    plan = ops.card_plan(B, H, dh, torch.device("cuda"))
    blocks = H * plan.groups * plan.blocks
    h, _, saved = ops._launch(*x, rec, state, True, lib=lib)
    torch.cuda.synchronize()
    fwd = _cycles(lib, 0, blocks)
    ops._launch_backward(rec, state, h, saved, dy, lib=lib)
    torch.cuda.synchronize()
    bwd = _cycles(lib, 1, blocks)
    fwd_ms = graph_ms({name: (lambda *a, lib=lib: ops._launch(*a, False, lib=lib))
                       for name, lib in (("served_build", None), ("phases_build", lib))},
                      [(*x, rec, state)], iters=5)
    bwd_ms = graph_ms({name: (lambda *a, lib=lib: ops._launch_backward(*a, lib=lib))
                       for name, lib in (("served_build", None), ("phases_build", lib))},
                      [(rec, state, h, saved, dy)], iters=5)
    base = {"shape": [B, S, H, dh], "plan": list(plan), "blocks": blocks, "max_sm_mhz": mhz}
    return [{**base, "kernel": "slstm_scan", **_split(fwd, S, mhz), "ms": fwd_ms},
            {**base, "kernel": "slstm_scan_backward", **_split(bwd, S, mhz), "ms": bwd_ms}]


def batch_times(B: int, S: int = 512, H: int = 4, dh: int = 512) -> dict:
    """Device ms of the served forward (without and with the saved values)
    and backward at [B, S, H, dh], with the plan."""
    x, rec, state, dy = inputs(B, S, H, dh)
    plan = ops.card_plan(B, H, dh, torch.device("cuda"))
    h, _, saved = ops._forward(*x, rec, state, True)
    ms = graph_ms({"forward": lambda *a: ops._forward(*a, False),
                   "forward_saved": lambda *a: ops._forward(*a, True)},
                  [(*x, rec, state)], iters=5)
    ms.update(graph_ms({"backward": ops._launch_backward}, [(rec, state, h, saved, dy)],
                       iters=5))
    return {"shape": [B, S, H, dh], "plan": dict(zip(plan._fields, plan)), "ms": ms}


def _max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", default="",
                        help="comma-separated B: time the served kernels at [B, 512, 4, 512]")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 1
    if args.batches:
        for B in (int(b) for b in args.batches.split(",")):
            print(json.dumps({"phase": "slstm_batch_times", **batch_times(B)}), flush=True)
    else:
        lib = build()
        mhz = _max_sm_mhz()
        for name, shape in SHAPES.items():
            for record in measure(lib, *shape, mhz):
                print(json.dumps({"phase": "slstm_phases", "case": name, **record}), flush=True)
        print(json.dumps({"phase": "slstm_phases_build", "registers_spills":
                          _build.ptxas_registers(_build.variant_log("slstm_scan", FLAG))}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
