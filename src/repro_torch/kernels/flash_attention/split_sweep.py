"""The tensor-core flash backward's split threshold: precision against time.

    python -m repro_torch.kernels.flash_attention.split_sweep

A tile of the bf16 backward (``csrc/flash_attention_bwd.cu``) in which some
P >= ``split_p`` multiplies the lo part (x - bf16(x)) of its bf16 operands
P and dS as well; the wrapper passes ``ops.SPLIT_P``. On the card, for each
threshold (0: every tile splits; inf: none does) and each training shape
(recurrentgemma-2b's [1, 3072, 10, 1, 256] window 2048 and qwen2-7b's heads
[4, 512, 28, 4, 128] causal, bf16, inputs from seed 0), one JSON line: for
dq, dk and dv the worst element's share of its tolerance (2^-7 |ref| + 1e-2
rms(ref), chip_smoke's bf16 ``grad_tol``) and the relative error against the
plain formulas, and the kernels' device time (CUDA events; the median of 7
runs of 10 calls). The first line is the card's name and power limit from
``nvidia-smi``. Raises without a card.
"""
from __future__ import annotations

import json
import math
import subprocess

import torch

from repro_torch.kernels.flash_attention import ops

SHAPES = ((1, 3072, 10, 1, 256, 2048), (4, 512, 28, 4, 128, 0))   # B, S, H, K, hd, window
THRESHOLDS = (0.0, 1 / 256, 1 / 128, 1 / 64, 1 / 32, math.inf)


def _inputs(B, S, H, K, hd, window, gen):
    q, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, K, hd, generator=gen, device="cuda").bfloat16() for _ in range(2))
    o, lse = ops._launch(q, k, v, causal=True, window=window, lse=True)
    return q, k, v, o, do, lse


def _device_ms(fn, runs: int = 7, calls: int = 10) -> float:
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[runs // 2]


def _errors(got, ref) -> dict:
    out = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g, r = g.float(), r.float()
        d = (g - r).abs()
        rms = r.square().mean().sqrt()
        out[name] = {"worst_element_share": (d / (2.0 ** -7 * r.abs() + 1e-2 * rms)).max().item(),
                     "rel_err": (d.norm() / r.norm()).item()}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("split_sweep measures the CUDA kernels: it needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, K, hd, window in SHAPES:
        inputs = _inputs(B, S, H, K, hd, window, gen)
        ref = ops.flash_attention_backward_reference(*inputs, causal=True, window=window)
        for split_p in THRESHOLDS:
            def call():
                return ops._launch_backward(*inputs, causal=True, window=window, split_p=split_p)
            errors = _errors(call(), ref)
            print(json.dumps({"shape": [B, S, H, K, hd], "window": window,
                              "split_p": split_p if math.isfinite(split_p) else "inf",
                              "ms": _device_ms(call), **errors}), flush=True)


if __name__ == "__main__":
    main()
