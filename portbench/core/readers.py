"""Arithmetic the metric readers (``metrics/<name>.py``) share. A reader
that finds nothing to read returns None, and the metric is left out of the
line; no share of a roofline or a peak is ever given as 0 for want of a
reading."""
from __future__ import annotations

from typing import Iterable, Optional

from portbench.core import peaks, registry


def kernel_share(run, names: Iterable[str]) -> Optional[float]:
    """Σ of the calls' bounds over Σ of the device time of the kernels of the
    kernel files ``names``, in percent. None without a trace, without calls,
    or where the device ran none of their kernels (a kernel taken off the
    path or renamed). Each reader names its files: a kernel file added later
    moves no metric that is already there."""
    if run.trace is None or not run.calls:
        return None
    files = registry.kernels()
    bound = 0.0
    device_names = []
    for name in names:
        k = files[name]
        b = sum(peaks.bound_s(f, nb, k.PRECISION)
                for call in run.calls for f, nb in k.calls(run.model, call))
        if b > 0:
            bound += b
            device_names += list(k.DEVICE_NAMES)
    if bound <= 0 or not device_names:
        return None
    t = run.trace.kernel_s(device_names)
    return 100.0 * bound / t if t > 0 else None


def model_flops(run, phase: str, B: int, S: int) -> float:
    return run.reference.model_flops(run.model, phase, B, S)


def train_mfu(run) -> Optional[float]:
    w = run.window
    if not w.get("steps"):
        return None
    flops = model_flops(run, "train", w["batch"], w["seq_len"]) * w["steps"]
    return 100.0 * flops / w["seconds"] / peaks.BF16_FLOPS


def idle_share(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def train_rate(run) -> Optional[float]:
    w = run.window
    return w["tokens"] / w["seconds"] if w.get("steps") else None


def launches_per_step(run) -> Optional[float]:
    t = run.trace
    n = t.span_count("train_step") if t is not None else 0
    return t.kernels / n if n else None


def peak_gb(run) -> Optional[float]:
    peak = run.window.get("peak_bytes")
    return peak / 1e9 if peak else None
