"""One run of one cell: what the drivers record and the readers read."""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from portbench.core import registry


class Call(NamedTuple):
    """One call into the model in the traced segment: ``train`` (a step with
    ``remat``), ``prefill`` over [B, S] or ``decode`` of B tokens at cache
    length S."""
    phase: str
    B: int
    S: int
    remat: bool = False


class Run:
    def __init__(self, bench: dict, cell: registry.Cell, seed: int, seconds: float,
                 trace: bool, device: torch.device, t0: float,
                 model: Optional[dict] = None, traffic: Optional[dict] = None,
                 spec: Optional[dict] = None):
        self.bench, self.cell = bench, cell
        self.seed, self.seconds, self.trace_on = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.model = model or cell.model
        self.traffic = traffic or cell.traffic
        self.spec = spec or cell.spec
        self.reference = cell.reference
        self.setup_s: Optional[float] = None
        self.window: Dict[str, Any] = {}
        self.calls: List[Call] = []
        self.trace = None
        self.checks: Dict[str, dict] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0

    def start_window(self) -> float:
        """Set-up ends here; returns the window's start on the host clock."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.setup_s = now - self.t0
        return now

    def peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = max(self.memory_peak, self.peak())
            torch.cuda.reset_peak_memory_stats(self.device)

    def free(self) -> None:
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
