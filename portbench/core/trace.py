"""Reading one profiled segment of a run: ``torch.profiler`` over the host
and the device, reduced to the device's activity and the host's events.

``Trace`` keeps every device activity (kernels, copies, sets) as (start, end,
name) on the profiler's clock, the host's operations (the runtime's kernel
launch calls left out) and the benchmark's own spans (``record_function``
ranges named ``portbench.*``). Busy time is the union of the device's intervals; an idle
gap is a stretch of the segment in which the device ran nothing, named by the
innermost host operation running at its middle.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

SPAN = "portbench."
SEGMENT = SPAN + "segment"


def _is_launch(name: str) -> bool:
    return "aunch" in name and "Kernel" in name


class Trace:
    def __init__(self, events: Iterable, window_s: float):
        from torch.autograd import DeviceType
        self.window_s = window_s
        dev, host = [], []
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for e in events:
            name = e.name()
            s = e.start_ns()
            t = s + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(SPAN) and not name.startswith("ProfilerStep"):
                    dev.append((s, t, name))
            elif name.startswith(SPAN):
                self.spans[name].append((s, t))
            elif not _is_launch(name):      # launch calls name no idle gap
                host.append((s, t, name))
        dev.sort()
        self.device = dev
        self.host = host
        seg = self.spans.get(SEGMENT)
        if seg:
            self.start, self.end = seg[0]
            self.window_s = (self.end - self.start) * 1e-9
        else:
            self.start = dev[0][0] if dev else 0
            self.end = dev[-1][1] if dev else 0
        self.merged = self._merge()

    def _merge(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, t, _ in self.device:
            s, t = max(s, self.start), min(t, self.end)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged) * 1e-9

    @property
    def kernels(self) -> int:
        """Kernels the device ran (copies and sets are not launches)."""
        return sum(1 for _, _, n in self.device if not n.startswith(("Memcpy", "Memset")))

    def kernel_s(self, names: Iterable[str]) -> float:
        """Device seconds of the kernels whose name holds any of ``names``."""
        names = tuple(names)
        return sum(t - s for s, t, n in self.device if any(k in n for k in names)) * 1e-9

    def span_count(self, span: str) -> int:
        return len(self.spans.get(SPAN + span, ()))

    def top_ops(self, k: int = 10) -> List[list]:
        """The device operations that took most time: [[name, seconds]]."""
        by = defaultdict(int)
        for s, t, n in self.device:
            by[n] += t - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v * 1e-9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The longest stretches with no device activity: [[what the host
        was doing, seconds]]."""
        edges = [self.start] + [x for ab in self.merged for x in ab] + [self.end]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        gaps = gaps[:k]
        if not gaps:
            return []
        hs = np.array([h[0] for h in self.host], dtype=np.int64)
        he = np.array([h[1] for h in self.host], dtype=np.int64)
        out = []
        for length, start in gaps:
            mid = start + length // 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(inside):
                j = inside[np.argmin(he[inside] - hs[inside])]
                what = self.host[j][2]
            else:
                what = "host: no operation"
            span = [n[len(SPAN):] for n, rs in self.spans.items() if n != SEGMENT
                    and any(a <= mid <= b for a, b in rs)]
            out.append([(span[0] + ": " if span else "") + what[:120], length * 1e-9])
        return out


@contextlib.contextmanager
def profiled(holder: dict):
    """Profile the block's host and device activity; on exit put its
    ``Trace`` in ``holder["trace"]``. The block's work must end in a
    synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(SEGMENT):
            yield
        window_s = time.perf_counter() - t0
    holder["trace"] = Trace(prof.profiler.kineto_results.events(), window_s)


def span(name: str):
    """A benchmark span around a call into the program (``portbench.<name>``)."""
    from torch.profiler import record_function
    return record_function(SPAN + name)
