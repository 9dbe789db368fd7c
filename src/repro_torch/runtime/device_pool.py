"""Maps Phoenix node counts onto concrete CUDA devices, for N tenants
(counterpart of ``repro.runtime.device_pool``).

The provision service reasons in fungible node counts; this pool assigns
actual devices to named tenant groups. The legacy two-group (``st``/``ws``)
interface is kept as aliases over the named groups. With no device list the
pool takes every CUDA device, and raises when there is none: the CPU is used
only when the caller lists it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


def cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass devices="
                           "[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DevicePool:
    def __init__(self, devices: Optional[Sequence] = None,
                 groups: Sequence[str] = ("st", "ws")):
        self.devices = [torch.device(d) for d in devices] \
            if devices is not None else cuda_devices()
        self.free = list(self.devices)
        self.groups: Dict[str, List[torch.device]] = {g: [] for g in groups}

    @property
    def total(self) -> int:
        return len(self.devices)

    def add_group(self, name: str) -> None:
        if name in self.groups:
            raise ValueError(f"group {name!r} exists")
        self.groups[name] = []

    def check(self):
        assigned = sum(len(g) for g in self.groups.values())
        assert len(self.free) + assigned == self.total, \
            (len(self.free), {k: len(v) for k, v in self.groups.items()},
             self.total)

    # -------------------------------------------------------- named groups
    def grant(self, name: str, n: int) -> List[torch.device]:
        """Move up to n free devices into the named group."""
        n = min(n, len(self.free))
        got, self.free = self.free[:n], self.free[n:]
        self.groups[name].extend(got)
        self.check()
        return got

    def reclaim(self, name: str, n: int) -> List[torch.device]:
        """Take n devices back from the named group (most recent first;
        the caller must resize/stop the workload on them)."""
        grp = self.groups[name]
        n = min(n, len(grp))
        got = grp[-n:] if n else []
        self.groups[name] = grp[:-n] if n else grp
        self.free.extend(got)
        self.check()
        return got

    # ------------------------------------------------- legacy two-tenant API
    @property
    def st(self) -> List[torch.device]:
        return self.groups["st"]

    @property
    def ws(self) -> List[torch.device]:
        return self.groups["ws"]

    def grant_st(self, n: int) -> List[torch.device]:
        return self.grant("st", n)

    def grant_ws(self, n: int) -> List[torch.device]:
        return self.grant("ws", n)

    def reclaim_st(self, n: int) -> List[torch.device]:
        return self.reclaim("st", n)

    def release_ws(self, n: int) -> List[torch.device]:
        return self.reclaim("ws", n)
