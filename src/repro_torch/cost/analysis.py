"""Per-rank cost counter: FLOPs, HBM bytes, collective wire bytes, peak
memory and kernel launches of the program the port dispatches (counterpart
of ``repro.hlo.analysis``).

The JAX package parses the compiled HLO text. The port emits no HLO: it
runs eager PyTorch, so ``CostCounter`` (a ``TorchDispatchMode``, one a rank)
counts each aten op as it is dispatched, on the card, on the CPU or on the
``meta`` device (shapes without data: the dry run's).

* ``flops``: the products, by ``torch.utils.flop_counter``'s formulas for
  ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and the convolutions, plus the
  work each of the port's kernels reports (``report_kernel``, by the
  formulas of ``cost.kernels``, which ``chip_smoke.py``'s kernel bounds
  use too). Elementwise work is not counted, as the HLO counter counts
  only dots and convolutions.
* ``hbm_bytes``: the eager cost model. Each dispatched op that launches a
  kernel reads its inputs and writes its outputs once; views, metadata ops
  and ``empty`` cost nothing; a kernel of the port moves the bytes its
  formula says. This stands where the JAX counter's fusion model stands (a
  fusion is one round trip of its operands and result): eager PyTorch
  fuses nothing, so this is what the port's program moves.
* ``collective_bytes`` / ``collective_detail``: the bytes a rank sends, by
  kind, over the collectives of ``sharding.collectives``, with the ring
  factors of ``HloCostModel._ring_factor``: all-reduce 2(n-1)/n of the
  payload; all-gather, reduce-scatter and all-to-all (n-1)/n of the whole
  payload (the gathered output, the scattered input).
* ``peak_bytes``: the high-water mark of live storages, counted by storage
  (not by view) from the op that allocates it until it is freed. The
  tensors of ``live`` (parameters, optimizer state, caches: whatever
  exists before the counted call) count from the start.
* ``kernel_detail``: launches, FLOPs and bytes by kernel; on ``meta`` the
  launches the card would make.

The HLO counter's XLA-only keys have no counterpart here: ``convert_bytes``
and ``hbm_bytes_tpu`` (bf16<->f32 converts that only XLA:CPU inserts) and
``unknown_trip_whiles`` (an eager program has no loops to unroll).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_ACTIVE: List["CostCounter"] = []

_FLOP_OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
             "convolution_backward")
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "detach", "alias", "lift_fresh", "_local_scalar_dense", "resize_", "set_"}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _flop_formulas() -> Dict[Any, Callable]:
    from torch.utils.flop_counter import flop_registry
    out = {}
    for name in _FLOP_OPS:
        packet = getattr(torch.ops.aten, name, None)
        if packet is not None and packet in flop_registry:
            out[packet] = flop_registry[packet]
    return out


def ring_bytes(kind: str, payload: float, n: int) -> float:
    """Wire bytes a rank sends for one collective over ``n`` ranks
    (``HloCostModel._ring_factor``; ``payload`` is the whole tensor: the
    gathered output of an all-gather, the input of a reduce-scatter). A
    group of one rank sends nothing."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * frac * payload
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return frac * payload
    raise ValueError(f"unknown collective {kind!r}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(obj, out: List[torch.Tensor], seen: set) -> None:
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, torch.nn.Module):
        out.extend(obj.parameters())
        out.extend(obj.buffers())
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out, seen)


class CostCounter(TorchDispatchMode):
    """Counts what is dispatched while it is entered (``with
    CostCounter(live=(state,)) as c: ...``; then ``c.totals()``)."""

    def __init__(self, live=()):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective: Dict[str, float] = defaultdict(float)
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.ops = 0
        self._live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self._formulas = _flop_formulas()
        held: List[torch.Tensor] = []
        _tensors(live, held, set())
        for t in held:
            self._hold(t)

    # ------------------------------------------------------------ storages
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        n = self._live.pop(key, None)
        if n is not None:
            self.current -= n

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        self.ops += 1
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        name = func._overloadpacket.__name__
        if not func.is_view and name not in _FREE:
            reads = sum(min(_nbytes(t), t.untyped_storage().nbytes()) for t in ins)
            self.hbm_bytes += reads + sum(_nbytes(t) for t in outs)
        if outs:
            inputs = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                if t.untyped_storage()._cdata not in inputs:
                    self._hold(t)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ reports
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        row = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.hbm_bytes += nbytes

    def totals(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": sum(self.collective.values()),
                "collective_detail": dict(self.collective), "peak_bytes": self.peak,
                "kernel_detail": {k: dict(v) for k, v in sorted(self.kernels.items())},
                "ops": self.ops}


def report_kernel(name: str, flops: float, nbytes: float) -> None:
    """A kernel of the port ran (or, on ``meta``, would run) with this work."""
    for c in _ACTIVE:
        c.kernel(name, flops, nbytes)


def report_collective(kind: str, payload: float, n: int) -> None:
    wire = ring_bytes(kind, payload, n)
    for c in _ACTIVE:
        c.collective[kind] += wire


def counting() -> bool:
    return bool(_ACTIVE)


def analyze(fn: Callable, *args, live=(), **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a counter and return its totals;
    ``args`` and ``live`` count as live from the start."""
    with CostCounter(live=(args, kwargs, live)) as c:
        fn(*args, **kwargs)
    return c.totals()
