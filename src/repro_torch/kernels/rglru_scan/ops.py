"""RG-LRU scan wrapper: plain version on the CPU, CUDA kernel on the card.

``rglru_scan(a, b, h0)`` computes ``h_t = a_t * h_{t-1} + b_t`` over
``a, b [B, S, W]`` from ``h0 [B, W]`` with a float32 carry, as
``repro.kernels.rglru_scan.ops`` does; the output is in b's dtype. A CPU
tensor goes to the plain version (``ref.py``); a CUDA tensor launches
``csrc/rglru_scan.cu`` or raises. The kernel splits the sequence into chunks
over the blocks of a thread-block cluster as ``scan_plan`` says, and stages
its tiles by bulk copies where ``bulk_copies`` allows them.

Training: where autograd records (grad mode on and an input that requires
grad), ``rglru_scan`` runs through ``RGLRUScanFunction``, which keeps the
forward's h and whose backward calls ``rglru_scan_backward``: on the card
the backward kernel of ``csrc/rglru_scan.cu`` (the same split-S plan walked
from the end, float32), on the CPU the explicit reverse recurrence of
``ref.py``. ``rglru_scan.launches`` counts forward kernel launches and
``rglru_scan_backward.launches`` backward ones.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_backward_reference,
                                               rglru_scan_reference)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CLUSTER = 8      # chunks a round: blocks of a portable cluster
MAX_CHUNK = 64       # steps a block stages a round
MIN_CHUNK = 16       # a short sequence takes fewer chunks, of at least this many steps


class ScanPlan(NamedTuple):
    """How the kernel covers S: ``clusters`` chunks a round (blocks of a
    cluster), each of ``chunk`` steps (the last ones may take fewer, or
    none), over ``rounds`` rounds."""
    clusters: int
    chunk: int
    rounds: int


@functools.lru_cache(maxsize=256)
def scan_plan(S: int) -> ScanPlan:
    """The fewest rounds of at most ``MAX_CLUSTER`` chunks of at most
    ``MAX_CHUNK`` steps, with chunks of about equal length and at least
    ``MIN_CHUNK`` steps where S allows: [4, 512, W] takes 8 chunks of 64
    steps in one round."""
    if S < 1:
        raise ValueError(f"no scan plan for S = {S}")
    clusters = min(MAX_CLUSTER, max(1, S // MIN_CHUNK))
    rounds = -(-S // (clusters * MAX_CHUNK))
    return ScanPlan(clusters, -(-S // (clusters * rounds)), rounds)


def bulk_copies(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the kernel can stage a and b [B, S, W] by 1-D bulk copies: a
    16-byte aligned base, and batch and seq byte strides (of dims longer
    than 1) and a row of W elements that are multiples of 16. Otherwise it
    stages them by plain loads."""
    for t in (a, b):
        size = t.element_size()
        if t.data_ptr() % 16 or t.shape[2] * size % 16:
            return False
        if any(n > 1 and st * size % 16 for n, st in zip(t.shape[:2], t.stride()[:2])):
            return False
    return True


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rglru_scan_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [i64p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.rglru_scan_fwd.restype = ctypes.c_int
    lib.rglru_scan_bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.rglru_scan_bwd.restype = ctypes.c_int
    return lib


def _check_inputs(a, b, h0):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan expects a, b [B,S,W] of one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be [B,W] = {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")
    if not (a.device == b.device == h0.device):
        raise ValueError("a, b and h0 must be on one device")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: [B, S, W]; h0: [B, W]. Returns h: [B, S, W] in b's dtype."""
    _check_inputs(a, b, h0)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        return RGLRUScanFunction.apply(a, b, h0)
    return _forward(a, b, h0)


def _forward(a, b, h0):
    if a.device.type == "cpu":
        return rglru_scan_reference(a, b, h0)
    if a.dtype not in _DTYPES or a.dtype != b.dtype:
        raise ValueError("rglru_scan kernel takes a and b of one dtype, float32 "
                         f"or bfloat16, got {a.dtype}, {b.dtype}")
    if h0.dtype not in _DTYPES:
        raise ValueError(f"rglru_scan kernel takes a float32/bfloat16 h0, got {h0.dtype}")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("rglru_scan kernel needs a contiguous last dim (W)")
    B, S, W = a.shape
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the kernel's grid limit 65535")
    h0 = h0.float().contiguous()            # the carry is float32
    out = torch.empty((B, S, W), dtype=b.dtype, device=b.device)
    lib = _lib()
    strides = [_build.int64_array(t.stride()[:2]) for t in (a, b, out)]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_fwd(_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                                 h0.data_ptr(), out.data_ptr(), B, S, W,
                                 *strides, *scan_plan(S), int(bulk_copies(a, b)), stream)
    _build.check(lib, err, "rglru_scan")
    rglru_scan.launches += 1
    return out


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                        dh: torch.Tensor):
    """da, db [B, S, W] and dh0 [B, W], float32, of ``rglru_scan`` from a,
    its output h, h0 and the gradient dh of h. The plain reverse recurrence
    on the CPU; on the card the backward kernel (float32: a, h and dh are
    widened first) or an error."""
    _check_inputs(a, h, h0)
    if dh.shape != h.shape:
        raise ValueError(f"dh must be {tuple(h.shape)}, got {tuple(dh.shape)}")
    if a.device.type == "cpu":
        return rglru_scan_backward_reference(a, h, h0, dh)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    B, S, W = a.shape
    if B > 65535:
        raise ValueError(f"B = {B} exceeds the kernel's grid limit 65535")
    a, h, h0, dh = (t.float().contiguous() for t in (a, h, h0, dh))
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_bwd(*(t.data_ptr() for t in (a, h, h0, dh, da, db, dh0)),
                                 B, S, W, *scan_plan(S), stream)
    _build.check(lib, err, "rglru_scan_backward")
    rglru_scan_backward.launches += 1
    return da, db, dh0


class RGLRUScanFunction(torch.autograd.Function):
    """``rglru_scan`` with a gradient: the forward kernel (or plain version),
    then the backward kernel (or plain reverse recurrence) from the saved h."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _forward(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.dtypes = (a.dtype, b.dtype, h0.dtype)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_backward(a, h, h0, dh)
        return tuple(g.to(dt) if need else None for g, dt, need in
                     zip((da, db, dh0), ctx.dtypes, ctx.needs_input_grad))


rglru_scan.launches = 0
rglru_scan_backward.launches = 0
