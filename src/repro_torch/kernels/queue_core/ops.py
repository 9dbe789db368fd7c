"""Batched WS request-queue core: plain version on the CPU, CUDA kernel on the card.

``queue_core(kind, t, s, n_valid, horizon, slo, cap_t, cap_k, hi_t, k_pad)``
simulates one shape bucket of FIFO M/G/k(t) queues (``kind`` "const": the
Kiefer-Wolfowitz recurrence; "pw": piecewise capacity) and folds each job
into one [8] row of ``FOLD_COLS``; the arguments are those of
``ref.queue_core_reference``. CPU tensors go to that plain version; CUDA
tensors launch ``csrc/queue_core.cu`` (one block a job) or raise.
``queue_core.launches`` counts kernel launches: one a call, so one a bucket.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.queue_core.ref import KINDS, queue_core_reference

MAX_SHARED_BYTES = 227 * 1024        # dynamic shared memory a block may take on H100


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("queue_core")
    p = ctypes.c_void_p
    lib.queue_core_fwd.argtypes = ([ctypes.c_int, p, p, ctypes.c_int64] + [p] * 6
                                   + [ctypes.c_int] * 3 + [p, p, p])
    lib.queue_core_fwd.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel library now (before worker processes start)."""
    _lib()


def _check_inputs(kind, t, s, n_valid, horizon, slo, cap_t, cap_k, hi_t, k_pad):
    if kind not in KINDS:
        raise ValueError(f"unknown queue kind {kind!r}; have {KINDS}")
    if t.dim() != 2 or s.shape != t.shape:
        raise ValueError(f"t and s must be [B, n_pad] of one shape, got "
                         f"{tuple(t.shape)}, {tuple(s.shape)}")
    B = t.shape[0]
    if any(x.shape != (B,) for x in (n_valid, horizon, slo)):
        raise ValueError("n_valid, horizon and slo must be [B]")
    if cap_t.dim() != 2 or cap_t.shape[0] != B or cap_t.shape[1] < 1 \
            or cap_k.shape != cap_t.shape or hi_t.shape != cap_t.shape:
        raise ValueError("cap_t, cap_k and hi_t must be [B, e_pad] of one shape")
    if k_pad < 1:
        raise ValueError(f"k_pad must be at least 1, got {k_pad}")
    if cap_k.device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        # under CUDA graph capture the kernel checks instead (a NaN row)
        k_max = int(cap_k.max()) if cap_k.numel() else 0
        if k_max > k_pad:
            raise ValueError(f"k_pad {k_pad} is below a job's {k_max} slots")
    tensors = (t, s, n_valid, horizon, slo, cap_t, cap_k, hi_t)
    if len({x.device for x in tensors}) != 1:
        raise ValueError("queue_core inputs must be on one device")


def queue_core(kind: str, t, s, n_valid, horizon, slo, cap_t, cap_k, hi_t,
               k_pad: int) -> torch.Tensor:
    """One bucket of queue jobs -> [B, 8] float32 ``FOLD_COLS``."""
    _check_inputs(kind, t, s, n_valid, horizon, slo, cap_t, cap_k, hi_t, k_pad)
    if t.device.type == "cpu":
        return queue_core_reference(kind, t, s, n_valid, horizon, slo, cap_t,
                                    cap_k, hi_t, k_pad)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    B, n_pad = t.shape
    E = cap_t.shape[1]
    if (3 * E + k_pad) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"{E} capacity intervals and {k_pad} slots exceed the "
                         "kernel's shared memory")
    f32 = [x.float().contiguous() for x in (t, s, horizon, slo, cap_t, hi_t)]
    t, s, horizon, slo, cap_t, hi_t = f32
    n_valid = n_valid.to(torch.int32).contiguous()
    cap_k = cap_k.to(torch.int32).contiguous()
    lat = torch.empty((B, n_pad), dtype=torch.float32, device=t.device)
    out = torch.empty((B, 8), dtype=torch.float32, device=t.device)
    lib = _lib()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.queue_core_fwd(int(kind == "pw"), t.data_ptr(), s.data_ptr(), n_pad,
                                 n_valid.data_ptr(), horizon.data_ptr(), slo.data_ptr(),
                                 cap_t.data_ptr(), cap_k.data_ptr(), hi_t.data_ptr(),
                                 B, E, k_pad, lat.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, err, "queue_core")
    queue_core.launches += 1
    return out


queue_core.launches = 0
