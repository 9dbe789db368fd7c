"""Batched WS request-queue core: plain version on the CPU, CUDA kernel on the card.

``queue_flush(kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo,
k_max)`` simulates every job of a flush -- FIFO M/G/k(t) queues of both
kinds, ragged -- and folds each into one [8] row of ``FOLD_COLS``; the
arguments are those of ``ref.queue_flush_reference``, plus ``k_max``, at
least every job's largest k. CPU tensors go to that plain version; CUDA
tensors launch ``csrc/queue_core.cu`` once (one block a job) or raise. The
instance follows ``k_max`` (``slot_registers``): the slot vector in 1, 2, 4,
8 or 16 registers a lane up to 512 slots, in shared memory above.

``queue_core(kind, t, s, n_valid, horizon, slo, cap_t, cap_k, hi_t, k_pad)``
is the bucket form (one padded shape bucket of one kind, as the JAX
package's batched cores take it; the arguments of
``ref.queue_core_reference``): on the card it packs the bucket into the flat
form and calls ``queue_flush``.

``queue_flush.launches`` counts kernel launches, one a call of either form;
``queue_flush.instance_launches`` splits them by instance.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.queue_core.ref import (KINDS, queue_core_reference,
                                                queue_flush_reference)

MAX_SHARED_BYTES = 227 * 1024        # dynamic shared memory a block may take on H100
SLOT_REGISTERS = (1, 2, 4, 8, 16)    # register tiers: 32 slots each
INSTANCES = {1: "registers_1", 2: "registers_2", 4: "registers_4", 8: "registers_8",
             16: "registers_16", 0: "shared_memory"}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    lib.queue_flush_fwd.argtypes = ([ctypes.c_int] + [p] * 11 + [ctypes.c_int] * 2
                                    + [p, p, p])
    lib.queue_flush_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("queue_core"))


def build() -> None:
    """Build and load the kernel library now (before worker processes start)."""
    _lib()


def slot_registers(k_max: int) -> int:
    """Registers a lane of the slot vector for ``k_max`` slots (slot j in
    lane j % 32, register j // 32), or 0 above 512: the shared-memory
    instance."""
    for r in SLOT_REGISTERS:
        if k_max <= 32 * r:
            return r
    return 0


def _check_flat(kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo, k_max,
                n_valid):
    """Shapes and devices always; on CPU tensors the contents too (offsets in
    range, kinds, every job's slots within k_max, piecewise interval starts
    ascending from 0). On the card the kernel checks what it can without a
    sync (K <= k_max, starts ascending from 0, at least one interval: a NaN
    row otherwise)."""
    if kind.dim() != 1 or kind.shape[0] < 1:
        raise ValueError(f"kind must be [J] with J >= 1, got {tuple(kind.shape)}")
    J = kind.shape[0]
    if t.dim() != 1 or s.shape != t.shape:
        raise ValueError(f"t and s must be [N] of one shape, got {tuple(t.shape)}, "
                         f"{tuple(s.shape)}")
    if req_off.shape != (J + 1,) or cap_off.shape != (J + 1,):
        raise ValueError("req_off and cap_off must be [J + 1]")
    if cap_t.dim() != 1 or cap_k.shape != cap_t.shape or hi_t.shape != cap_t.shape:
        raise ValueError("cap_t, cap_k and hi_t must be [E] of one shape")
    if horizon.shape != (J,) or slo.shape != (J,) or (
            n_valid is not None and n_valid.shape != (J,)):
        raise ValueError("horizon, slo and n_valid must be [J]")
    if k_max < 1:
        raise ValueError(f"k_max must be at least 1, got {k_max}")
    if max(t.numel(), cap_t.numel()) >= 2 ** 31:
        raise ValueError("a flush holds fewer than 2**31 requests and intervals")
    tensors = [kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo]
    if len({x.device for x in tensors + ([] if n_valid is None else [n_valid])}) != 1:
        raise ValueError("queue_flush inputs must be on one device")
    if t.device.type != "cpu":
        return
    off, co, kinds = req_off.tolist(), cap_off.tolist(), kind.tolist()
    nv = n_valid.tolist() if n_valid is not None else None
    for j in range(J):
        if kinds[j] not in (0, 1):
            raise ValueError(f"job {j}: kind {kinds[j]} is neither 0 (const) nor 1 (pw)")
        if not 0 <= off[j] <= off[j + 1] <= t.shape[0] or (
                nv is not None and not 0 <= nv[j] <= off[j + 1] - off[j]):
            raise ValueError(f"job {j}: requests out of range")
        if not 0 <= co[j] < co[j + 1] <= cap_t.shape[0]:
            raise ValueError(f"job {j}: needs at least one capacity interval in range")
        ks = cap_k[co[j]:co[j + 1]] if kinds[j] else cap_k[co[j]:co[j] + 1]
        if int(ks.max()) > k_max:
            raise ValueError(f"job {j}: k_max {k_max} is below its {int(ks.max())} slots")
        starts = cap_t[co[j]:co[j + 1]]
        if kinds[j] and (starts[0] < 0 or bool((starts[1:] < starts[:-1]).any())):
            raise ValueError(f"job {j}: capacity interval starts must ascend from 0")


def _launch(kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo, k_max: int,
            n_valid=None, lib=None) -> torch.Tensor:
    """One launch for CUDA tensors (checked by the caller), from the built
    library unless another (bound by ``_bind``) is given."""
    regs = slot_registers(k_max)
    if regs == 0 and k_max * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"{k_max} slots exceed the kernel's shared memory")
    kind, req_off, cap_k, cap_off = (x.to(torch.int32).contiguous()
                                     for x in (kind, req_off, cap_k, cap_off))
    t, s, cap_t, hi_t, horizon, slo = (x.float().contiguous()
                                       for x in (t, s, cap_t, hi_t, horizon, slo))
    if n_valid is not None:
        n_valid = n_valid.to(torch.int32).contiguous()
    J = kind.shape[0]
    lat = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    out = torch.empty((J, 8), dtype=torch.float32, device=t.device)
    lib = lib or _lib()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.queue_flush_fwd(
            regs, kind.data_ptr(), t.data_ptr(), s.data_ptr(), req_off.data_ptr(),
            None if n_valid is None else n_valid.data_ptr(), cap_t.data_ptr(),
            cap_k.data_ptr(), hi_t.data_ptr(), cap_off.data_ptr(), horizon.data_ptr(),
            slo.data_ptr(), J, k_max, lat.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, err, "queue_flush")
    return out


def queue_flush(kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo,
                k_max: int, n_valid=None) -> torch.Tensor:
    """Every job of a flush -> [J, 8] float32 ``FOLD_COLS``, one launch."""
    _check_flat(kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo, k_max,
                n_valid)
    if t.device.type == "cpu":
        return queue_flush_reference(kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off,
                                     horizon, slo, n_valid)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    out = _launch(kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo, k_max,
                  n_valid)
    queue_flush.launches += 1
    queue_flush.instance_launches[INSTANCES[slot_registers(k_max)]] += 1
    return out


queue_flush.launches = 0
queue_flush.instance_launches = dict.fromkeys(INSTANCES.values(), 0)


def reset_launches() -> None:
    """Zero ``queue_flush.launches`` and its split by instance."""
    queue_flush.launches = 0
    for name in queue_flush.instance_launches:
        queue_flush.instance_launches[name] = 0


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
    (B, n_pad), E = t.shape, cap_t.shape[1]
    rows = torch.arange(B + 1, dtype=torch.int32, device=t.device)
    kinds = torch.full((B,), KINDS.index(kind), dtype=torch.int32, device=t.device)
    return queue_flush(kinds, t.reshape(-1), s.reshape(-1), rows * n_pad,
                       cap_t.reshape(-1), cap_k.reshape(-1), hi_t.reshape(-1), rows * E,
                       horizon, slo, k_pad, n_valid=n_valid)
