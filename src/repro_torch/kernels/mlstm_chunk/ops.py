"""Chunkwise mLSTM wrapper: plain version on the CPU, CUDA kernel on the card.

``mlstm_chunk`` takes the model layout ``[B, S, H, d]`` as
``repro.kernels.mlstm_chunk.ops`` does, and the model's chunk (256 by
default, shrunk to a divisor of S as ``mlstm_chunkwise`` shrinks it). A CPU
tensor goes to the plain version (``ref.py``); a CUDA tensor launches
``csrc/mlstm_chunk.cu`` or raises. Unlike the JAX wrapper it can return the
final state ``(C, n, m)``, which the model's prefill caches.
``mlstm_chunk.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_chunk.ref import chunk_size, mlstm_chunk_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256
MAX_DQK = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_chunk")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mlstm_chunk_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [i64p] * 6 + [ctypes.c_void_p])
    lib.mlstm_chunk_fwd.restype = ctypes.c_int
    return lib


def _check_inputs(q, k, v, i_log, f_log, chunk):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("mlstm_chunk expects q/k [B,S,H,dqk], v [B,S,H,dv]")
    B, S, H, _ = q.shape
    if k.shape != q.shape or v.shape[:3] != (B, S, H):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if i_log.shape != (B, S, H) or f_log.shape != (B, S, H):
        raise ValueError(f"gates must be [B,S,H] = {(B, S, H)}, got "
                         f"{tuple(i_log.shape)}, {tuple(f_log.shape)}")
    if len({t.device for t in (q, k, v, i_log, f_log)}) != 1:
        raise ValueError("q, k, v and the gates must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must have one dtype")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_log: torch.Tensor, f_log: torch.Tensor, *, chunk: int = 256,
                return_state: bool = False):
    """q,k: [B,S,H,dqk]; v: [B,S,H,dv]; i_log/f_log: [B,S,H] float32.

    Returns h [B,S,H,dv] in v's dtype and, with ``return_state``, the final
    float32 state ``(C [B,H,dqk,dv], n [B,H,dqk], m [B,H])``.
    """
    _check_inputs(q, k, v, i_log, f_log, chunk)
    if q.device.type == "cpu":
        return mlstm_chunk_reference(q, k, v, i_log, f_log, chunk=chunk,
                                     return_state=return_state)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, S, H, dqk = q.shape
    dv = v.shape[-1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"mlstm_chunk kernel takes float32/bfloat16, got {q.dtype}")
    if i_log.dtype != torch.float32 or f_log.dtype != torch.float32:
        raise ValueError("mlstm_chunk kernel takes float32 gates")
    if chunk > MAX_CHUNK:
        raise ValueError(f"mlstm_chunk kernel takes chunks up to {MAX_CHUNK}, got {chunk}")
    if dqk > MAX_DQK:
        raise ValueError(f"mlstm_chunk kernel takes dqk up to {MAX_DQK}, got {dqk}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit 65535")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("mlstm_chunk kernel needs a contiguous last dim")
    c = chunk_size(S, chunk)
    dev = q.device
    h = torch.empty((B, S, H, dv), dtype=v.dtype, device=dev)
    C = torch.empty((B, H, dqk, dv), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, dqk), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    lib = _lib()
    strides = [_build.int64_array(t.stride()[:3]) for t in (q, k, v, i_log, f_log, h)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_chunk_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            i_log.data_ptr(), f_log.data_ptr(), h.data_ptr(), C.data_ptr(),
            n.data_ptr(), m.data_ptr(), B, S, H, dqk, dv, c, *strides, stream)
    _build.check(lib, err, "mlstm_chunk")
    mlstm_chunk.launches += 1
    return (h, (C, n, m)) if return_state else h


mlstm_chunk.launches = 0
