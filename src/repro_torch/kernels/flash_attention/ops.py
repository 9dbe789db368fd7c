"""Flash attention wrapper: plain version on the CPU, CUDA kernel on the card.

``flash_attention`` takes the model layout ``[B, S, H, hd]`` / ``[B, S, K, hd]``
as ``repro.kernels.flash_attention.ops`` does. A CPU tensor goes to the plain
version (``ref.py``); a CUDA tensor launches ``csrc/flash_attention.cu``
(head_dim 128 or 256) or raises. ``flash_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (128, 256)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [i64p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                        ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects q [B,S,H,hd], k/v [B,S,K,hd]")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"query heads {H} not a multiple of kv heads {k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must have one dtype")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k/v: [B, S, K, hd]. Returns [B, S, H, hd] in q's dtype."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, S, H, hd = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes float32/bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim {HEAD_DIMS}, got {hd}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit 65535")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a contiguous head dim")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    strides = [_build.int64_array(t.stride()[:3]) for t in (q, k, v, out)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, k.shape[2], hd, *strides,
            int(causal), int(window), 1.0 / math.sqrt(hd), stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
