"""Flash attention wrapper: plain version on the CPU, CUDA kernels on the card.

``flash_attention`` takes the model layout ``[B, S, H, hd]`` / ``[B, S, K, hd]``
as ``repro.kernels.flash_attention.ops`` does. A CPU tensor goes to the plain
version (``ref.py``). A CUDA tensor launches ``csrc/flash_attention.cu``
(head_dim 16, 64, 128 or 256) or raises:

* bfloat16 at head_dim 64, 128 or 256 takes the tensor-core kernel: ``wgmma``
  products, K/V tiles fed by TMA through a ring of shared-memory stages. Its tensor maps are planned by
  ``tensor_map_plan`` (``kernels/_tma.py``, cached per shape and strides; the
  base address is checked on every call); a layout TMA cannot take (a byte
  stride that is not a multiple of 16, a base that is not 16-byte aligned, a
  strided head dim) raises ``ValueError``.
* float32, and bfloat16 at head_dim 16, take the CUDA-core kernel (float32
  FMAs): ``wgmma`` in float32 is TF32, which would not hold the float32
  tolerance, and a 16-column bf16 row is narrower than the tensor-core
  kernel's 128-byte swizzle box.

``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tma import BOX_COLS, TensorMapPlan, tensor_map_plan  # noqa: F401
from repro_torch.kernels.flash_attention.ref import flash_attention_reference

HEAD_DIMS = (16, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)   # bf16 head dims of the tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 64         # query rows a block: wgmma's M (BM in the source)
BLOCK_K = 64         # keys a K/V tile (BK in the source)


@functools.lru_cache(maxsize=256)
def _packed(plans: Tuple[TensorMapPlan, ...], o_stride: Tuple[int, ...]) -> ctypes.Array:
    return _build.int64_array(sum((p.values() for p in plans), ()) + o_stride)


def bf16_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor) -> ctypes.Array:
    """The bf16 entry point's ``args``: the plans of q (64-row boxes), k and v
    (``BLOCK_K``-row boxes), then out's element strides (batch, seq, head).
    Plans and the packed array are cached per layout; each call checks the
    three base addresses."""
    plans = (tensor_map_plan(q, BLOCK_Q), tensor_map_plan(k, BLOCK_K),
             tensor_map_plan(v, BLOCK_K))
    return _packed(plans, out.stride()[:3])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.flash_attention_fwd_cc.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [i64p] * 4
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd_bf16.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [i64p]
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.flash_attention_fwd_cc, lib.flash_attention_fwd_bf16):
        fn.restype = ctypes.c_int
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


def _launch(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    """Launch the kernel for CUDA tensors."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim {HEAD_DIMS}, got {hd}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit 65535")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes float32/bfloat16, got {q.dtype}")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    if q.dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        entry, lead = "flash_attention_fwd_bf16", ()
        args = (bf16_kernel_args(q, k, v, out), int(causal), int(window), scale)
    else:
        if any(t.stride(3) != 1 for t in (q, k, v)):
            raise ValueError("flash_attention kernel needs a contiguous head dim")
        entry, lead = "flash_attention_fwd_cc", (_DTYPES[q.dtype],)
        strides = [_build.int64_array(t.stride()[:3]) for t in (q, k, v, out)]
        args = (*strides, int(causal), int(window), scale)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), B, S, H, K, hd, *args, stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k/v: [B, S, K, hd]. Returns [B, S, H, hd] in q's dtype."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
