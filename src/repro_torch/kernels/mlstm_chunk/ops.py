"""Chunkwise mLSTM wrapper: plain version on the CPU, CUDA kernels on the card.

``mlstm_chunk`` takes the model layout ``[B, S, H, d]`` as
``repro.kernels.mlstm_chunk.ops`` does, and the model's chunk (256 by
default, shrunk to a divisor of S as ``mlstm_chunkwise`` shrinks it). A CPU
tensor goes to the plain version (``ref.py``). A CUDA tensor launches
``csrc/mlstm_chunk.cu`` or raises:

* bfloat16 takes the two tensor-core kernels, a state pass and an output
  pass (``wgmma``, TMA). Their tensor maps are planned by
  ``tensor_map_plans`` (``kernels/_tma.py``, cached per layout); a layout TMA
  cannot take raises ``ValueError``. The state at the start of each interior
  chunk goes through scratch that this wrapper allocates (bf16 C, float32 n).
* float32 takes the CUDA-core kernel (float32 FMAs): ``wgmma`` in float32 is
  TF32, which would not hold the float32 tolerance.

Unlike the JAX wrapper it can return the final state ``(C, n, m)``, which the
model's prefill caches. ``mlstm_chunk.launches`` counts calls that launched
the kernels (one for the bf16 pair). The kernels have no backward yet: a
CUDA call that autograd would record raises ``NotImplementedError``; on the
CPU the plain version carries autograd.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tma import PLAN_VALUES, TensorMapPlan, tensor_map_plan
from repro_torch.kernels.mlstm_chunk.ref import chunk_size, mlstm_chunk_reference

MAX_CHUNK = 256
MAX_DQK = 512
BLOCK = 64           # rows of a TMA box: a query tile, a dqk tile, a slab of a chunk
MIN_TC_DIM = 64      # the bf16 kernels' least dqk and dv: one box wide
PLANS = 4            # q, k, v and the interior-chunk state


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_chunk")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mlstm_chunk_fwd_f32.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [i64p] * 6 + [ctypes.c_void_p])
    lib.mlstm_chunk_fwd_bf16.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [i64p, ctypes.c_void_p])
    for fn in (lib.mlstm_chunk_fwd_f32, lib.mlstm_chunk_fwd_bf16):
        fn.restype = ctypes.c_int
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


def tensor_map_plans(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     c_scr: Optional[torch.Tensor]) -> Tuple[TensorMapPlan, ...]:
    """The bf16 kernels' tensor maps: q, k [B, S, H, dqk] and v [B, S, H, dv]
    in 64-row boxes, and the interior-chunk state ``c_scr`` [N, dqk, dv]
    viewed as [N, dqk, 1, dv] (no plan without one). A box may run past dqk
    or dv: TMA fills the rest with zeros. Raises ``ValueError`` where TMA
    cannot take a layout."""
    plans = [tensor_map_plan(t, BLOCK, whole_boxes=False) for t in (q, k, v)]
    if c_scr is not None:
        plans.append(tensor_map_plan(c_scr.unsqueeze(2), BLOCK, whole_boxes=False))
    return tuple(plans)


@functools.lru_cache(maxsize=256)
def _packed(plans: Tuple[TensorMapPlan, ...], strides: Tuple[int, ...]) -> ctypes.Array:
    values = sum((p.values() for p in plans), ())
    values += (0,) * (PLANS * PLAN_VALUES - len(values))
    return _build.int64_array(values + strides)


def bf16_kernel_args(q, k, v, i_log, f_log, h, c_scr) -> ctypes.Array:
    """The bf16 entry point's ``args``: the four plans (zeros for a missing
    state plan), then the element strides (batch, seq, head) of i_log,
    f_log and h. Cached per layout; each call checks the base addresses."""
    return _packed(tensor_map_plans(q, k, v, c_scr),
                   i_log.stride() + f_log.stride() + h.stride()[:3])


def _launch(q, k, v, i_log, f_log, chunk: int):
    """Launch the kernels for CUDA tensors; returns h and (C, n, m)."""
    B, S, H, dqk = q.shape
    dv = v.shape[-1]
    if i_log.dtype != torch.float32 or f_log.dtype != torch.float32:
        raise ValueError("mlstm_chunk kernel takes float32 gates")
    if chunk > MAX_CHUNK:
        raise ValueError(f"mlstm_chunk kernel takes chunks up to {MAX_CHUNK}, got {chunk}")
    c = chunk_size(S, chunk)
    if dqk > MAX_DQK:
        raise ValueError(f"mlstm_chunk kernel takes dqk up to {MAX_DQK}, got {dqk}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit 65535")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("mlstm_chunk kernel needs a contiguous last dim")
    dev = q.device
    h = torch.empty((B, S, H, dv), dtype=v.dtype, device=dev)
    C = torch.empty((B, H, dqk, dv), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, dqk), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    outs = (h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr())
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), i_log.data_ptr(), f_log.data_ptr())
    lib = _lib()
    if q.dtype == torch.bfloat16:
        if min(dqk, dv) < MIN_TC_DIM:
            raise ValueError(f"the bf16 mlstm_chunk kernels take dqk and dv of at least "
                             f"{MIN_TC_DIM}, got {dqk}, {dv}")
        interior = B * H * (S // c - 1)
        c_scr = (torch.empty((interior, dqk, dv), dtype=torch.bfloat16, device=dev)
                 if interior else None)
        n_scr = (torch.empty((interior, dqk), dtype=torch.float32, device=dev)
                 if interior else None)
        args = bf16_kernel_args(q, k, v, i_log, f_log, h, c_scr)
        call = functools.partial(
            lib.mlstm_chunk_fwd_bf16, *ins, *outs,
            None if c_scr is None else c_scr.data_ptr(),
            None if n_scr is None else n_scr.data_ptr(), B, S, H, dqk, dv, c, args)
    elif q.dtype == torch.float32:
        strides = [_build.int64_array(t.stride()[:3])
                   for t in (q, k, v, i_log, f_log, h)]
        call = functools.partial(lib.mlstm_chunk_fwd_f32, *ins, *outs,
                                 B, S, H, dqk, dv, c, *strides)
    else:
        raise ValueError(f"mlstm_chunk kernel takes float32/bfloat16, got {q.dtype}")
    with torch.cuda.device(dev):
        err = call(torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "mlstm_chunk")
    mlstm_chunk.launches += 1
    return h, (C, n, m)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, i_log, f_log)):
        raise NotImplementedError(
            "mlstm_chunk has no backward kernel yet, so xLSTM does not train on the "
            "card (ROADMAP.md, 2.H); the plain version trains on the CPU")
    h, state = _launch(q, k, v, i_log, f_log, chunk)
    return (h, state) if return_state else h


mlstm_chunk.launches = 0
