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
model's prefill caches.

Training: where autograd records (grad mode on and an input that requires
grad), ``mlstm_chunk`` runs through ``MLSTMChunkFunction``. Its forward is
the same kernels (or plain version) and saves q, k, v, the gates and h; its
backward calls ``mlstm_chunk_backward``: on the card
``csrc/mlstm_chunk_bwd.cu`` (no atomics: a second call gives the same bits),
on the CPU the explicit formulas of ``ref.mlstm_chunk_backward_reference``,
so the CPU tests check what the kernel computes. Both hold the stabilisers
constant, which is the exact gradient (``ref.py``). ``backward_path`` picks
the kernel's path from the dtype and the widths alone: bfloat16 with 64 <=
dqk <= 512 and dv >= 64 takes five tensor-core launches (``wgmma``, TMA;
dqk and dv multiples of 8, else ``ValueError``), everything else six
launches on CUDA cores. A final state returned under autograd is detached:
the model caches it only in prefill, which takes no gradient. The
backward's scratch (``workspace_floats``, float32 slots) is allocated here.

``mlstm_chunk.launches`` counts calls that launched the forward kernels (one
for the bf16 pair) and ``mlstm_chunk_backward.launches`` backward calls that
launched their kernels (one a call, however many kernels it launches).

A ``meta`` tensor (the dry run's) takes the CUDA path up to the launch,
forward and backward: outputs of the kernels' shapes and the scratch the
CUDA path allocates, and no launch. On ``meta`` and on the card each kernel
call reports its work (``cost.kernels.mlstm``, ``cost.kernels.mlstm_backward``)
to an active cost counter (``cost.analysis``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.cost import analysis, kernels as work
from repro_torch.kernels import _build
from repro_torch.kernels._tma import PLAN_VALUES, TensorMapPlan, tensor_map_plan
from repro_torch.kernels.mlstm_chunk.ref import (chunk_size, mlstm_chunk_backward_reference,
                                                 mlstm_chunk_reference)

MAX_CHUNK = 256
MAX_DQK = 512
BLOCK = 64           # rows of a TMA box: a query tile, a dqk tile, a slab of a chunk
MIN_TC_DIM = 64      # the bf16 kernels' least dqk and dv: one box wide
PLANS = 4            # q, k, v and the interior-chunk state
TILE = 64            # the CUDA-core backward's output tiles: rows, dqk and dv columns
TC_N = 256           # the tensor-core backward's dqk and dv columns a tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_chunk_bwd")
    lib.mlstm_chunk_bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                                    + [ctypes.c_int64] + [ctypes.c_int] * 6
                                    + [ctypes.c_void_p])
    lib.mlstm_chunk_bwd_bf16.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int64]
                                         + [ctypes.c_int] * 6
                                         + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    for fn in (lib.mlstm_chunk_bwd, lib.mlstm_chunk_bwd_bf16):
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


def _pointers(q, k, v, i_log, f_log, h, C, n, m):
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), i_log.data_ptr(), f_log.data_ptr()),
            (h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr()), _lib())


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
    if analysis.counting():
        analysis.report_kernel("mlstm_chunk", *work.mlstm(B, S, H, dqk, dv, c,
                                                          q.element_size()))
    meta = dev.type == "meta"
    if q.dtype == torch.bfloat16:
        if min(dqk, dv) < MIN_TC_DIM:
            raise ValueError(f"the bf16 mlstm_chunk kernels take dqk and dv of at least "
                             f"{MIN_TC_DIM}, got {dqk}, {dv}")
        interior = B * H * (S // c - 1)
        c_scr = (torch.empty((interior, dqk, dv), dtype=torch.bfloat16, device=dev)
                 if interior else None)
        n_scr = (torch.empty((interior, dqk), dtype=torch.float32, device=dev)
                 if interior else None)
        if meta:
            return h, (C, n, m)
        ins, outs, lib = _pointers(q, k, v, i_log, f_log, h, C, n, m)
        args = bf16_kernel_args(q, k, v, i_log, f_log, h, c_scr)
        call = functools.partial(
            lib.mlstm_chunk_fwd_bf16, *ins, *outs,
            None if c_scr is None else c_scr.data_ptr(),
            None if n_scr is None else n_scr.data_ptr(), B, S, H, dqk, dv, c, args)
    elif q.dtype == torch.float32:
        if meta:
            return h, (C, n, m)
        ins, outs, lib = _pointers(q, k, v, i_log, f_log, h, C, n, m)
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


def backward_path(dtype: torch.dtype, dqk: int, dv: int) -> str:
    """The backward kernel's path, from the dtype and the widths alone:
    ``"tensor_cores"`` for bfloat16 with ``MIN_TC_DIM <= dqk <= MAX_DQK`` and
    ``dv >= MIN_TC_DIM``, else ``"cuda_cores"`` (float32, whose ``wgmma``
    would be TF32, and rows narrower than one 64-column TMA box)."""
    if dtype == torch.bfloat16 and MIN_TC_DIM <= dqk <= MAX_DQK and dv >= MIN_TC_DIM:
        return "tensor_cores"
    return "cuda_cores"


def _align32(n: int) -> int:
    return -(-n // 32) * 32


def workspace_floats(B: int, S: int, H: int, dqk: int, dv: int, c: int,
                     dtype: torch.dtype) -> int:
    """The backward kernels' scratch in float32 slots (``csrc/mlstm_chunk_bwd.cu``:
    ``tc_workspace_floats`` and ``workspace_floats``), by ``backward_path``.
    Tensor cores: per position the gate terms, N, dden, dlogD's row sums and
    the partial column and row sums; per chunk the decay and the partial
    dots; n_t and dn_t [dqk] and, as bf16 hi and lo (one slot each), C_t and
    G_t [dqk, dv] of the T - 1 interior chunk boundaries and dS, W' [cp, cp]
    of every chunk (cp: c rounded up to 64); each part rounded up to 32
    slots.
    CUDA cores: per position the gate terms, N, dden, dlogD's row sums and
    the partial column and row sums; per chunk the decay and the partial
    dots; the chunk-start states and their gradients (C [dqk, dv] and n
    [dqk] each) and dS, W [c, c] of every chunk, all float32."""
    BH, T = B * H, S // c
    if backward_path(dtype, dqk, dv) == "tensor_cores":
        R = -(-c // BLOCK)
        DH, EH, DT, cp = -(-dqk // TC_N), -(-dv // TC_N), -(-dqk // BLOCK), BLOCK * R
        a = _align32
        return (8 * a(BH * S) + a(BH * T) + a(R * BH * S) + 2 * a(DH * BH * S)
                + a(DT * EH * BH * T) + a(DT * BH * T) + 2 * a(BH * (T - 1) * dqk)
                + 2 * a(BH * (T - 1) * dqk * dv) + 2 * a(BH * T * cp * cp))
    R, DT, ET = -(-c // TILE), -(-dqk // TILE), -(-dv // TILE)
    return (BH * S * (8 + R + 2 * DT) + BH * T * (1 + DT * ET + DT)
            + 2 * BH * T * dqk * (dv + 1) + 2 * BH * S * c)


def mlstm_chunk_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_log: torch.Tensor, f_log: torch.Tensor, h: torch.Tensor,
                         dh: torch.Tensor, *, chunk: int = 256):
    """dq, dk, dv (q's, k's and v's dtype) and di, df (float32) of
    ``mlstm_chunk`` from its inputs, its output h and the output's gradient
    dh [B,S,H,dv]. The plain formulas on the CPU; on the card the backward
    kernels or an error."""
    _check_inputs(q, k, v, i_log, f_log, chunk)
    if h.shape != v.shape or dh.shape != v.shape or h.dtype != v.dtype or dh.dtype != v.dtype:
        raise ValueError(f"h and dh must be {tuple(v.shape)} {v.dtype}, got "
                         f"{tuple(h.shape)} {h.dtype}, {tuple(dh.shape)} {dh.dtype}")
    if q.device.type == "cpu":
        return mlstm_chunk_backward_reference(q, k, v, i_log, f_log, h, dh, chunk=chunk)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    return _launch_backward(q, k, v, i_log, f_log, h, dh, chunk)


def _launch_backward(q, k, v, i_log, f_log, h, dh, chunk: int):
    """Launch the backward kernels for CUDA tensors; returns dq, dk, dv, di,
    df."""
    B, S, H, dqk = q.shape
    dv = v.shape[-1]
    if i_log.dtype != torch.float32 or f_log.dtype != torch.float32:
        raise ValueError("mlstm_chunk backward kernel takes float32 gates")
    if chunk > MAX_CHUNK:
        raise ValueError(f"mlstm_chunk backward kernel takes chunks up to {MAX_CHUNK}, "
                         f"got {chunk}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"mlstm_chunk backward kernel takes float32/bfloat16, got {q.dtype}")
    c = chunk_size(S, chunk)
    if B * H * (S // c) > 65535:
        raise ValueError(f"B*H*chunks = {B * H * (S // c)} exceeds the backward kernel's "
                         "grid limit 65535")
    path = backward_path(q.dtype, dqk, dv)
    tensor_cores = path == "tensor_cores"
    if tensor_cores and (dqk % 8 or dv % 8):
        raise ValueError(f"the bf16 mlstm_chunk backward kernels take dqk and dv that are "
                         f"multiples of 8 (16-byte rows for TMA), got {dqk}, {dv}")
    # the kernels take contiguous [B, S, H, d] rows (a copy only where
    # autograd hands over another layout)
    q, k, v, i_log, f_log, h, dh = (t.contiguous() for t in (q, k, v, i_log, f_log, h, dh))
    dq, dk, dv_, di, df = (torch.empty_like(t) for t in (q, k, v, i_log, f_log))
    floats = workspace_floats(B, S, H, dqk, dv, c, q.dtype)
    ws = torch.empty(floats, dtype=torch.float32, device=q.device)
    if analysis.counting():
        analysis.report_kernel("mlstm_chunk_backward", *work.mlstm_backward(
            B, S, H, dqk, dv, c, q.element_size(), path=path))
    if q.device.type == "meta":
        return dq, dk, dv_, di, df
    lib = _bwd_lib()
    tensors = (q, k, v, i_log, f_log, h, dh, dq, dk, dv_, di, df, ws)
    ptrs = tuple(t.data_ptr() for t in tensors)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_cores:
            plans = tuple(tensor_map_plan(t, BLOCK, whole_boxes=False) for t in (q, k, v, dh))
            err = lib.mlstm_chunk_bwd_bf16(*ptrs, floats, B, S, H, dqk, dv, c,
                                           _packed(plans, ()), stream)
        else:
            err = lib.mlstm_chunk_bwd(_DTYPES[q.dtype], *ptrs, floats, B, S, H, dqk, dv, c,
                                      stream)
    _build.check(lib, err, "mlstm_chunk_backward")
    mlstm_chunk_backward.launches += 1
    return dq, dk, dv_, di, df


def _forward(q, k, v, i_log, f_log, chunk: int):
    if q.device.type == "cpu":
        return mlstm_chunk_reference(q, k, v, i_log, f_log, chunk=chunk, return_state=True)
    return _launch(q, k, v, i_log, f_log, chunk)


class MLSTMChunkFunction(torch.autograd.Function):
    """``mlstm_chunk`` with a gradient: the forward kernels (or plain
    version), then the backward kernels (or the plain formulas) for dq, dk,
    dv, di and df. Returns h and the final state, which is detached."""

    @staticmethod
    def forward(ctx, q, k, v, i_log, f_log, chunk: int):
        h, (C, n, m) = _forward(q, k, v, i_log, f_log, chunk)
        ctx.save_for_backward(q, k, v, i_log, f_log, h)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(C, n, m)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, *_):
        q, k, v, i_log, f_log, h = ctx.saved_tensors
        return (*mlstm_chunk_backward(q, k, v, i_log, f_log, h, dh, chunk=ctx.chunk), None)


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_log: torch.Tensor, f_log: torch.Tensor, *, chunk: int = 256,
                return_state: bool = False):
    """q,k: [B,S,H,dqk]; v: [B,S,H,dv]; i_log/f_log: [B,S,H] float32.

    Returns h [B,S,H,dv] in v's dtype and, with ``return_state``, the final
    float32 state ``(C [B,H,dqk,dv], n [B,H,dqk], m [B,H])`` (detached
    under autograd).
    """
    _check_inputs(q, k, v, i_log, f_log, chunk)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, i_log, f_log)):
        h, *state = MLSTMChunkFunction.apply(q, k, v, i_log, f_log, chunk)
        return (h, tuple(state)) if return_state else h
    if q.device.type == "cpu":
        return mlstm_chunk_reference(q, k, v, i_log, f_log, chunk=chunk,
                                     return_state=return_state)
    h, state = _launch(q, k, v, i_log, f_log, chunk)
    return (h, state) if return_state else h


mlstm_chunk.launches = 0
mlstm_chunk_backward.launches = 0
