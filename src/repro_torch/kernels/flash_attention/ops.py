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

Training: where autograd records (grad mode on and an input that requires
grad), ``flash_attention`` runs through ``FlashAttentionFunction``. Its
forward launches the same kernels with the per-row log-sum-exp written
beside the output (``[B, H, S]`` float32; serving passes a null pointer and
nothing else changes), and its backward calls ``flash_attention_backward``:
on the card ``csrc/flash_attention_bwd.cu``, on the CPU the explicit
formulas of ``ref.py``, so the CPU tests check what the kernels compute.
``backward_instance`` names the family a CUDA call takes, as the forward
chooses:

* bfloat16 at head_dim 64, 128 or 256: the tensor-core kernels (``wgmma``,
  every tile fed by TMA). A dQ kernel (one 64-row query tile a block), a
  dK/dV kernel (one 64-key tile of one query head a block, its float32
  partials in scratch ``[2, B, S, H, hd]``), then a kernel that sums each
  group's partials in head order. Their four tensor maps (q, k, v, dO;
  64-row boxes) are planned by ``backward_kernel_args``, which raises
  ``ValueError`` on a layout TMA cannot take before anything launches.
* float32, and bfloat16 at head_dim 16: the CUDA-core kernels (a dQ kernel,
  then a dK/dV kernel that sums each group's query heads in order).

No atomics in either: two calls give the same bits.

A ``meta`` tensor (the dry run's) takes the CUDA path up to the launch: it
gets outputs of the kernels' shapes and the scratch the CUDA path
allocates, and launches nothing. On ``meta`` and on the card each call
reports its work (``cost.kernels``) to an active cost counter
(``cost.analysis``).

``flash_attention.launches`` counts forward kernel launches and
``flash_attention_backward.launches`` backward calls that launched their
kernels (one a call, however many kernels it launches).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.cost import analysis, kernels as work
from repro_torch.kernels import _build
from repro_torch.kernels._tma import BOX_COLS, TensorMapPlan, tensor_map_plan  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_reference, flash_attention_reference)

HEAD_DIMS = (16, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)   # bf16 head dims of the tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 64         # query rows a block: wgmma's M (BM in the source)
BLOCK_K = 64         # keys a K/V tile (BK in the source)
BWD_BLOCK = 64       # rows a backward block owns and a streamed tile holds (TC_BM, TC_BN)
BWD_CC_ROWS = (32, 16)   # CUDA-core backward: query rows a dQ block, keys a dK/dV block
BWD_REDUCE_THREADS = 256  # threads a block of the partials' sum, 4 columns each
# A tensor-core backward tile in which some P >= SPLIT_P also multiplies the
# lo part (x - bf16(x)) of its bf16 operands P and dS: rows that see few keys
# have large terms, which one bf16 rounding would leave outside the gradient
# tolerance (csrc/flash_attention_bwd.cu; split_sweep.py measures the trade)
SPLIT_P = 1.0 / 64


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
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [i64p] * 4
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd_bf16.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [i64p]
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.flash_attention_fwd_cc, lib.flash_attention_fwd_bf16):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd_cc.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd_bf16.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.flash_attention_bwd_cc, lib.flash_attention_bwd_bf16):
        fn.restype = ctypes.c_int
    return lib


def backward_instance(dtype: torch.dtype, hd: int) -> str:
    """The backward family a CUDA call launches: ``"tc"`` (the tensor-core
    kernels) for bfloat16 at ``TC_HEAD_DIMS``, else ``"cc"`` (CUDA cores)."""
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "cc"


def backward_kernel_args(q, k, v, do) -> ctypes.Array:
    """The tensor-core backward's ``plans``: the tensor maps of q, k, v and
    dO, each with ``BWD_BLOCK``-row boxes. Cached per layout; each call
    checks the four base addresses (``ValueError`` where TMA cannot take a
    layout)."""
    return _packed(tuple(tensor_map_plan(t, BWD_BLOCK) for t in (q, k, v, do)), ())


def backward_grids(dtype: torch.dtype, B: int, S: int, H: int, K: int,
                   hd: int) -> dict:
    """Kernel name -> blocks of its grid, for one backward call."""
    if backward_instance(dtype, hd) == "tc":
        tiles = -(-S // BWD_BLOCK) * B * H
        return {"flash_bwd_tc_dq": tiles, "flash_bwd_tc_dkdv": tiles,
                "flash_bwd_reduce": -(-(B * S * K * hd // 4) // BWD_REDUCE_THREADS)}
    dq_rows, kv_rows = BWD_CC_ROWS
    return {"flash_bwd_dq": -(-S // dq_rows) * B * H, "flash_bwd_dkdv": -(-S // kv_rows) * B * K}


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


def _check_kernel_inputs(q, what: str) -> None:
    """What the forward and backward kernels take: a head dim of
    ``HEAD_DIMS``, float32 or bfloat16, and B*H within the grid's y limit."""
    B, _, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim {HEAD_DIMS}, got {hd}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what} kernel takes float32/bfloat16, got {q.dtype}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit 65535")


def _launch(q, k, v, *, causal: bool, window: int, lse: bool = False):
    """Launch the kernel for CUDA tensors; with ``lse`` also return the
    float32 log-sum-exp [B, H, S] that the kernel writes beside the output."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    _check_kernel_inputs(q, "flash_attention")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse_out = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
               if lse else None)
    if analysis.counting():
        analysis.report_kernel("flash_attention", *work.flash_forward(
            B, S, H, K, hd, window, q.element_size(), lse))
    if q.device.type == "meta":
        return (out, lse_out) if lse else out
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
                                  out.data_ptr(),
                                  None if lse_out is None else lse_out.data_ptr(),
                                  B, S, H, K, hd, *args, stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse_out) if lse else out


def _forward_with_lse(q, k, v, causal: bool, window: int):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         return_lse=True)
    return _launch(q, k, v, causal=causal, window=window, lse=True)


def flash_attention_backward(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0):
    """dq, dk, dv of ``flash_attention`` (in q's, k's and v's dtype) from
    its inputs, its output ``o``, the output's gradient ``do`` [B, S, H, hd]
    and the forward's log-sum-exp ``lse`` [B, H, S] float32. The plain
    formulas on the CPU; on the card the backward kernels or an error."""
    _check_inputs(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (
            q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"o and do must be {tuple(q.shape)}, lse [B,H,S]; got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"o and do must be {q.dtype}, lse float32; got {o.dtype}, "
                         f"{do.dtype}, {lse.dtype}")
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, do, lse,
                                                  causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    return _launch_backward(q, k, v, o, do, lse, causal=causal, window=window)


def _launch_backward(q, k, v, o, do, lse, *, causal: bool, window: int,
                     split_p: float = SPLIT_P):
    """Launch the backward kernels for CUDA tensors that passed
    ``flash_attention_backward``'s checks; ``split_p`` is the tensor-core
    kernels' threshold (``split_sweep.py`` passes others)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    _check_kernel_inputs(q, "flash_attention backward")
    # the kernels take contiguous [B, S, heads, hd] rows (a copy only where
    # autograd hands over another layout)
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    f32 = dict(dtype=torch.float32, device=q.device)
    shape = (B, S, H, K, hd)
    flags = (int(causal), int(window), 1.0 / math.sqrt(hd))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if analysis.counting():
        analysis.report_kernel("flash_attention_backward", *work.flash_backward(
            B, S, H, K, hd, window, q.element_size()))
    if backward_instance(q.dtype, hd) == "tc":
        rows = torch.empty((2, B * H, -(-S // BWD_BLOCK) * BWD_BLOCK), **f32)
        part = torch.empty((2, B, S, H, hd), **f32)
        if q.device.type == "meta":
            return dq, dk, dv
        plans = backward_kernel_args(q, k, v, do)
        if o.data_ptr() % 16:
            raise ValueError(f"the backward reads o in 16-byte chunks; its base "
                             f"{o.data_ptr():#x} is not 16-byte aligned")
        tensors = (q, k, v, o, do, lse, dq, dk, dv, rows, part)
        entry, args = "flash_attention_bwd_bf16", (
            *(t.data_ptr() for t in tensors), *shape, plans, *flags, float(split_p))
    else:
        delta = torch.empty((B, H, S), **f32)
        if q.device.type == "meta":
            return dq, dk, dv
        tensors = (q, k, v, o, do, lse, dq, dk, dv, delta)
        entry, args = "flash_attention_bwd_cc", (
            _DTYPES[q.dtype], *(t.data_ptr() for t in tensors), *shape, *flags)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward kernel (or plain
    version) with its log-sum-exp, the backward kernels (or the plain
    formulas) for dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _forward_with_lse(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do, lse,
                                              causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k/v: [B, S, K, hd]. Returns [B, S, H, hd] in q's dtype."""
    _check_inputs(q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
flash_attention_backward.launches = 0
