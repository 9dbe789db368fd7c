"""Decode attention wrapper: plain version on the CPU, CUDA kernel on the card.

``decode_attention`` takes the model cache layout as
``repro.kernels.decode_attention.ops`` does: q ``[B, H, hd]``, cache k/v
``[B, L, K, hd]``, ``slot_pos [L]`` int32 (-1 = empty) and ``cur_pos``. A CPU
tensor goes to the plain version (``ref.py``); a CUDA tensor launches
``csrc/decode_attention.cu``, which reads the cache in place, or raises. The
kernel takes head_dim 16, 64, 128 or 256 and a group ``H // K`` of at most 16
(in head blocks of at most 8 heads), and splits the L slots of each (batch,
kv head) over the blocks of a thread-block cluster as ``split_plan`` says.
``decode_attention.launches`` counts kernel launches. A ``meta`` tensor
(the dry run's) gets an output of the kernel's shape and launches nothing;
on ``meta`` and on the card each call reports its work (``cost.kernels``:
every slot of the cache is read) to an active cost counter.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.cost import analysis, kernels as work
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 256)
MAX_GROUP = 16
MAX_BLOCK_HEADS = 8    # query heads a block of the kernel holds
MAX_SPLITS = 8         # blocks of a cluster: the portable size
TARGET_BLOCKS = 128    # one wave of blocks on the card's 132 SMs


class SplitPlan(NamedTuple):
    """How the kernel covers a call: ``head_blocks`` clusters for the group
    of each (batch, kv head), each of ``splits`` blocks that take ``slots``
    consecutive slots (the last ones may take fewer, or none)."""
    head_blocks: int
    splits: int
    slots: int

    def blocks(self, B: int, K: int) -> int:
        return B * K * self.head_blocks * self.splits


@functools.lru_cache(maxsize=256)
def split_plan(B: int, K: int, G: int, L: int, hd: int) -> SplitPlan:
    """The split of a call: the fewest head blocks of at most
    ``MAX_BLOCK_HEADS`` heads that hold the group, and the fewest splits (a
    power of two, at most ``MAX_SPLITS``) that give at least
    ``TARGET_BLOCKS`` blocks; where that is not enough for half of them, the
    group is split into more head blocks, each of which reads the cache again
    (mostly from L2). At recurrentgemma-2b's decode shape 2 head blocks x 8
    splits ran faster on an H100 than one cluster of 16 blocks (PERF.md §6).
    ``hd`` is checked, not used: every head dim takes the same rule."""
    if min(B, K, G, L) < 1 or G > MAX_GROUP or hd not in HEAD_DIMS:
        raise ValueError(f"no split plan for B {B}, K {K}, G {G}, L {L}, hd {hd}")
    splits = 1
    while splits < MAX_SPLITS and B * K * splits < TARGET_BLOCKS:
        splits *= 2
    head_blocks = -(-G // MAX_BLOCK_HEADS)
    while head_blocks < G and B * K * head_blocks * splits < TARGET_BLOCKS // 2:
        head_blocks += 1
    head_blocks = -(-G // -(-G // head_blocks))          # no empty head block
    return SplitPlan(head_blocks, splits, -(-L // splits))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the kernel's C entry point on a loaded library."""
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.decode_attention_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [i64p]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.decode_attention_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("decode_attention"))


def _check_inputs(q, cache_k, cache_v, slot_pos):
    if q.dim() != 3 or cache_k.dim() != 4:
        raise ValueError("decode_attention expects q [B,H,hd], cache [B,L,K,hd]")
    B, H, hd = q.shape
    if (cache_k.shape != cache_v.shape or cache_k.shape[0] != B
            or cache_k.shape[3] != hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(cache_k.shape)}, v {tuple(cache_v.shape)}")
    if H % cache_k.shape[2]:
        raise ValueError(f"query heads {H} not a multiple of kv heads "
                         f"{cache_k.shape[2]}")
    if slot_pos.shape != (cache_k.shape[1],):
        raise ValueError(f"slot_pos must be [L], got {tuple(slot_pos.shape)}")
    if not (q.device == cache_k.device == cache_v.device == slot_pos.device):
        raise ValueError("q, cache and slot_pos must be on one device")
    if not (q.dtype == cache_k.dtype == cache_v.dtype):
        raise ValueError("q and the cache must have one dtype")


@functools.lru_cache(maxsize=256)
def _strides(q, k, v, out) -> ctypes.Array:
    return _build.int64_array(q[:2] + k[:3] + v[:3] + out[:2])


def _check_kernel_inputs(q, cache_k, slot_pos) -> None:
    """What the kernel takes, whatever the device."""
    B, H, hd = q.shape
    K = cache_k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention kernel takes float32/bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim {HEAD_DIMS}, got {hd}")
    if H // K > MAX_GROUP:
        raise ValueError(f"group size {H // K} exceeds {MAX_GROUP}")
    if slot_pos.dtype != torch.int32 or not slot_pos.is_contiguous():
        raise ValueError("slot_pos must be a contiguous int32 tensor")


def _report(q, cache_k) -> None:
    if analysis.counting():
        B, H, hd = q.shape
        analysis.report_kernel("decode_attention", *work.decode(
            B, H, cache_k.shape[2], cache_k.shape[1], hd, q.element_size()))


def _launch(q, cache_k, cache_v, slot_pos, cur_pos: int, window: int,
            plan: Optional[SplitPlan] = None,
            lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch the kernel for CUDA tensors, with ``split_plan``'s split unless
    another plan is given, from the built library unless another (bound by
    ``_bind``) is given."""
    B, H, hd = q.shape
    L, K = cache_k.shape[1], cache_k.shape[2]
    _check_kernel_inputs(q, cache_k, slot_pos)
    if any(t.stride(-1) != 1 for t in (q, cache_k, cache_v)):
        raise ValueError("decode_attention kernel needs a contiguous head dim")
    size = q.element_size()
    for t in (q, cache_k, cache_v):
        if t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:-1]):
            raise ValueError("decode_attention kernel needs 16-byte aligned q and cache rows")
    plan = plan or split_plan(B, K, H // K, L, hd)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    lib = lib or _lib()
    strides = _strides(q.stride(), cache_k.stride(), cache_v.stride(), out.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), cache_k.data_ptr(),
            cache_v.data_ptr(), slot_pos.data_ptr(), out.data_ptr(),
            B, L, H, K, hd, strides, cur_pos, int(window),
            1.0 / math.sqrt(hd), *plan, stream)
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    _report(q, cache_k)
    return out


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, slot_pos: torch.Tensor,
                     cur_pos: int, *, window: int = 0) -> torch.Tensor:
    """Returns [B, H, hd] in q's dtype. ``cur_pos`` is a Python int."""
    _check_inputs(q, cache_k, cache_v, slot_pos)
    cur_pos = int(cur_pos)
    if q.device.type == "cpu":
        return decode_attention_reference(q, cache_k, cache_v, slot_pos,
                                          cur_pos, window=window)
    if q.device.type == "meta":
        _check_kernel_inputs(q, cache_k, slot_pos)
        _report(q, cache_k)
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, cache_k, cache_v, slot_pos, cur_pos, window)


decode_attention.launches = 0
