"""TMA tensor-map plans for the port's bf16 tensor-core kernels.

A plan describes the 4-D tensor map a kernel encodes over a bf16 tensor
``[B, S, heads, d]`` (``common/hopper.cuh``: ``encode_map``): its dims
innermost first, the byte strides of the outer three, and a box of ``rows``
rows by 64 columns, one 128-byte swizzle row. TMA takes only byte strides
that are positive multiples of 16 and a 16-byte aligned base; a layout it
cannot take raises ``ValueError`` here, before any launch. Plans are cached
per shape and strides; each call checks the base address.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

BOX_COLS = 64        # bf16 columns in one 128-byte swizzle row: a box's inner extent
PLAN_VALUES = 11     # int64 values of a plan (TMA_PLAN_VALUES in common/hopper.cuh)


class TensorMapPlan(NamedTuple):
    """A 4-D TMA tensor map over a ``[B, S, heads, d]`` bf16 tensor."""
    dims: Tuple[int, int, int, int]       # {d, heads, S, B}, innermost first
    strides: Tuple[int, int, int]         # bytes, of dims heads, S, B
    box: Tuple[int, int, int, int]        # {64, 1, rows, 1}

    def values(self) -> Tuple[int, ...]:
        """The 11 int64 values a kernel's entry point reads."""
        return self.dims + self.strides + self.box


@functools.lru_cache(maxsize=256)
def _plan(shape: Tuple[int, ...], stride: Tuple[int, ...], dtype: torch.dtype,
          rows: int, whole_boxes: bool) -> TensorMapPlan:
    if len(shape) != 4:
        raise ValueError(f"expected [B, S, heads, hd], got {shape}")
    if dtype != torch.bfloat16:
        raise ValueError(f"the TMA path takes bfloat16, got {dtype}")
    B, S, heads, hd = shape
    if whole_boxes and hd % BOX_COLS:
        raise ValueError(f"head_dim {hd} is not a multiple of {BOX_COLS}")
    if not 0 < rows <= 256:
        raise ValueError(f"box rows {rows} outside 1..256")
    if stride[3] != 1:
        raise ValueError(f"TMA needs a contiguous head dim, got stride {stride[3]}")
    size = dtype.itemsize
    strides, prev = [], hd * size            # bytes spanned by the inner dims
    for name, n, st in (("head", heads, stride[2]), ("seq", S, stride[1]),
                        ("batch", B, stride[0])):
        nbytes = st * size if n > 1 else prev
        if nbytes % 16 or not 0 < nbytes < 2 ** 40:
            raise ValueError(f"TMA needs byte strides that are positive multiples "
                             f"of 16, got {nbytes} for the {name} dim")
        strides.append(nbytes)
        prev = nbytes * n
    return TensorMapPlan((hd, heads, S, B), tuple(strides), (BOX_COLS, 1, rows, 1))


def tensor_map_plan(t: torch.Tensor, rows: int, *,
                    whole_boxes: bool = True) -> TensorMapPlan:
    """The tensor map a bf16 kernel builds over ``t`` [B, S, heads, d],
    loading boxes of ``rows`` rows by 64 columns. With ``whole_boxes`` the
    last dim must be a multiple of 64; without, the last box of a row is cut
    by the dim and TMA fills the rest with zeros. Raises ``ValueError`` where
    TMA cannot take the layout. A dim of size 1 gets its contiguous stride:
    its coordinate is always 0."""
    plan = _plan(tuple(t.shape), t.stride(), t.dtype, rows, whole_boxes)
    if t.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base, got address "
                         f"{t.data_ptr():#x}")
    return plan
