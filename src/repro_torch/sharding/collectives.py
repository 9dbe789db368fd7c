"""Every collective of the port, in one place.

The model's tensor and expert parallelism (``partitioning.ModelParallel``),
FSDP's weight gathers and the data-parallel step (``training.data_parallel``)
issue their collectives through these functions, so that a cost counter
(``cost.analysis``) sees each one: its kind, its payload and its group's
size, from which it counts the wire bytes a rank sends.

On a real process group they communicate as ``torch.distributed`` does.
An ``AbstractGroup`` (the group of an abstract mesh of ``meta`` devices,
``launch.mesh.make_mesh``) has no world behind it: the functions send
nothing and give outputs of the right shape, since a meta tensor has no
data to send. A real group always communicates.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.cost import analysis


class AbstractGroup(NamedTuple):
    """A group of ``size`` ranks of an abstract mesh, this rank ``rank``
    in it."""
    size: int
    rank: int


def size(group) -> int:
    """The ranks of ``group`` (``None``: the default world's, 1 outside one)."""
    if isinstance(group, AbstractGroup):
        return group.size
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _sends(group, *tensors: torch.Tensor) -> bool:
    if group is None and size(None) == 1:        # this process alone: nothing to send
        return False
    abstract = isinstance(group, AbstractGroup)
    meta = any(t.device.type == "meta" for t in tensors)
    if meta and not abstract:
        raise ValueError("meta tensors go over the group of an abstract mesh")
    if abstract and not meta:
        raise ValueError(f"{group} is abstract: it takes meta tensors")
    return not abstract


def _count(kind: str, payload: torch.Tensor, group) -> None:
    analysis.report_collective(kind, payload.numel() * payload.element_size(), size(group))


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over ``group``; returns ``x``."""
    _count("all-reduce", x, group)
    if _sends(group, x):
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """``out`` [n · X0, ...] <- every rank's x [X0, ...], stacked by rank
    along dim 0."""
    _count("all-gather", out, group)
    if _sends(group, out, x):
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_gather_list(parts: List[torch.Tensor], x: torch.Tensor, group) -> List[torch.Tensor]:
    """``parts[r]`` <- rank r's x (``dist.all_gather``)."""
    n = size(group)
    analysis.report_collective("all-gather", n * x.numel() * x.element_size(), n)
    if _sends(group, x):
        dist.all_gather(parts, x, group=group)
    return parts


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """``out`` [X0 / n, ...] <- this rank's block along dim 0 of the sum of
    every rank's x."""
    _count("reduce-scatter", x, group)
    if _sends(group, out, x):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_to_all_into(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """Block j of x along dim 0 to rank j; ``out``'s block i from rank i."""
    _count("all-to-all", x, group)
    if _sends(group, out, x):
        dist.all_to_all_single(out, x, group=group)
    return out
