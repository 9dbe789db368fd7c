"""Device meshes (counterpart of ``repro.launch.mesh``).

A ``Mesh`` is a device array with named axes, as JAX's: ``devices`` (an
object array of ``torch.device`` of the mesh's shape), ``axis_names`` and
``shape`` (axis name -> extent, in axis order). The port passes its mesh
explicitly, so JAX's ``set_mesh`` has no counterpart. In a process of a
``torch.distributed`` world of more than one rank, ``make_mesh`` lays rank r
on the r-th device in row-major order, as ``jax.sharding.Mesh`` lays out
``devices.reshape(shape)``: on a (data, model) mesh rank r = d · model + m.
It gives the rank its coordinates (``coords``) and, for each axis, the
process group of the ranks that differ from it along that axis alone
(``group(axis)``, a ``dist.new_group``): the model group holds the ranks of
the rank's data index, the data group those of its model index.

A mesh of N ``meta`` devices is abstract: no world, no card. It stands for
rank 0 of an N-rank world, and its groups are
``collectives.AbstractGroup``s of the axes' extents, over which the
collectives send nothing (``launch.dryrun`` traces a rank's step on it).

``HW`` is the card the cost tooling scores against (``cost.roofline``) and
``chip_smoke.py``'s kernel bounds divide by: an H100 SXM5 80GB at its
700 W limit, by NVIDIA's data sheet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


# NVIDIA H100 SXM5 80GB at 700 W: data-sheet figures (dense, no sparsity),
# not measurements. ``ici_bw`` keeps the JAX table's key for the link rate:
# here NVLink 4, each direction.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s, bf16 tensor cores
    "peak_flops_fp32": 67e12,    # FLOP/s, float32 CUDA cores
    "hbm_bw": 3.35e12,           # B/s
    "ici_bw": 450e9,             # B/s, NVLink, each direction
    "hbm_bytes": 80e9,           # capacity
}


@dataclass
class Mesh:
    devices: np.ndarray                  # torch.device, of the mesh's shape
    axis_names: Tuple[str, ...]
    rank: Optional[int] = None           # this process's rank, in a world of N
    groups: Dict[str, Any] = field(default_factory=dict)   # axis -> process group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> index of ``rank`` (this process's by default; 0
        outside a world) on the mesh, row-major."""
        rank = (self.rank or 0) if rank is None else rank
        index = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, index)}

    @property
    def abstract(self) -> bool:
        """A mesh of meta devices (``make_mesh``): no world behind it."""
        return self.devices.flat[0].type == "meta"

    def group(self, axis):
        """The process group of ``axis`` in this rank's world, or ``None``
        outside one (world size 1: no collective is issued). ``axis`` may
        be a tuple of names (a spec's combined axes): on an abstract mesh
        the group of their product; in a world, the group of the one axis
        among them longer than 1, or the whole world where they cover every
        such axis."""
        names = axis if isinstance(axis, tuple) else (axis,)
        if len(names) == 1:
            return self.groups.get(names[0])
        if self.abstract:
            from repro_torch.sharding.collectives import AbstractGroup
            from repro_torch.sharding.partitioning import _block
            return AbstractGroup(*_block(names, self.coords(), self.shape))
        long = [a for a in self.axis_names if self.shape[a] > 1]
        if not self.groups or not long:
            return None
        inside = [a for a in names if self.shape[a] > 1]
        if set(long) <= set(names):
            import torch.distributed as dist
            return dist.group.WORLD
        if len(inside) == 1:
            return self.groups.get(inside[0])
        raise NotImplementedError(f"no process group over {names} of a {self.shape} mesh")


def visible_cards() -> list:
    """Every CUDA device of this host; raises without one (``resolve_device``)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) of ``devices`` (every
    card of this host by default). Raises ``RuntimeError`` where there are
    fewer devices, and ``ValueError`` where the list names one CUDA device
    twice or mixes device types (the CPU and ``meta`` may be named any
    number of times: one process each). Over ``meta`` devices the mesh is
    abstract and stands for rank 0."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if devices is None:
        devices = visible_cards()
    named = [torch.device(d) for d in devices]
    if named and all(d.type == "meta" for d in named):
        return _abstract_mesh(shape, axes, len(named))
    cards = [torch.device("cuda", d.index or 0) for d in named if d.type == "cuda"]
    if len(set(cards)) != len(cards):
        raise ValueError(f"a CUDA device is named twice in {[str(d) for d in named]}")
    n = math.prod(shape)
    if len({d.type for d in named[:n]}) > 1:
        raise ValueError(f"a mesh of one device type; got {[str(d) for d in named[:n]]}")
    if len(named) < n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} devices; "
                           f"{len(named)} given")
    devices = [resolve_device(d) for d in named]
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    mesh = Mesh(arr.reshape(shape), axes)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_world_size() != n:
            raise ValueError(f"world of {dist.get_world_size()} ranks for a mesh of {n}")
        mesh.rank = dist.get_rank()
        mesh.groups = _axis_groups(shape, axes, mesh.rank)
    return mesh


def _abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], given: int) -> Mesh:
    from repro_torch.sharding.collectives import AbstractGroup
    n = math.prod(shape)
    if given < n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} devices; "
                           f"{given} given")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device("meta")] * n
    mesh = Mesh(arr.reshape(shape), axes, 0)
    mesh.groups = {a: AbstractGroup(e, 0) for a, e in zip(axes, shape)}
    return mesh


def _axis_groups(shape: Tuple[int, ...], axes: Tuple[str, ...], rank: int) -> Dict[str, Any]:
    """For each axis, ``dist.new_group`` over every line of ranks along it
    (every rank creates every group, in one order); this rank's line's."""
    import torch.distributed as dist
    ranks = np.arange(math.prod(shape)).reshape(shape)
    out = {}
    for i, axis in enumerate(axes):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                out[axis] = group
    return out


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """16x16 = 256 devices; multi_pod adds a 2-pod outer axis (512). Raises
    ``RuntimeError`` on a host with fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)
