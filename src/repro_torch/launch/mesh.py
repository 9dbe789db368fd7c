"""Device meshes (counterpart of ``repro.launch.mesh``).

A ``Mesh`` is a device array with named axes, as JAX's: ``devices`` (an
object array of ``torch.device`` of the mesh's shape), ``axis_names`` and
``shape`` (axis name -> extent, in axis order). The port passes its mesh
explicitly, so JAX's ``set_mesh`` has no counterpart. In a process of a
``torch.distributed`` world of more than one rank, ``make_mesh`` also builds
a ``DeviceMesh`` over the world (rank r on the r-th device, row-major), and
``group(axis)`` is the process group of that axis that the collectives use.
``HW``, the JAX module's table of TPU figures, waits for the cost tooling
(ROADMAP.md, queue 1 item 7), which gives the port an H100 entry.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass
class Mesh:
    devices: np.ndarray                  # torch.device, of the mesh's shape
    axis_names: Tuple[str, ...]
    device_mesh: Optional[Any] = None    # torch.distributed DeviceMesh, in a rank

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        """The process group of ``axis`` in this rank's world, or ``None``
        outside one (world size 1: no collective is issued)."""
        return None if self.device_mesh is None else self.device_mesh[axis].get_group()


def visible_cards() -> list:
    """Every CUDA device of this host; raises without one (``resolve_device``)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) of ``devices`` (every
    card of this host by default). Raises ``RuntimeError`` where there are
    fewer devices, and ``ValueError`` where the list names one CUDA device
    twice or mixes the CPU with cards (the CPU may be named any number of
    times: one process each)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if devices is None:
        devices = visible_cards()
    named = [torch.device(d) for d in devices]
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
        from torch.distributed.device_mesh import init_device_mesh
        mesh.device_mesh = init_device_mesh(devices[0].type, shape, mesh_dim_names=axes)
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """16x16 = 256 devices; multi_pod adds a 2-pod outer axis (512). Raises
    ``RuntimeError`` on a host with fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)
