"""A mesh of ranks: named axes over the default ``torch.distributed``
process group, row-major as ``jax.make_mesh`` lays out devices (rank
``i`` of a ``(data, model)`` mesh sits at ``(i // model, i % model)``).
Each axis of more than one rank carries the process group of the ranks
that share this rank's other coordinates; the tensor-parallel layers
gather over the ``model`` axis's group. A mesh built without
coordinates is only a description: its axis sizes can be read, and
running on it raises. :mod:`repro_torch.launch.mesh` builds both kinds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from .group import _rank, _world_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; for a mesh of this process's group also its
    coordinates and each axis's process group (None for an axis of one
    rank, or for a mesh that is only a description)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Optional[Dict[str, int]] = None
    groups: Optional[Dict[str, Any]] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``; raises on a description."""
        self._runnable()
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of ``axis`` (None: an axis of one rank, whose
        collectives are the identity); raises on a description."""
        self._runnable()
        return self.groups[axis]

    def _runnable(self) -> None:
        if self.coords is None:
            raise RuntimeError(
                f"mesh {self.shape} is a description: running on it needs "
                f"{self.size} ranks, and this process group has "
                f"{_world_size()}")


def axis_groups(shape: Tuple[int, ...], axes: Tuple[str, ...]
                 ) -> Dict[str, Any]:
    """For each axis, this rank's group of the ranks that differ only
    along it. Every rank creates every group, in the same order, as
    ``dist.new_group`` requires."""
    world, rank = math.prod(shape), _rank()
    out: Dict[str, Any] = {}
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            out[axis] = None
            continue
        if shape[i] == world:
            out[axis] = dist.group.WORLD
            continue
        stride = math.prod(shape[i + 1:])
        for base in range(world):
            if (base // stride) % shape[i]:
                continue                    # not the line's first rank
            members = [base + k * stride for k in range(shape[i])]
            g = dist.new_group(members)
            if rank in members:
                out[axis] = g
    return out
