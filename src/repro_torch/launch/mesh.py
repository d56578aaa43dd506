"""Meshes of ranks, after ``repro/launch/mesh.py``: the host mesh over
the default process group, and the reference's production meshes
(:class:`repro_torch.core.mesh.Mesh`).

:func:`make_production_mesh` gives ``(16, 16)`` over the default process
group when the group has its 256 ranks; otherwise, and for ``(2, 16,
16)``, it only describes the mesh: the sharding rules read its axis
sizes without the ranks, and running on it raises.
"""

from __future__ import annotations

from ..core.group import _rank, _world_size
from ..core.mesh import Mesh, axis_groups


def make_host_mesh(model: int = 1) -> Mesh:
    """The ranks of the default process group (one rank without a group)
    as a ``(world // model, model)`` mesh on axes ``("data", "model")``."""
    world = _world_size()
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide the "
                         f"{world} ranks")
    shape = (world // model, model)
    axes = ("data", "model")
    rank = _rank()
    return Mesh(axes, dict(zip(axes, shape)),
                coords={"data": rank // model, "model": rank % model},
                groups=axis_groups(shape, axes))


PRODUCTION = (16, 16)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: ``(16, 16)`` on ``("data",
    "model")``, or ``(2, 16, 16)`` on ``("pod", "data", "model")``. The
    ``(16, 16)`` mesh is the default process group's
    (:func:`make_host_mesh`: coordinates and axis groups) when the group
    has 256 ranks, else a description."""
    if not multi_pod and _world_size() == 16 * 16:
        return make_host_mesh(model=16)
    shape = (2, 16, 16) if multi_pod else PRODUCTION
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, dict(zip(axes, shape)))
