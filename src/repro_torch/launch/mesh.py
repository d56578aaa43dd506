"""Meshes of ranks, after ``repro/launch/mesh.py``: the host mesh over
the default process group, and the reference's production meshes as
descriptions (:class:`repro_torch.core.mesh.Mesh`).

:func:`make_production_mesh` only describes ``(16, 16)`` and ``(2, 16,
16)``: the sharding rules read their axis sizes without 256 ranks, and
running on one raises.
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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as a description: ``(16, 16)`` on
    ``("data", "model")``, or ``(2, 16, 16)`` on ``("pod", "data",
    "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, dict(zip(axes, shape)))
