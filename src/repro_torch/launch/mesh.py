"""Production meshes (``repro.launch.mesh``) as ``ProcessMesh``es.

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model"); the
"pod" axis carries only the vote (DESIGN.md §2).

A function, not a module-level constant: importing this module touches no
process group. Every rank of an initialised world of at least that many
ranks builds it (``torch.distributed.new_group`` is collective).
"""
from __future__ import annotations

from typing import Dict

import torch.distributed as dist

from repro_torch.distributed.mesh import ProcessMesh


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The (16, 16) mesh of 256 ranks, or (2, 16, 16) of 512; raises
    ``ValueError`` naming the size on a smaller world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the world has {world}")
    return ProcessMesh(shape, axes)


def mesh_axis_sizes(mesh: ProcessMesh) -> Dict[str, int]:
    """{axis: size} of the mesh's axes (the reference's
    ``dict(zip(mesh.axis_names, mesh.devices.shape))``)."""
    return mesh.axis_sizes


def pod_stride(mesh: ProcessMesh) -> int:
    """Rank stride between pods (the reference's device-id stride, for
    attributing collectives to groups)."""
    sizes = mesh_axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("model", 1)


__all__ = ["make_production_mesh", "mesh_axis_sizes", "pod_stride"]
