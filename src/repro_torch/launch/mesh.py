"""Device meshes for the PyTorch port, and the H100's roofline constants.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group that is already set up (one process per rank: ``torchrun``, or
spawned ranks in the tests).  The sharding rules
(``launch/sharding.py``) read only axis names and sizes, so they also take
a shape-only ``MeshShape``; ``mesh_shape`` turns a ``DeviceMesh`` into
one.  Nothing here touches a process group when the module is imported.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's data sheet, dense
# rates without sparsity), per card.
PEAK_FLOPS_BF16 = 989e12     # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4 bytes/s per direction (900 GB/s
#                              both directions together)


class MeshShape:
    """Shape-only view of a mesh: ``shape`` maps each axis name to its
    size, ``axis_names`` keeps the mesh's order (major to minor)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def mesh_shape(mesh) -> MeshShape:
    """A ``MeshShape`` of ``mesh``: a ``DeviceMesh`` (its dim names and
    sizes) or anything with a ``shape`` dict and ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshShape(dict(zip(names, mesh.mesh.shape)))
    return MeshShape({a: mesh.shape[a] for a in mesh.axis_names})


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 (256 ranks) or 2x16x16 (512 ranks): the dry-run's meshes,
    which need a fake process group of that size."""
    raise NotImplementedError(
        "make_production_mesh comes with the analysis slice of the PyTorch "
        "port (the dry-run over a fake process group)")


def make_debug_mesh(shape: Sequence[int] = (2, 2),
                    axes: Sequence[str] = ("data", "model"),
                    device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, whose world size must be the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def data_axes(mesh) -> tuple:
    """The axes a global batch shards over."""
    return tuple(a for a in mesh_shape(mesh).axis_names
                 if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh_shape(mesh).shape.get("model", 1)


def num_chips(mesh) -> int:
    n = 1
    for v in mesh_shape(mesh).shape.values():
        n *= v
    return n
