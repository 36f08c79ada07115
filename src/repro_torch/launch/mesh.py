"""Production meshes, the counterpart of the JAX package's
``launch/mesh.py``.

A ``Mesh`` is a value: a shape and axis names, with no device or
process-group state, so importing this module (or building a mesh) touches
no device.  ``device_mesh`` turns one into a
``torch.distributed.device_mesh.DeviceMesh`` once a process group of the
mesh's world size is up (gloo ranks on the CPU, NCCL on the card, or the
dry run's fake group).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_test_mesh(n_devices: int = 8, model_par: int = 2) -> Mesh:
    """Small mesh for the distributed tests."""
    return Mesh((n_devices // model_par, model_par), ("data", "model"))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def n_devices(mesh) -> int:
    return math.prod(mesh.shape)


def device_mesh(mesh: Mesh, device_type: str):
    """The ``DeviceMesh`` of ``mesh`` over the current process group, whose
    world size must be the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized() or dist.get_world_size() != n_devices(mesh):
        raise RuntimeError(f"device_mesh: a process group of {n_devices(mesh)} ranks must be "
                           f"up for the mesh {mesh.shape}")
    return init_device_mesh(device_type, mesh.shape, mesh_dim_names=mesh.axis_names)
