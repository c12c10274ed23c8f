"""Production and local mesh builders (the port's counterpart of the JAX
package's `launch/mesh.py`).

The sharding rules (`sharding/rules.py`) read only each mesh axis's name
and size, so a production mesh is a description, `MeshShape`: 16 x 16
chips a pod over ("data", "model"), or 2 pods over ("pod", "data",
"model"). One card cannot hold a 256-rank ``DeviceMesh``; a local mesh
over the devices present is a real one. Nothing here runs when the module
is imported.
"""
from __future__ import annotations

import dataclasses

from repro_torch.device import resolve_device

__all__ = ["MeshShape", "make_production_mesh", "make_local_mesh",
           "mesh_axis_sizes"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""
    axis_names: tuple
    shape: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.shape}")


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips a pod; the multi-pod mesh adds a leading "pod"
    axis (2 pods = 512 chips)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(*, data: int = 1, model: int = 1, device="cuda"):
    """A (data, model) ``DeviceMesh`` over ``device``'s type (default the
    cards; raises on a host without one unless given ``device="cpu"``),
    one rank a device of the default process group (started here with
    world size 1 and an in-memory store when none is: NCCL on the cards,
    gloo on the CPU). Raises unless the world has exactly
    ``data * model`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = resolve_device(device).type
    if not dist.is_initialized():      # one process, an in-memory store
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the world has {n}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a `MeshShape` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))
