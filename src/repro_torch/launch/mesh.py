"""Device meshes over ``torch.distributed`` — the JAX package's
``launch/mesh.py``. Importing this module touches no process group; the
caller starts one rank per device and initialises the default group
first."""

from __future__ import annotations

import math

from ..models.schema import mesh_axes


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group's
    ranks (row-major, as ``jax.make_mesh`` lays devices out)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks ("data", "model"); 2 pods = 512 ranks ("pod",
    "data", "model"). Raises ``ValueError`` unless the default group has
    exactly that many ranks."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = (dist.get_world_size() if dist.is_available()
             and dist.is_initialized() else 0)
    need = math.prod(shape)
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the process group has {world or 'none'}")
    return make_mesh(shape, axes)


def data_axes(mesh) -> tuple:
    """Axes carrying the batch dimension (the DP domain)."""
    return tuple(a for a in mesh_axes(mesh).axis_names if a in ("pod", "data"))


def model_axes(mesh) -> tuple:
    return tuple(a for a in mesh_axes(mesh).axis_names if a == "model")
