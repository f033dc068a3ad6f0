"""Device meshes over the ranks of a process group (counterpart of
``repro.launch.mesh``, as far as the partitioned GNN cell needs it).

The reference builds a ``jax.sharding.Mesh`` over the devices it sees; the
port builds a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, which the caller initialises (address, world
size, rank and backend, given explicitly: nothing here guesses them).  The
production meshes of 256 and 512 devices (``make_production_mesh``) belong
to the dry run and are not ported yet.
"""
from __future__ import annotations

import torch.distributed as dist


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "(or launch.gnn_partitioned.init_rank) first")


def compat_make_mesh(shape, axes, device_type: str = "cpu"):
    """A DeviceMesh of ``shape`` named ``axes`` over the default group's
    ranks (row-major), as ``jax.make_mesh(shape, axes)`` lays devices out;
    the product of ``shape`` must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(model_axis: int = 1, device_type: str = "cpu"):
    """A (data, model) mesh over every rank of the default group (tests and
    smoke runs)."""
    _require_group()
    n = dist.get_world_size()
    data = max(1, n // model_axis)
    return compat_make_mesh((data, model_axis), ("data", "model"),
                            device_type)


def dp_axes(mesh) -> tuple:
    """Axes that shard the batch dimension."""
    return (("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",))
