"""Device meshes over the ranks of a process group (counterpart of
``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` over the devices it sees; the
port builds a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, which the caller initialises (address, world
size, rank and backend, given explicitly: nothing here guesses them).

Production meshes: single pod 16x16 = 256 devices, axes (data, model);
multi-pod 2x16x16 = 512, axes (pod, data, model) — the pod axis is pure
data parallelism across pods, FSDP within a pod over 'data', tensor and
expert parallelism over 'model'.  :func:`fake_world` opens a process group
of that many ranks on the ``fake`` backend, in which one process builds
them: the dry run's counterpart of the reference's 512 fake XLA devices.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

# name -> (shape, axis names) of each production mesh
PRODUCTION_MESHES = {"pod16x16": ((16, 16), ("data", "model")),
                     "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


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


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the (2,
    16, 16) ("pod", "data", "model") one, over the default group (of 256 or
    512 ranks: :func:`fake_world` in one process)."""
    name = "pod2x16x16" if multi_pod else "pod16x16"
    shape, axes = PRODUCTION_MESHES[name]
    return compat_make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks on the ``fake`` backend
    (``FakeStore``: collectives do nothing), this process rank 0; destroyed
    on exit, also on an error.  Raises if a group is already initialised:
    the default group is global to the process, and one left behind would
    change what ``steps.build_cell`` does later in it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_host_mesh(model_axis: int = 1, device_type: str = "cpu"):
    """A (data, model) mesh over every rank of the default group (tests and
    smoke runs)."""
    _require_group()
    n = dist.get_world_size()
    data = max(1, n // model_axis)
    return compat_make_mesh((data, model_axis), ("data", "model"),
                            device_type)


def dp_axes(mesh) -> tuple:
    """Axes that shard the batch dimension (of a mesh, or of a tuple of
    axis names)."""
    names = getattr(mesh, "mesh_dim_names", mesh)
    return ("pod", "data") if "pod" in names else ("data",)


def dp_size(sizes: dict) -> int:
    """Devices along the data-parallel axes of a mesh whose axis sizes are
    ``sizes`` (name -> size); 1 for no mesh (``{}``)."""
    return math.prod(sizes.get(a, 1) for a in dp_axes(tuple(sizes)))
