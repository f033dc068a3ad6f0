"""Axis-name sharding annotations that degrade to no-ops off-mesh
(counterpart of ``repro.dist.constrain``).

A model annotates an intermediate with logical axis names::

    x = constrain(x, "batch", None, "model")   # one name per tensor dim

``"batch"`` is a logical alias for the data-parallel axes of the active
mesh (``("pod", "data")`` when a pod axis exists, else ``("data",)``);
other names are physical mesh axes and are dropped when the mesh lacks
them.  With no active mesh, a mesh of one device, a name count that is not
the tensor's rank, or a plain tensor, ``constrain`` returns its input
unchanged, so the models stay runnable anywhere.  Given a
``torch.distributed.tensor.DTensor`` it redistributes it to the resolved
placements: the torch counterpart of ``with_sharding_constraint``.

The active mesh is the innermost :func:`constraint_mesh` scope (a
``DeviceMesh``).  The LM transformer, the MoE FFN and the GNNs call
``constrain`` at the reference's call sites; ``launch/steps.sharded_step``
runs a cell's step under its mesh.  Two differences from the reference:

* a dim named ``"batch"`` that the data-parallel axes do not divide (a
  smoke batch of 2 over 16 devices) is replicated, where XLA pads the
  shards, because DTensor cannot form a product over rows sharded
  unevenly;
* ``"all"`` names every axis of the mesh, in its order: the GNNs' node
  and edge rows (``constrain(h, "all", None)``).  The reference's
  ``_resolve`` takes it for an axis name that no mesh has, so its GNN
  activations are replicated at every block, against its own docstring
  (``models/gnn/meshgraphnet.py:4-6``); the port shards them as that
  docstring says.
"""
from __future__ import annotations

import contextlib
import math

_MESH_STACK: list = []


@contextlib.contextmanager
def constraint_mesh(mesh):
    """Scope the mesh :func:`constrain` resolves against."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def current_mesh():
    """The mesh constrain() resolves against, or None."""
    return _MESH_STACK[-1] if _MESH_STACK else None


def _resolve(axis, mesh_axes):
    if axis is None:
        return None
    if axis == "batch":
        present = tuple(a for a in ("pod", "data") if a in mesh_axes)
        return present if present else None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in mesh_axes)
        return kept if kept else None
    return axis if axis in mesh_axes else None


def constrain(x, *axes):
    """``x`` laid out by logical axis names over the active mesh; unchanged
    off-mesh (see the module)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import placements

    mesh = current_mesh()
    if mesh is None or mesh.size() <= 1 or len(axes) != x.ndim or \
            not isinstance(x, DTensor):
        return x
    names = set(mesh.mesh_dim_names)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = tuple(_resolve(tuple(mesh.mesh_dim_names) if a == "all" else a,
                          names) for a in axes)
    spec = tuple(None if a == "batch" and r is not None and
                 n % math.prod(sizes[x] for x in r) else r
                 for a, r, n in zip(axes, spec, x.shape))
    pl = placements(mesh, spec)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
