"""Partition-aware device layout: the Jet partitioner as a communication
planner for distributed GNN training (counterpart of
``repro.dist.partition_aware``: numpy over the port's ``graph_to_host``).

``plan_from_partition`` turns a k-way partition into a :class:`CommPlan`:
each device owns a contiguous block of vertices (``perm`` gives the
device-block order), edges live on their receiver's device, and the plan
records which vertices must be exported as halo features each layer.
``naive_plan`` is the strawman — contiguous vertex blocks in input order —
whose per-layer cost is a full-node all-gather plus all-reduce.

Collective bytes per message-passing layer (``launch/gnn_partitioned.py``
trains on such a layout):
    naive       : N*F (gather) + N*F (reduce)  = 2*N*F
    partitioned : halo_fraction * N * F        (one boundary gather)
so the partitioner's cut quality IS the communication bill.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graph import Graph, graph_to_host


@dataclass(frozen=True)
class CommPlan:
    """Device layout + communication statistics for one partition."""

    k: int                     # number of devices
    n: int                     # vertices
    dev_of: np.ndarray         # (n,) device id per original vertex
    perm: np.ndarray           # (n,) original vertex ids in device-block order
    edges_new: np.ndarray      # (m, 2) directed (sender, receiver), new ids
    local_edge_frac: float     # directed edges with both endpoints co-located
    halo_fraction: float       # unique exported boundary vertices / n
    halo_counts: np.ndarray    # (k,) boundary exports per device


def _plan(n: int, edges_dir: np.ndarray, dev_of: np.ndarray, k: int) -> CommPlan:
    perm = np.argsort(dev_of, kind="stable").astype(np.int64)
    new_id = np.empty(n, np.int64)
    new_id[perm] = np.arange(n)
    src, dst = edges_dir[:, 0], edges_dir[:, 1]
    local = dev_of[src] == dev_of[dst]
    exported = np.unique(src[~local]) if edges_dir.shape[0] else np.empty(0, np.int64)
    halo_counts = np.bincount(dev_of[exported], minlength=k) if exported.size \
        else np.zeros(k, np.int64)
    edges_new = np.stack([new_id[src], new_id[dst]], axis=1)
    return CommPlan(
        k=k,
        n=n,
        dev_of=dev_of,
        perm=perm,
        edges_new=edges_new,
        local_edge_frac=float(local.mean()) if local.size else 1.0,
        halo_fraction=float(exported.size / max(n, 1)),
        halo_counts=halo_counts,
    )


def _directed_edges(g: Graph) -> tuple[int, np.ndarray]:
    n, edges, _, _ = graph_to_host(g)  # (u < v) undirected
    if edges.shape[0] == 0:
        return n, np.zeros((0, 2), np.int64)
    return n, np.concatenate([edges, edges[:, ::-1]]).astype(np.int64)


def plan_from_partition(g: Graph, parts, k: int) -> CommPlan:
    """Layout from a Jet partition: device = part."""
    n, edges_dir = _directed_edges(g)
    dev_of = torch.as_tensor(parts)[:n].cpu().numpy().astype(np.int64)
    if dev_of.min() < 0 or dev_of.max() >= k:
        raise ValueError("partition has ghost parts")
    return _plan(n, edges_dir, dev_of, k)


def naive_plan(g: Graph, k: int) -> CommPlan:
    """Contiguous input-order blocks — the layout you get without a
    partitioner.  Same CommPlan shape, so costs compare directly."""
    n, edges_dir = _directed_edges(g)
    block = (n + k - 1) // k
    dev_of = np.arange(n, dtype=np.int64) // max(block, 1)
    return _plan(n, edges_dir, np.minimum(dev_of, k - 1), k)


def comm_bytes_per_layer(plan: CommPlan, d_feat: int,
                         bytes_per_scalar: int = 4) -> dict:
    """Per-message-passing-layer collective bytes under both schemes."""
    naive = 2 * plan.n * d_feat * bytes_per_scalar
    halo = int(plan.halo_counts.sum()) * d_feat * bytes_per_scalar
    return {
        "naive_allgather": naive,
        "partition_halo": halo,
        "reduction": naive / max(halo, 1),
    }
