"""The paper's technique as a distribution substrate, on the PyTorch/CUDA
port: Jet-partition a graph, lay it out across (virtual) devices, and train
GraphSAGE on it, reporting the collective traffic the partitioner saves per
message-passing layer.

    PYTHONPATH=src python examples/torch_partition_gnn_training.py \
        [--device cuda|cpu]

Partition-aware training over real ranks (one process each, one halo
exchange a layer) is ``python -m repro_torch.launch.gnn_partitioned``.
"""
import argparse

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.graph import build_csr_host
from repro_torch.core.partition import PartitionConfig, partition
from repro_torch.data import graphs as gen
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.dist.partition_aware import (
    comm_bytes_per_layer, naive_plan, plan_from_partition,
)
from repro_torch.models.gnn import graphsage
from repro_torch.models.gnn.common import GraphBatch, with_plan
from repro_torch.train.loop import value_and_grad


def mesh_showcase(device, k_devices=8):
    """Mesh-structured graph (typical FEM/simulation workload): this is
    where the partitioner's halo reduction is dramatic."""
    g = gen.grid2d(64, 64)
    res = partition(g, PartitionConfig(k=k_devices, lam=0.05), device=device)
    jet = plan_from_partition(g, res.parts, k_devices)
    naive = naive_plan(g, k_devices)
    cbn = comm_bytes_per_layer(naive, 128)
    cbj = comm_bytes_per_layer(jet, 128)
    print(f"mesh 64x64 across {k_devices} devices:")
    print(f"  local edges: naive {naive.local_edge_frac:.1%} -> "
          f"jet {jet.local_edge_frac:.1%}")
    print(f"  halo vertices: naive {naive.halo_fraction:.1%} -> "
          f"jet {jet.halo_fraction:.1%}")
    print(f"  per-layer comm: {cbn['naive_allgather']/1e6:.2f} MB -> "
          f"{cbj['partition_halo']/1e6:.3f} MB "
          f"({cbn['naive_allgather']/max(cbj['partition_halo'],1):.0f}x less)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, needs a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh_showcase(device)

    n, n_classes, d_feat = 1200, 8, 64
    edges, feats, labels = synthetic.community_graph(
        n=n, n_classes=n_classes, d_feat=d_feat, seed=0)
    g = build_csr_host(n, edges)

    k_devices = 8
    print(f"\nSBM graph: n={n} m={int(g.m)//2}; partitioning for "
          f"{k_devices} devices")
    res = partition(g, PartitionConfig(k=k_devices, lam=0.05), device=device)
    print(f"  jet cut={res.cut} imbalance={res.imbalance:.3f}")

    jet = plan_from_partition(g, res.parts, k_devices)
    naive = naive_plan(g, k_devices)
    print(f"  local edges: naive {naive.local_edge_frac:.1%} -> "
          f"jet {jet.local_edge_frac:.1%}")
    print(f"  halo vertices: naive {naive.halo_fraction:.1%} -> "
          f"jet {jet.halo_fraction:.1%}")
    cb_naive = comm_bytes_per_layer(naive, 128)
    cb_jet = comm_bytes_per_layer(jet, 128)
    print(f"  per-layer comm: all-gather {cb_naive['naive_allgather']/1e6:.2f} MB"
          f" -> halo {cb_jet['partition_halo']/1e6:.2f} MB "
          f"({cb_jet['reduction']:.1f}x less)")

    # train on the REORDERED graph (device-contiguous vertex blocks)
    perm, e_new = jet.perm, jet.edges_new

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batch = {
        "graph": with_plan(GraphBatch(
            node_feat=t(feats[perm]),
            senders=t(e_new[:, 0].astype(np.int32)),
            receivers=t(e_new[:, 1].astype(np.int32)),
            edge_feat=None,
            pos=torch.zeros((n, 3), device=device),
            graph_id=torch.zeros((n,), dtype=torch.int32, device=device),
            n_graphs=1,
        )),
        "labels": t(labels[perm].astype(np.int32)),
    }
    cfg = graphsage.SageConfig(n_layers=2, d_in=d_feat, d_hidden=64,
                               n_classes=n_classes)
    params = graphsage.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))

    def loss(p, b):
        return graphsage.loss_fn(cfg, p, b)

    for i in range(40):
        (l, _), grads = value_and_grad(loss, params, batch)
        params = tree.tree_map(lambda a, g_: a - 0.5 * g_, params, grads)
        if (i + 1) % 10 == 0:
            print(f"  step {i+1}: loss {float(l):.4f}")
    with torch.no_grad():
        logits = graphsage.forward(cfg, params, batch["graph"])
    acc = float((torch.argmax(logits, -1) == batch["labels"]).float().mean())
    print(f"  final train accuracy: {acc:.1%}")
    return acc


if __name__ == "__main__":
    main()
