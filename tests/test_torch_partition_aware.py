"""The port's partition-aware device layout against the JAX package, on the
CPU: ``plan_from_partition`` over the port's ``partition()`` parts and
``naive_plan`` equal the reference's plans of the same graph exactly (every
field, and ``comm_bytes_per_layer``), and a MeshGraphNet's loss on the
graph reordered into the plan's device-block order equals the loss in the
input order within the models' tolerance (rtol = 2e-5, atol = 1e-6: only
the order of the float32 sums changes).
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

from repro.core.graph import build_csr_host as jax_build_csr_host  # noqa: E402,E501
from repro.dist import partition_aware as jpa  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.graph import build_csr_host  # noqa: E402
from repro_torch.core.partition import PartitionConfig, partition  # noqa: E402,E501
from repro_torch.data import graphs as gen  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.dist import partition_aware as pa  # noqa: E402
from repro_torch.models.gnn import common, meshgraphnet  # noqa: E402


def _edges(graph: str):
    """(n, undirected edge list) of each case."""
    if graph == "grid":
        idx = np.arange(20 * 16).reshape(20, 16)
        return 320, np.concatenate([
            np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)])
    if graph == "mesh":
        g = synthetic.mesh_batch(14, 12, seed=0)["graph"]
        return 168, torch.stack([g.senders, g.receivers], 1).numpy()
    if graph == "planted":
        edges, _ = gen.planted_partition(400, 6, 8, seed=1)
        return 400, edges
    edges, _, _ = synthetic.community_graph(n=300, n_classes=5, seed=2)
    return 300, edges


def _assert_plans_equal(got, want):
    assert (got.k, got.n) == (want.k, want.n)
    for f in ("dev_of", "perm", "edges_new", "halo_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.local_edge_frac == want.local_edge_frac
    assert got.halo_fraction == want.halo_fraction
    for d in (64, 128):
        assert pa.comm_bytes_per_layer(got, d) == \
            jpa.comm_bytes_per_layer(want, d)


@pytest.mark.parametrize("graph", ["grid", "mesh", "planted", "community"])
def test_plans_match_reference(graph):
    """k = 8 devices, lam = 0.05 (the example's), ell backend."""
    n, edges = _edges(graph)
    g, jg = build_csr_host(n, edges), jax_build_csr_host(n, edges)
    res = partition(g, PartitionConfig(k=8, lam=0.05, backend="ell"),
                    device="cpu")
    plan = pa.plan_from_partition(g, res.parts, 8)
    _assert_plans_equal(plan, jpa.plan_from_partition(
        jg, res.parts.numpy(), 8))
    _assert_plans_equal(pa.naive_plan(g, 8), jpa.naive_plan(jg, 8))
    with pytest.raises(ValueError, match="ghost parts"):
        pa.plan_from_partition(g, torch.full((n,), 8), 8)


def test_reordered_mesh_loss_equals_original():
    """The mesh batch reordered into the Jet plan's device blocks (features,
    positions and targets by ``perm``, edges from ``edges_new``) is the same
    graph: the MeshGraphNet loss is unchanged but for the sums' order."""
    data = synthetic.mesh_batch(12, 10, seed=3)
    graph = data["graph"]
    edges = torch.stack([graph.senders, graph.receivers], 1).numpy()
    g = build_csr_host(120, edges)
    res = partition(g, PartitionConfig(k=8, lam=0.05, backend="ell"),
                    device="cpu")
    plan = pa.plan_from_partition(g, res.parts, 8)
    perm = torch.from_numpy(plan.perm)
    e_new = torch.from_numpy(plan.edges_new.astype(np.int32))
    assert e_new.shape[0] == edges.shape[0]
    reordered = {"graph": common.with_plan(graph._replace(
        node_feat=graph.node_feat[perm], pos=graph.pos[perm],
        senders=e_new[:, 0].contiguous(), receivers=e_new[:, 1].contiguous(),
        graph_id=graph.graph_id[perm], plan=None)),
        "target": data["target"][perm]}
    cfg = get_arch("meshgraphnet").smoke
    params = meshgraphnet.init_params(cfg, torch.Generator().manual_seed(0))
    want = meshgraphnet.loss_fn(cfg, params, data)[0]
    got = meshgraphnet.loss_fn(cfg, params, reordered)[0]
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5, atol=1e-6)
    assert plan.local_edge_frac > pa.naive_plan(g, 8).local_edge_frac
