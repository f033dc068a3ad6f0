"""The port's GNN models against the JAX package, on the CPU: the common ops
(scatter_sum, scatter_mean, gather_nodes and their gradients on the
segment_reduce kernel's plain version), the four models' forward passes,
losses and gradients at their smoke configs, NequIP's rotation invariance,
the configs, and the synthetic graph data.

Inputs are made with numpy from a seed (``torch_parity.gnn_batch``: ghost
edges, pad nodes, a crowded segment, species to truncate and clip).  Model
parameters come from the reference's ``init_params`` and are carried across
with ``convert.gnn_params``.  The reference is called through ``jax.jit``.
Tolerances (float32; the port sums each segment in sorted order where
XLA scatters in edge order, and the matrix products differ in order):

* the common ops: rtol = atol = 1e-6;
* forward outputs and losses: rtol = 2e-5, atol = 1e-6 (``TOL``);
* gradients: relative L2 over the whole tree <= 1e-5 and over each leaf
  <= 1e-4, an absolute 1e-7 floor for leaves that are (near) zero;
* NequIP's energies under a rotation and a translation: rtol = atol =
  1e-4, the reference test's own.
"""
import functools

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.gnn import common as jc  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.gnn import common  # noqa: E402
from repro_torch.models.gnn import nequip  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-6)
OP_TOL = dict(rtol=1e-6, atol=1e-6)


def _graph(cls, b, n_graphs):
    return cls(node_feat=b["node_feat"], senders=b["senders"],
               receivers=b["receivers"], edge_feat=None, pos=b["pos"],
               graph_id=b["graph_id"], n_graphs=n_graphs)


@functools.lru_cache(maxsize=None)
def _reference(arch_id: str, cfg, n_graphs: int):
    """The reference's forward and value_and_grad(loss), jitted."""
    mod = jsteps.GNN_MODULES[arch_id]
    label = tp.GNN_LABEL[arch_id]

    def forward(params, b):
        return mod.forward(cfg, params, _graph(jc.GraphBatch, b, n_graphs))

    def loss(params, b):
        return mod.loss_fn(cfg, params, {
            "graph": _graph(jc.GraphBatch, b, n_graphs),
            label: b[label]})[0]

    return jax.jit(forward), jax.jit(jax.value_and_grad(loss))


def _np_params(arch_id, cfg, seed):
    init = jax.jit(jsteps.GNN_MODULES[arch_id].init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(cfg, jax.random.key(seed)))


def assert_grads_close(got, want):
    """Relative L2 <= 1e-5 over the tree and <= 1e-4 per leaf."""
    g = [x.numpy().astype(np.float64) for x in tree.leaves(got)]
    w = [np.asarray(x, np.float64) for x in jax.tree.leaves(want)]
    assert [a.shape for a in g] == [a.shape for a in w]
    total = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in zip(g, w)))
    assert total <= 1e-5 * np.sqrt(sum(np.sum(b ** 2) for b in w))
    for a, b in zip(g, w):
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b) + 1e-7


CASES = {
    # name: (index over E=40 edges into [0, n], n=7)
    "ghost": lambda rng: rng.integers(0, 8, 40),
    "empty": lambda rng: np.where(rng.integers(0, 7, 40) == 3, 6, 2),
    "all_to_zero": lambda rng: np.zeros(40, np.int64),
}


@pytest.mark.parametrize("case", CASES)
def test_common_ops_match_reference(case):
    """scatter_sum and gather_nodes (values of 3 dims), scatter_mean (2
    dims, as the reference takes them) and their gradients against
    jax.ops.segment_sum and jax.grad; segments with no edge, the ghost id n
    and all edges 0 -> 0 (one segment of E rows)."""
    rng = np.random.default_rng(len(case))
    n = 7
    idx = CASES[case](rng).astype(np.int32)
    vals = rng.standard_normal((40, 3, 2)).astype(np.float32)
    x = rng.standard_normal((n, 3, 2)).astype(np.float32)
    wn = rng.standard_normal((n, 3, 2)).astype(np.float32)
    we = rng.standard_normal((40, 3, 2)).astype(np.float32)

    def j_ops(vals, x):
        return (jc.scatter_sum(vals, idx, n),
                jc.scatter_mean(vals.reshape(40, 6), idx, n),
                jc.gather_nodes(x, idx))

    def j_obj(vals, x):
        s, m, g = j_ops(vals, x)
        return jnp.sum(s * wn) + jnp.sum(m * wn.reshape(n, 6)) + jnp.sum(
            g * we)

    want = jax.jit(j_ops)(vals, x)
    want_grads = jax.jit(jax.grad(j_obj, argnums=(0, 1)))(vals, x)

    index = common.sorted_index(torch.from_numpy(idx), n)
    tv = torch.from_numpy(vals).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = (common.scatter_sum(tv, index, n),
           common.scatter_mean(tv.reshape(40, 6), index, n),
           common.gather_nodes(tx, index))
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w),
                                   **OP_TOL)
    obj = torch.sum(got[0] * torch.from_numpy(wn)) + torch.sum(
        got[1] * torch.from_numpy(wn).reshape(n, 6)) + torch.sum(
        got[2] * torch.from_numpy(we))
    obj.backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want_grads[0]),
                               **OP_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_grads[1]),
                               **OP_TOL)
    assert index.counts.tolist() == np.bincount(
        idx, minlength=n + 1)[:n].tolist()


def test_edge_features_match_reference():
    """edge_vectors (``norm(rel + 1e-12)``, padding edges 0), rbf_expand and
    cosine_cutoff on a batch with ghost edges."""
    b = tp.gnn_batch("schnet", jax_get_arch("schnet").smoke, seed=5)

    def j_feats(b):
        rel, dist, valid = jc.edge_vectors(_graph(jc.GraphBatch, b, 3))
        return (rel, dist, valid, jc.rbf_expand(dist, 16, 3.0),
                jc.cosine_cutoff(dist, 3.0))

    want = jax.jit(j_feats)({k: jnp.asarray(v) for k, v in b.items()})
    tb = _graph(common.GraphBatch, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, 3)
    rel, dist, valid = common.edge_vectors(tb)
    got = (rel, dist, valid, common.rbf_expand(dist, 16, 3.0),
           common.cosine_cutoff(dist, 3.0))
    assert bool((~valid).any()) and bool(valid.any())
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), **OP_TOL)


@pytest.mark.parametrize("arch_id", tp.GNN_ARCHS)
def test_arch_matches_reference(arch_id):
    """Forward pass, loss_fn and its gradients at the smoke config."""
    cfg = jax_get_arch(arch_id).smoke
    n_graphs = 3
    np_params = _np_params(arch_id, cfg, seed=1)
    b = tp.gnn_batch(arch_id, cfg, seed=2, g=n_graphs)
    j_forward, j_loss = _reference(arch_id, cfg, n_graphs)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jparams = jax.tree.map(jnp.asarray, np_params)
    want_out = j_forward(jparams, jb)
    want_loss, want_grads = j_loss(jparams, jb)

    port_cfg = get_arch(arch_id).smoke
    assert vars(port_cfg) == vars(cfg)
    params = convert.gnn_params(np_params)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    out = steps.GNN_MODULES[arch_id].forward(
        port_cfg, params, _graph(common.GraphBatch, tb, n_graphs))
    assert tuple(out.shape) == want_out.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    (loss, _), grads = value_and_grad(
        steps.gnn_loss(arch_id, port_cfg, n_graphs), params,
        steps.with_edge_plan(tb, n_graphs))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert_grads_close(grads, want_grads)


def test_nequip_rotation_invariance():
    """The reference's test_nequip_equivariance on the port: energies
    invariant under a random rotation and a translation of the positions,
    and not constant across molecules."""
    cfg = nequip.NequipConfig(n_layers=2, d_hidden=8, n_rbf=6, cutoff=3.0)
    params = convert.gnn_params(_np_params("nequip", cfg, seed=0))
    data = synthetic.molecule_batch(2, atoms=8, edges_per_graph=48, seed=3)
    e0 = nequip.forward(cfg, params, data["graph"])
    rng = np.random.default_rng(7)
    qm, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(qm) < 0:
        qm[:, 0] *= -1
    pos2 = data["graph"].pos @ torch.from_numpy(qm.astype(np.float32)) + 1.5
    e1 = nequip.forward(cfg, params, data["graph"]._replace(pos=pos2))
    np.testing.assert_allclose(e0.detach().numpy(), e1.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    other = synthetic.molecule_batch(2, atoms=8, edges_per_graph=48, seed=1)
    e2 = nequip.forward(cfg, params, other["graph"])
    assert not np.allclose(e0.detach().numpy(), e2.detach().numpy())


def test_configs_and_init_match_reference():
    """Each GNN arch's config, shapes and source, and its init_params tree
    (structure, shapes, dtypes) against the reference's."""
    for arch_id in tp.GNN_ARCHS:
        arch, jarch = get_arch(arch_id), jax_get_arch(arch_id)
        for got, want in ((arch.config, jarch.config),
                          (arch.smoke, jarch.smoke)):
            assert vars(got) == vars(want)
            assert got.param_count() == want.param_count()
        assert arch.shapes == jarch.shapes and arch.source == jarch.source
        assert arch.family == jarch.family == "gnn"
        shapes = jax.eval_shape(
            functools.partial(jsteps.GNN_MODULES[arch_id].init_params,
                              jarch.smoke), jax.random.key(0))
        params = steps.GNN_MODULES[arch_id].init_params(
            arch.smoke, torch.Generator().manual_seed(0))
        got = [(p, tuple(x.shape), str(x.dtype).split(".")[-1])
               for p, x in tree.flatten_with_path(params)]
        want = [(tuple(str(k) for k in p), x.shape, str(x.dtype))
                for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
        assert got == want


def test_synthetic_data_matches_reference():
    """molecule_batch, mesh_batch, community_graph and NeighborSampler give
    the reference's arrays from the same seed; the graph_id of a molecule
    batch is sorted, so its plan holds the per-graph index."""
    pairs = [(synthetic.molecule_batch(3, atoms=10, edges_per_graph=32,
                                       seed=4),
              jsynth.molecule_batch(3, atoms=10, edges_per_graph=32, seed=4)),
             (synthetic.mesh_batch(5, 7, seed=2), jsynth.mesh_batch(5, 7, 2))]
    edges, feats, labels = synthetic.community_graph(n=120, seed=3)
    jedges, jfeats, jlabels = jsynth.community_graph(n=120, seed=3)
    for a, b in ((edges, jedges), (feats, jfeats), (labels, jlabels)):
        np.testing.assert_array_equal(a, b)
    seeds = np.arange(0, 120, 7)
    pairs.append((
        synthetic.NeighborSampler(edges, 120, (4, 3), seed=5).sample(
            seeds, feats, labels, 96, 160),
        jsynth.NeighborSampler(jedges, 120, (4, 3), seed=5).sample(
            seeds, jfeats, jlabels, 96, 160)))
    for got, want in pairs:
        assert got.keys() == want.keys()
        for key in got:
            if key == "graph":
                g, w = got[key], want[key]
                assert g.n_graphs == w.n_graphs and g.plan is not None
                for f in ("node_feat", "senders", "receivers", "pos",
                          "graph_id"):
                    np.testing.assert_array_equal(getattr(g, f).numpy(),
                                                  np.asarray(getattr(w, f)))
            else:
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(want[key]))
    assert pairs[0][0]["graph"].plan.graph is not None


def test_graph_sum_needs_sorted_graph_ids():
    """The per-graph energy sums on segment_reduce over graph_id in its
    order, so an unsorted graph_id raises instead of summing wrongly."""
    cfg = nequip.NequipConfig(n_layers=1, d_hidden=4, n_rbf=4, cutoff=3.0)
    params = nequip.init_params(cfg, torch.Generator().manual_seed(0))
    data = synthetic.molecule_batch(2, atoms=6, edges_per_graph=12, seed=0)
    g = data["graph"]
    shuffled = g._replace(graph_id=g.graph_id.flip(0), plan=None)
    with pytest.raises(ValueError, match="non-decreasing"):
        nequip.forward(cfg, params, shuffled)
    with pytest.raises(ValueError, match="non-decreasing"):
        common.sorted_index(g.graph_id.flip(0), 2, presorted=True)
