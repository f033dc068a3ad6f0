"""Mirrors of the reference's model tests (``tests/test_models.py``) that had
no port counterpart, on the CPU: MoE with forced capacity drops, NequIP not
constant across inputs, and GraphSAGE learning from the neighbour
sampler's batches.  (Chunked attention and decode against the full forward
have theirs: ``test_torch_flash_attention.py::test_attention_paths_match_reference``,
``test_torch_transformer.py::test_decode_matches_prefill`` and
``test_torch_mla.py::test_mla_decode_matches_prefill``.)  Inputs are made
with numpy from a seed; the port's weights come from seeded generators."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.data import synthetic as synth  # noqa: E402
from repro_torch.models.gnn import graphsage, nequip  # noqa: E402
from repro_torch.models.moe import moe_apply, moe_init  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_moe_capacity_drops_gracefully():
    p = moe_init(_gen(0), 16, 32, 4, 1, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 16)).astype(np.float32))
    out, aux = moe_apply(p, x, top_k=2, capacity_factor=0.5)  # forced drops
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert float(aux) > 0


def test_nequip_not_trivially_constant():
    cfg = nequip.NequipConfig(n_layers=2, d_hidden=8, n_rbf=6, cutoff=3.0)
    params = nequip.init_params(cfg, _gen(0))
    d1 = synth.molecule_batch(2, atoms=8, edges_per_graph=48, seed=1)
    d2 = synth.molecule_batch(2, atoms=8, edges_per_graph=48, seed=2)
    with torch.no_grad():
        e1 = nequip.forward(cfg, params, d1["graph"])
        e2 = nequip.forward(cfg, params, d2["graph"])
    assert not np.allclose(e1.numpy(), e2.numpy())


def test_graphsage_with_sampler_learns():
    edges, feats, labels = synth.community_graph(n=400, n_classes=4,
                                                 d_feat=32, seed=0)
    cfg = graphsage.SageConfig(n_layers=2, d_in=32, d_hidden=32, n_classes=4)
    params = graphsage.init_params(cfg, _gen(0))
    sampler = synth.NeighborSampler(edges, 400, fanouts=(10, 5))
    rng = np.random.default_rng(0)

    def loss(p, b):
        return graphsage.loss_fn(cfg, p, b)

    losses = []
    for _ in range(20):
        seeds = rng.choice(400, 64, replace=False)
        batch = sampler.sample(seeds, feats, labels, pad_nodes=2048,
                               pad_edges=8192)
        (l, _), grads = value_and_grad(loss, params, batch)
        params = tree.tree_map(lambda a, g: a - 0.3 * g, params, grads)
        losses.append(float(l))
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses
