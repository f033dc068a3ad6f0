"""The port's partitioned MeshGraphNet training against the JAX package, on
the CPU (``launch/gnn_partitioned.py``).

* ``build_partitioned_batch`` equals the reference's bit for bit (all
  eight arrays and both drop counts) on a 16x16 grid cut into K = 8 parts,
  with no drop, with halo drops (and the receiver the reference leaves in
  a dropped edge's slot), and with both kinds of drop.
* 8 gloo ranks, one process each, against the reference's 8-device
  ``shard_map`` step (run in a subprocess with 8 host devices): the loss
  and ``grad_norm`` within 1e-5 relative (the dense gradient's norm, not 8
  times it), and the parameters after one AdamW step within the models'
  tolerance (rtol = 2e-5, atol = 1e-6).
* One rank against the dense model: loss and gradients within that
  tolerance, and segment_reduce called ``chip_smoke.partitioned_segment_sums``
  times a step (the count the card's launches are held to).
* The meshes of ``launch/mesh.py`` over the ranks of the group.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro.launch import gnn_partitioned as jgp  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.partition import PartitionConfig, partition  # noqa: E402,E501
from repro_torch.data import graphs as gen  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.launch import gnn_partitioned as gp  # noqa: E402
from repro_torch.models.gnn import common, meshgraphnet  # noqa: E402
from repro_torch.train import loop  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=1e-6)
K, N_L, H_CAP, E_CAP_TOTAL = 8, 64, 64, 2048
CFG = meshgraphnet.MGNConfig(n_layers=3, d_hidden=16, d_in=4)

# The reference's 8-device step on tests/test_gnn_partitioned.py's case;
# writes the parts, the parameters before and after, and the metrics.
REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, numpy as np
from repro.configs import get_arch
from repro.core.partition import PartitionConfig, partition
from repro.data import graphs as gen
from repro.launch.gnn_partitioned import (
    build_partitioned_batch, partitioned_gnn_cell)
from repro.launch.mesh import compat_make_mesh
from repro.models.gnn import meshgraphnet
from repro.optim import adamw

K, n_l, h_cap, e_cap_total = 8, 64, 64, 2048
g = gen.grid2d(16, 16)
n, m = int(g.n), int(g.m)
rng = np.random.default_rng(0)
feats = rng.standard_normal((n, 4)).astype(np.float32)
pos = rng.standard_normal((n, 3)).astype(np.float32)
target = rng.standard_normal((n, 2)).astype(np.float32)
edges = np.stack([np.asarray(g.esrc)[:m], np.asarray(g.adjncy)[:m]], 1)
res = partition(g, PartitionConfig(k=K, lam=0.10))
cfg = meshgraphnet.MGNConfig(n_layers=3, d_hidden=16, d_in=4)
params = meshgraphnet.init_params(cfg, jax.random.key(0))
p0 = [np.asarray(x) for x in jax.tree.leaves(params)]
batch, stats = build_partitioned_batch(
    n, feats, pos, target, edges, res.parts, K, n_l, e_cap_total, h_cap)
arch = get_arch("meshgraphnet")
shape = {"kind": "train", "n_nodes": K * n_l, "n_edges": e_cap_total,
         "d_feat": 4, "n_graphs": 1}
arch = dataclasses.replace(arch, shapes=dict(arch.shapes, test_shape=shape),
                           config=cfg, smoke=cfg)
mesh = compat_make_mesh((8,), ("data",))
cell = partitioned_gnn_cell(arch, "test_shape", mesh,
                            tuning={"halo_frac": 1.0})
step = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
               out_shardings=cell.out_shardings, donate_argnums=cell.donate)
p1, _, metrics = step(params, adamw.init_state(params), batch)
np.savez(sys.argv[1], parts=np.asarray(res.parts)[:n], feats=feats, pos=pos,
         target=target, edges=edges, loss=float(metrics["loss"]),
         grad_norm=float(metrics["grad_norm"]),
         dropped=[stats["dropped_edges"], stats["dropped_halo"]],
         **{f"p0_{i}": x for i, x in enumerate(p0)},
         **{f"p1_{i}": np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(p1))})
"""


def _case():
    """The 16x16 grid's inputs (the reference test's) and the port's
    K = 8 partition of it."""
    g = gen.grid2d(16, 16)
    n, m = int(g.n), int(g.m)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, 4)).astype(np.float32)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    target = rng.standard_normal((n, 2)).astype(np.float32)
    edges = np.stack([g.esrc[:m].numpy(), g.adjncy[:m].numpy()], 1)
    res = partition(g, PartitionConfig(k=K, lam=0.10), device="cpu")
    assert res.balanced
    return n, feats, pos, target, edges, res.parts.numpy()[:n]


@pytest.mark.parametrize("h_cap,e_cap_total,dropped,residue", [
    (64, 2048, (0, 0), 0), (8, 2048, (56, 43), 2), (8, 768, (210, 43), 1)])
def test_layout_matches_reference(h_cap, e_cap_total, dropped, residue):
    n, feats, pos, target, edges, parts = _case()
    got, stats = gp.build_partitioned_batch(
        n, feats, pos, target, edges, parts, K, N_L, e_cap_total, h_cap)
    want, wstats = jgp.build_partitioned_batch(
        n, feats, pos, target, edges, parts, K, N_L, e_cap_total, h_cap)
    assert stats == wstats
    assert (stats["dropped_edges"], stats["dropped_halo"]) == dropped
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    # slots that keep a real receiver with valid_edge 0
    rcv = got["receivers"].reshape(K, -1)
    valid = got["valid_edge"].reshape(K, -1)
    assert int(((rcv != N_L) & (valid == 0)).sum()) == residue


@contextlib.contextmanager
def _one_rank():
    """A gloo group of one rank in this process."""
    gp.init_rank(0, 1, gp.free_port(), torch.device("cpu"), log=lambda *a,
                 **k: None)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def _params(leaves):
    structure = meshgraphnet.init_params(
        CFG, torch.Generator().manual_seed(0))
    return tree.unflatten(structure, [torch.from_numpy(np.array(x))
                                      for x in leaves])


def test_eight_ranks_match_reference(tmp_path):
    """8 gloo processes against the reference's 8-device step."""
    out = tmp_path / "reference.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(out)
    assert ref["dropped"].tolist() == [0, 0]
    n = ref["parts"].shape[0]
    batch, stats = gp.build_partitioned_batch(
        n, ref["feats"], ref["pos"], ref["target"], ref["edges"],
        ref["parts"], K, N_L, E_CAP_TOTAL, H_CAP)
    assert stats == {"dropped_edges": 0, "dropped_halo": 0}
    n_leaves = sum(f.startswith("p0_") for f in ref.files)
    torch.save(_params([ref[f"p0_{i}"] for i in range(n_leaves)]),
               tmp_path / "params.pt")
    np.savez(tmp_path / "layout.npz", **batch)
    res = gp.spawn_ranks(gp.train_job, K, ({
        "layout": str(tmp_path / "layout.npz"), "cfg": CFG,
        "halo_frac": H_CAP / N_L, "steps": 1,
        "params": str(tmp_path / "params.pt"), "return_params": True},),
        device="cpu", timeout_s=240)
    for r_ in res:
        assert r_["meta"]["backend"] == "gloo"
        assert r_["loss"] == res[0]["loss"]
        assert r_["grad_norm"] == res[0]["grad_norm"]
    loss, gn = res[0]["loss"][0], res[0]["grad_norm"][0]
    assert abs(loss - float(ref["loss"])) <= 1e-5 * abs(float(ref["loss"]))
    assert abs(gn - float(ref["grad_norm"])) <= \
        1e-5 * float(ref["grad_norm"])
    for i, got in enumerate(res[0]["params"]):
        np.testing.assert_allclose(got, ref[f"p1_{i}"], **TOL)


def test_one_rank_matches_dense(monkeypatch):
    """World size 1 (the layout is the input order): loss and gradients
    equal the dense model's within the models' tolerance, and one step
    calls segment_reduce as often as chip_smoke counts."""
    n, feats, pos, target, edges, _ = _case()
    batch, stats = gp.build_partitioned_batch(
        n, feats, pos, target, edges, np.zeros(n, np.int64), 1, 512, 2048,
        8)
    assert stats == {"dropped_edges": 0, "dropped_halo": 0}
    params = meshgraphnet.init_params(CFG, torch.Generator().manual_seed(3))
    graph = common.GraphBatch(
        node_feat=torch.from_numpy(feats),
        senders=torch.from_numpy(edges[:, 0].astype(np.int32)),
        receivers=torch.from_numpy(edges[:, 1].astype(np.int32)),
        edge_feat=None, pos=torch.from_numpy(pos),
        graph_id=torch.zeros(n, dtype=torch.int32), n_graphs=1)
    (want_l, _), want_g = loop.value_and_grad(
        lambda p, b: meshgraphnet.loss_fn(CFG, p, b), params,
        {"graph": graph, "target": torch.from_numpy(target)})
    calls = []
    real = sr.segment_sum_sorted

    def counted(*a):
        calls.append(a[0].shape)
        return real(*a)

    with _one_rank():
        ex = gp.Exchange()
        block = gp.with_local_plan(gp.rank_block(batch, 0, 1), 1)
        monkeypatch.setattr(sr, "segment_sum_sorted", counted)
        loss, grads = gp.value_and_grad(CFG, params, block, ex)
    np.testing.assert_allclose(float(loss), float(want_l), **TOL)
    for a, b in zip(tree.leaves(grads), tree.leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert len(calls) == chip_smoke.partitioned_segment_sums(CFG)


def test_meshes_over_the_group():
    """``launch/mesh.py``: no mesh without a process group; over one gloo
    rank, the host mesh is (data 1, model 1) and shards the batch over
    ``data``, and a cell built over either mesh spans the group."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh, steps

    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_host_mesh()
    with _one_rank():
        host = mesh.make_host_mesh()
        assert host.mesh_dim_names == ("data", "model")
        assert tuple(host.shape) == (1, 1)
        assert mesh.dp_axes(host) == ("data",)
        flat = mesh.compat_make_mesh((1,), ("data",))
        for m in (host, flat):
            cell = steps.build_cell(
                get_arch("meshgraphnet"), "full_graph_sm", "cpu", smoke=True,
                tuning={"mode": "partitioned"}, mesh=m)
            assert (cell.meta["world"], cell.meta["rank"]) == (1, 0)
