"""The port's FM and GNN cells run as sharded programs (``launch/steps.py``
``sharded_step``) against the reference and the one-device port, on the
CPU.

Four gloo ranks (``launch/gnn_partitioned.spawn_ranks``, one spawn for the
module) hold the smoke cells on a (2, 2) ("data", "model") mesh
(``tests/sharded_cases.py``; the ranks import no JAX): FM ``train_batch``,
``serve_bulk`` and ``retrieval_cand`` (both tables' rows over (data,
model), a vocab-parallel lookup, fm_interaction's DTensor rule), and one
AdamW step of each GNN (node and edge rows over both axes, each rank's edge
plan its own, the parameters replicated) on a batch with random edges,
ghost edges and padded nodes.  Tolerances (float32): a train step's loss
and grad_norm within 1e-6 relative of the one-device port's and of the
reference's cell (called through ``jax.jit`` on the same parameters and
batch), the parameters after one AdamW step rtol = 2e-5, atol = 1e-6
(``test_torch_gnn_train``); serve and retrieval scores within 1e-6
relative L2.  On a one-rank mesh every output is bit for bit the
one-device cell's.  The FM (tables' rows over both axes) and MeshGraphNet
(replicated) train steps' parameters, saved from the mesh, restore onto
one device, onto the mesh and onto a (4, 1) mesh.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sharded_cases as cases  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.dist import constrain as jconstrain  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.gnn_partitioned import spawn_ranks  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-6)
RTOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    job = {"ckpt": str(tmp_path_factory.mktemp("ck_fm_gnn"))}
    res = spawn_ranks(cases.fm_gnn_world, 4, (job,), device="cpu",
                      timeout_s=300)
    return dict(res[0], ckpt=job["ckpt"],
                on_mesh=[r["restored_on_mesh"] for r in res])


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _reference(arch_id: str, shape: str, cell):
    """The reference's smoke cell run through ``jax.jit`` on the inputs of
    the port's one-device ``cell`` (a GNN batch without its edge plan):
    a train cell's {"params", "loss", "grad_norm"}, else its output."""
    jcell = jsteps.build_cell(jax_get_arch(arch_id), shape, make_host_mesh(),
                              smoke=True)

    def j(x):
        return jax.tree.map(jnp.asarray, tree.tree_map(cases._numpy, x))

    params = j(cell.args[0])
    if cell.meta["kind"] != "train":
        return np.asarray(jax.jit(jcell.step_fn)(
            params, *(j(a) for a in cell.args[1:])))
    batch = {k: v for k, v in cell.args[2].items() if k != "plan"}
    p, _, m = jax.jit(jcell.step_fn)(params, jadamw.init_state(params),
                                     j(batch))
    return {"params": p, "loss": m["loss"], "grad_norm": m["grad_norm"]}


def _check(got, want, what: str) -> None:
    """A sharded (or one-device) step's outputs against ``want``'s: a
    train step's loss and grad_norm within RTOL relative and parameters
    within TOL; scores within RTOL relative L2."""
    if not isinstance(want, dict):
        assert np.asarray(got).shape == np.asarray(want).shape, what
        assert _rel_l2(got, want) <= RTOL, (what, _rel_l2(got, want))
        return
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=RTOL, err_msg=f"{what} {key}")
    for g, w in zip(tree.leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(g, np.asarray(w), **TOL, err_msg=what)


def _restores(world, arch_id: str, shape: str, cell) -> None:
    """The train step's parameters saved from the (2, 2) mesh restore onto
    it and onto a (4, 1) mesh with the target's placements, and onto one
    device equal to the gathered ones."""
    assert all(all(r) for r in world["on_mesh"])
    d = f"{world['ckpt']}/{arch_id}"
    assert ckpt.latest_step(d) == 1
    back = ckpt.restore(d, 1, {"params": cell.args[0],
                               "opt": cell.args[1]})
    for g, w in zip(tree.leaves(back["params"]),
                    tree.leaves(world[f"{arch_id}/{shape}"]["params"])):
        np.testing.assert_array_equal(g.numpy(), w)


def test_fm_cells_match_reference_and_one_device(world):
    """FM train_batch, serve_bulk and retrieval_cand on the (2, 2) mesh
    against the one-device port and the reference's cells; the regions
    and collectives that ran; the train step's parameters restore from a
    checkpoint written on the mesh."""
    for arch_id, shape in cases.FM_CELLS:
        cell = cases.model_cell(arch_id, shape)
        got = world[f"{arch_id}/{shape}"]
        _check(got, cases.run_cell(cell), f"{shape} against one device")
        _check(got, _reference(arch_id, shape, cell),
               f"{shape} against the reference")
        if shape == "train_batch":
            _restores(world, arch_id, shape, cell)
    assert {"embedding", "fm_interaction", "sorted_index", "rows",
            "segment_reduce"} <= set(world["regions"])
    assert world["collectives"].get("reduce-scatter", 0) > 0


@pytest.mark.parametrize("arch_id,shape", cases.GNN_CELLS,
                         ids=[c[0] for c in cases.GNN_CELLS])
def test_gnn_step_matches_reference_and_one_device(world, arch_id, shape):
    """One AdamW step of the GNN on the (2, 2) mesh (node and edge rows
    over both axes) against the one-device port and the reference's cell
    on the same batch; MeshGraphNet's parameters restore from a
    checkpoint written on the mesh."""
    cell = cases.model_cell(arch_id, shape)
    got = world[f"{arch_id}/{shape}"]
    _check(got, cases.run_cell(cell), "against one device")
    _check(got, _reference(arch_id, shape, cell), "against the reference")
    if arch_id == "meshgraphnet":
        _restores(world, arch_id, shape, cell)


@pytest.mark.parametrize("family", ["fm", "gnn"])
def test_one_rank_mesh_is_bitwise_the_one_device_cell(family):
    """On a (1, 1) mesh (one gloo rank, this process) every FM cell, or
    every GNN step, gives the one-device cell's outputs bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch.gnn_partitioned import free_port
    from repro_torch.launch.mesh import compat_make_mesh

    cells = cases.FM_CELLS if family == "fm" else cases.GNN_CELLS
    want = [cases.run_cell(cases.model_cell(*c)) for c in cells]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = compat_make_mesh((1, 1), ("data", "model"))
        got = [cases.run_cell(cases.model_cell(*c, mesh), mesh)
               for c in cells]
    finally:
        dist.destroy_process_group()
    for c, g, w in zip(cells, got, want):
        for a, b in zip(tree.leaves(g), tree.leaves(w)):
            np.testing.assert_array_equal(a, b, err_msg=str(c))


def test_cells_carry_the_reference_specs_and_constrain_all():
    """FM and GNN cells built with a mesh carry in_specs and the
    reference's out_specs (train: the parameters' and optimizer state's
    specs; FM serve and retrieval: the data axes); GNN parameters are
    replicated.  ``constrain(x, "all", None)`` shards x's rows over every
    mesh axis, where the reference's ``_resolve`` takes "all" for an axis
    no mesh has (and so replicates)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.dist.constrain import constrain, constraint_mesh
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.mesh import make_host_mesh as mhm

    with fake_world(4):
        mesh = mhm(model_axis=2)
        for arch_id, shape in cases.FM_CELLS + cases.GNN_CELLS:
            cell = cases.model_cell(arch_id, shape, mesh)
            assert cell.in_specs is not None, shape
            if cell.meta["kind"] == "train":
                assert cell.out_specs[:2] == cell.in_specs[:2]
                assert cell.out_specs[2] is None
            else:
                assert cell.out_specs == (("data",),)
            if arch_id != "fm":
                assert all(all(e is None for e in spec) for _, _, spec in
                           sh.flatten_specs(cell.args[0], cell.in_specs[0]))
        x = distribute_tensor(torch.zeros(8, 3), mesh, [Shard(1), Shard(1)])
        with constraint_mesh(mesh):
            assert constrain(x, "all", None).placements == (Shard(0),
                                                            Shard(0))
    assert jconstrain._resolve("all", {"data", "model"}) is None
