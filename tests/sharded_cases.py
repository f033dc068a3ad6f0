"""Rank functions of the sharded tests (``tests/test_torch_sharded_*.py``),
run by ``launch/gnn_partitioned.spawn_ranks`` on gloo with CPU tensors.

They import no JAX: each rank returns numpy arrays and the parent compares
them with the one-device port and the reference.  Inputs are made with
numpy from a seed, the same on every rank.
"""
from __future__ import annotations

import numpy as np
import torch

# (name, H, Hkv, mesh shape (data, model)): heads sharded over "model",
# batch over "data"; (6, 2) over 4 has shards of heads {0, 1}, {2, 3}
# (straddling the groups {0, 1, 2}, {3, 4, 5}), {4, 5} and none
FLASH_CASES = (("h4_kv1_model2", 4, 1, (2, 2)),
               ("h8_kv2_model4", 8, 2, (1, 4)),
               ("h6_kv2_model4", 6, 2, (1, 4)),
               ("h4_kv4_model2", 4, 4, (2, 2)))
FLASH_SHAPE = dict(b=2, s=24, d=16, window=8)


def flash_inputs(h: int, hkv: int, seed: int = 0) -> dict:
    """q, k, v and the output's cotangent w, float32 numpy."""
    rng = np.random.default_rng(seed)
    b, s, d = FLASH_SHAPE["b"], FLASH_SHAPE["s"], FLASH_SHAPE["d"]
    return {"q": rng.standard_normal((b, h, s, d), dtype=np.float32),
            "k": rng.standard_normal((b, hkv, s, d), dtype=np.float32),
            "v": rng.standard_normal((b, hkv, s, d), dtype=np.float32),
            "w": rng.standard_normal((b, h, s, d), dtype=np.float32)}


def flash_one(q, k, v, w, window: int):
    """(o, dq, dk, dv) of flash_attention and the loss sum(o * w), for
    plain tensors or DTensors alike."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = ops.flash_attention(q, k, v, causal=True, window=window)
    dq, dk, dv = torch.autograd.grad((o * w).sum(), (q, k, v))
    return o, dq, dk, dv


# (name, dtype, the data's rows sharded over "data", the output sharded by
# segment range over "model")
SEGMENT_CASES = tuple((f"{dt}_{how}", dt, how in ("rows", "both"),
                       how in ("vocab", "both"))
                      for dt in ("int32", "float32")
                      for how in ("rows", "vocab", "both"))
SEGMENT_SHAPE = dict(m=203, f=5, s=37)


def segment_inputs(dtype: str, seed: int = 0) -> dict:
    """data (M, F), sorted ids (M,) in [-2, S + 2) (ids outside [0, S)
    are dropped), numpy."""
    rng = np.random.default_rng(seed)
    m, f, s = SEGMENT_SHAPE["m"], SEGMENT_SHAPE["f"], SEGMENT_SHAPE["s"]
    data = (rng.integers(-1000, 1000, (m, f)).astype(np.int32)
            if dtype == "int32" else
            rng.standard_normal((m, f), dtype=np.float32))
    ids = np.sort(rng.integers(-2, s + 2, m)).astype(np.int32)
    return {"data": data, "ids": ids}


def ops_world(rank: int, world: int, device, job: dict) -> dict:
    """Every case of FLASH_CASES, FM_RULE_CASES and SEGMENT_CASES on
    DTensors; rank 0 returns the full results as numpy."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.launch.mesh import compat_make_mesh

    torch.set_num_threads(1)   # four ranks beside the test workers
    meshes = {shape: compat_make_mesh(shape, ("data", "model"))
              for shape in {c[3] for c in FLASH_CASES} | {(2, 2)}}
    out = {}

    def dist(x, mesh, *pl):
        return distribute_tensor(torch.from_numpy(x), mesh, pl,
                                 src_data_rank=None)

    for name, h, hkv, shape in FLASH_CASES:
        mesh, a = meshes[shape], flash_inputs(h, hkv)
        q = dist(a["q"], mesh, Shard(0), Shard(1))
        kv = (Shard(0), Shard(1) if hkv == h else Replicate())
        res = flash_one(q, dist(a["k"], mesh, *kv), dist(a["v"], mesh, *kv),
                        dist(a["w"], mesh, Shard(0), Shard(1)),
                        FLASH_SHAPE["window"])
        full = [x.full_tensor().detach().numpy() for x in res]
        if rank == 0:
            out[name] = full
    mesh = meshes[(2, 2)]
    a = rows_inputs()
    x_pl = (Shard(0), Shard(1))    # rows over "data" are gathered first
    res = rows_one(dist(a["x"], mesh, *x_pl),
                   dist(a["values"], mesh, Replicate(), Shard(1)),
                   torch.from_numpy(a["index"]),
                   dist(a["w_gather"], mesh, Replicate(), Shard(1)),
                   dist(a["w_sum"], mesh, Replicate(), Shard(1)))
    full = [r.full_tensor().detach().numpy() for r in res]
    if rank == 0:
        out["rows"] = full
    for name, res in fm_rule_world(mesh).items():
        if rank == 0:
            out[f"fm_{name}"] = res
    for name, dt, rows, vocab in SEGMENT_CASES:
        a = segment_inputs(dt)
        pl = (Shard(0) if rows else Replicate(), Replicate())
        want = (Replicate(), Shard(0) if vocab else Replicate())
        got = sr.segment_sum_sorted(dist(a["data"], mesh, *pl),
                                    dist(a["ids"], mesh, *pl),
                                    SEGMENT_SHAPE["s"], out_placements=want)
        full = got.full_tensor().numpy()
        if rank == 0:
            out[name] = (full, [placement_name(p) for p in got.placements])
    return out


ROWS_SHAPE = dict(n=11, e=29, f=6)


def rows_inputs(seed: int = 0) -> dict:
    """x (N, F), an index (E,) in [0, N] (N the ghost row), values (E, F)
    and the cotangents of the gather (E, F) and of the sum (N, F)."""
    rng = np.random.default_rng(seed)
    n, e, f = ROWS_SHAPE["n"], ROWS_SHAPE["e"], ROWS_SHAPE["f"]
    return {"x": rng.standard_normal((n, f), dtype=np.float32),
            "index": rng.integers(0, n + 1, e).astype(np.int32),
            "values": rng.standard_normal((e, f), dtype=np.float32),
            "w_gather": rng.standard_normal((e, f), dtype=np.float32),
            "w_sum": rng.standard_normal((n, f), dtype=np.float32)}


def rows_one(x, values, index, w_gather, w_sum):
    """gather_nodes(x) and scatter_sum(values) by ``index``, and the
    gradients of sum(gather * w_gather) + sum(sum * w_sum) with respect to
    x and values, for plain tensors or DTensors alike."""
    from repro_torch.models.gather import gather_nodes, scatter_sum, \
        sorted_index

    ix = sorted_index(index, x.shape[0], counts=False)
    x, values = (t.detach().requires_grad_(True) for t in (x, values))
    got = gather_nodes(x, ix)
    summed = scatter_sum(values, ix, x.shape[0])
    gx, gv = torch.autograd.grad(
        (got * w_gather).sum() + (summed * w_sum).sum(), (x, values))
    return got, summed, gx, gv


# the LM cells of the sharded tests: (name, shape, tuning)
LM_CELLS = (("train", "train_4k", None),
            ("train_zero1", "train_4k", {"zero1": True}),
            ("prefill", "prefill_32k", None))


def _numpy(x):
    if not isinstance(x, torch.Tensor):
        return x
    return x.detach().cpu().numpy()


def lm_world(rank: int, world: int, device, job: dict) -> dict:
    """The smoke config of ``job["arch"]`` with the parameters
    ``job["params"]`` (numpy) on a (2, 2) ("data", "model") mesh: a train
    step with and without ZeRO-1, a prefill and a decode step on the
    prefill's cache (the cell's tokens), each through
    ``steps.sharded_step``; the first train step's parameters saved to
    ``job["ckpt"]`` from the mesh.  Rank 0 returns each cell's outputs,
    gathered, as numpy; every rank its regions and collectives."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import tree
    from repro_torch.dist import regions
    from repro_torch.launch import lm_sharded, steps
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.train import checkpoint as ckpt

    torch.set_num_threads(1)   # four ranks beside the test workers
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    out, cache = {}, None
    regions.region_calls.clear()
    with CommDebugMode() as comm:
        for name, shape, tuning in LM_CELLS + (("decode", "decode_32k",
                                                None),):
            cell = lm_sharded.registry_cell(job["arch"], shape, device,
                                            mesh, tuning=tuning,
                                            params=job["params"])
            args = steps.sharded_args(cell, mesh)
            if name == "decode":
                args = (args[0], cache, args[2])
            res = steps.sharded_step(cell, mesh)(*args)
            full = tree.tree_map(_numpy, sh.full(res))
            if name == "prefill":
                cache = res[1]
            if name == "train":   # saved from the mesh, restored onto it
                ckpt.save(job["ckpt"], 1, {"params": res[0]})
                back = ckpt.restore(job["ckpt"], 1, {"params": res[0]})
                out["restored_on_mesh"] = all(
                    tuple(b.placements) == tuple(a.placements) and
                    torch.equal(b.full_tensor(), a.full_tensor())
                    for a, b in zip(tree.leaves(res[0]),
                                    tree.leaves(back["params"])))
            if rank == 0:
                out[name] = full
    out["regions"] = dict(regions.region_calls)
    out["collectives"] = lm_sharded.collective_counts(comm)
    return out


# fm_interaction's DTensor rule on a (2, 2) ("data", "model") mesh: (name,
# B, emb's placements by name); F = 4, D = 6.  "partial" holds a quarter of
# emb on each rank (a vocab-parallel lookup's output); with B = 6 its rows
# divide over "data" only, so the second reduction replicates.
FM_RULE_CASES = (("batch", 12, ("shard0", "shard0")),
                 ("columns", 8, ("shard0", "shard2")),
                 ("partial", 6, ("partial", "partial")),
                 ("fields", 8, ("shard1", "replicate")))
FM_RULE_SHAPE = dict(f=4, d=6)


def fm_rule_inputs(b: int, seed: int = 0) -> dict:
    """emb (B, F, D) and the scores' cotangent w (B,), float32 numpy."""
    rng = np.random.default_rng(seed)
    f, d = FM_RULE_SHAPE["f"], FM_RULE_SHAPE["d"]
    return {"emb": rng.standard_normal((b, f, d), dtype=np.float32),
            "w": rng.standard_normal(b, dtype=np.float32)}


def fm_rule_one(emb, w):
    """fm_interaction's scores and emb's gradient of sum(scores * w), for
    plain tensors or DTensors alike."""
    from repro_torch.kernels.fm_interaction import ops

    emb = emb.detach().requires_grad_(True)
    out = ops.fm_interaction(emb)
    (g,) = torch.autograd.grad((out * w).sum(), (emb,))
    return out, g


def placement_name(p) -> str:
    """A placement's class, with its dim for a shard ("Shard(0)")."""
    return type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "")


def _placement(name: str):
    from torch.distributed.tensor import Partial, Replicate, Shard

    return {"partial": Partial(), "replicate": Replicate()}.get(name) or \
        Shard(int(name[-1]))


def fm_rule_world(mesh) -> dict:
    """Every case of FM_RULE_CASES on ``mesh``: the scores and the gradient
    gathered, and the scores' placements."""
    from torch.distributed.tensor import DTensor, Partial, distribute_tensor

    out = {}
    for name, b, pls in FM_RULE_CASES:
        a = fm_rule_inputs(b)
        pl = [_placement(p) for p in pls]
        full = torch.from_numpy(a["emb"])
        if any(isinstance(p, Partial) for p in pl):
            emb = DTensor.from_local(full * 0.25, mesh, pl, run_check=False)
        else:
            emb = distribute_tensor(full, mesh, pl, src_data_rank=None)
        w = distribute_tensor(torch.from_numpy(a["w"]), mesh,
                              [_placement("replicate")] * 2,
                              src_data_rank=None)
        scores, g = fm_rule_one(emb, w)
        out[name] = ([x.full_tensor().detach().numpy() for x in (scores, g)],
                     [placement_name(p) for p in scores.placements])
    return out


# the FM and GNN cells of the sharded tests: (arch, shape); a GNN cell's
# batch is gnn_batch's, not the cell's zeros
FM_CELLS = (("fm", "train_batch"), ("fm", "serve_bulk"),
            ("fm", "retrieval_cand"))
GNN_CELLS = (("meshgraphnet", "full_graph_sm"),
             ("graphsage-reddit", "minibatch_lg"), ("schnet", "molecule"),
             ("nequip", "molecule"))


def gnn_batch(arch_id: str, shape_name: str, seed: int = 0) -> dict:
    """A batch of the smoke cell's shapes (numpy) with real graph
    structure: random edges among the real nodes, the padded ones to the
    ghost node N, sorted graph ids with the padded nodes in the ghost graph
    G, species ids in [0, 10) for the molecular models, random features,
    positions and targets."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    arch = get_arch(arch_id)
    shape = steps.smoke_shapes(arch)[shape_name]
    spec = steps._gnn_batch_spec(arch_id, shape)
    rng = np.random.default_rng(seed)
    n, e = spec["pos"][0][0], spec["senders"][0][0]
    real_n = shape.get("n_nodes", shape.get("pad_nodes"))
    real_n = min(real_n, n - 8)   # leave padded nodes in every case
    real_e = e - 16
    g = shape["n_graphs"]
    b = {"senders": np.full(e, n, np.int32),
         "receivers": np.full(e, n, np.int32)}
    b["senders"][:real_e] = rng.integers(0, real_n, real_e)
    b["receivers"][:real_e] = rng.integers(0, real_n, real_e)
    gid = np.full(n, g, np.int32)
    gid[:real_n] = np.sort(rng.integers(0, g, real_n))
    b["graph_id"] = gid
    b["pos"] = rng.standard_normal((n, 3), dtype=np.float32)
    feat = spec["node_feat"][0]
    b["node_feat"] = (rng.integers(0, 10, feat).astype(np.float32)
                      if feat[1] == 1 else
                      rng.standard_normal(feat, dtype=np.float32))
    if "energy" in spec:
        b["energy"] = rng.standard_normal(g, dtype=np.float32)
    elif "labels" in spec:
        b["labels"] = rng.integers(0, arch.smoke.n_classes, n).astype(
            np.int32)
    else:
        b["target"] = rng.standard_normal((n, 2), dtype=np.float32)
    return b


def model_cell(arch_id: str, shape_name: str, mesh=None):
    """The smoke cell of ``arch_id`` at ``shape_name`` on the CPU (with
    ``mesh``, its specs); a GNN cell's batch is :func:`gnn_batch`."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    cell = steps.build_cell(get_arch(arch_id), shape_name, "cpu",
                            smoke=True, mesh=mesh)
    if "n_graphs" not in cell.meta:
        return cell
    batch = {k: torch.from_numpy(v) for k, v in
             gnn_batch(arch_id, shape_name).items()}
    return cell._replace(args=cell.args[:2] + (steps.with_edge_plan(
        batch, cell.meta["n_graphs"]),))


def run_cell(cell, mesh=None):
    """One step of ``cell`` (sharded on ``mesh`` when given), its outputs
    gathered as numpy (:func:`cell_outputs`)."""
    from repro_torch.launch import steps

    if mesh is None:
        return cell_outputs(cell, cell.step_fn(*cell.args))
    return cell_outputs(cell, steps.sharded_step(cell, mesh)(
        *steps.sharded_args(cell, mesh)))


def cell_outputs(cell, res):
    """A step's outputs ``res`` gathered as numpy: a train cell's
    parameters after the step, loss and grad_norm; a serve cell's
    scores."""
    from repro_torch import tree
    from repro_torch.launch import sharding as sh

    res = sh.full(res)
    if cell.meta["kind"] == "train":
        res = {"params": res[0], "loss": res[2]["loss"],
               "grad_norm": res[2]["grad_norm"]}
    return tree.tree_map(_numpy, res)


def fm_gnn_world(rank: int, world: int, device, job: dict) -> dict:
    """Each cell of FM_CELLS and GNN_CELLS on a (2, 2) ("data", "model")
    mesh through ``steps.sharded_step``; the FM and MeshGraphNet train
    steps' parameters and optimizer state saved from the mesh to
    ``job["ckpt"]`` and restored onto it and onto a (4, 1) mesh (whether
    each leaf comes back with the target's placements and the saved
    values).  Rank 0 returns the gathered outputs as numpy; every rank
    its regions and collectives."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import tree
    from repro_torch.dist import regions
    from repro_torch.launch import lm_sharded, steps
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.train import checkpoint as ckpt

    torch.set_num_threads(1)   # four ranks beside the test workers
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    other = compat_make_mesh((4, 1), ("data", "model"))
    out, restored = {}, []
    regions.region_calls.clear()
    with CommDebugMode() as comm:
        for arch_id, shape in FM_CELLS + GNN_CELLS:
            cell = model_cell(arch_id, shape, mesh)
            args = steps.sharded_args(cell, mesh)
            res = steps.sharded_step(cell, mesh)(*args)
            if shape in ("train_batch", "full_graph_sm"):
                d = f"{job['ckpt']}/{arch_id}"
                ckpt.save(d, 1, {"params": res[0], "opt": res[1]})
                on_other = steps.sharded_args(
                    model_cell(arch_id, shape, other), other)
                for target in (res[:2], on_other[:2]):
                    want = {"params": target[0], "opt": target[1]}
                    back = ckpt.restore(d, 1, want)
                    restored.append(all(
                        tuple(b.placements) == tuple(t.placements) and
                        torch.equal(b.full_tensor(), a.full_tensor())
                        for a, t, b in zip(tree.leaves(res[0]),
                                           tree.leaves(target[0]),
                                           tree.leaves(back["params"]))))
            full = cell_outputs(cell, res)
            if rank == 0:
                out[f"{arch_id}/{shape}"] = full
    out["restored_on_mesh"] = restored
    out["regions"] = dict(regions.region_calls)
    out["collectives"] = lm_sharded.collective_counts(comm)
    return out


def host_group_world(rank: int, world: int, device, job: dict) -> dict:
    """The group of the world (``job["backend"]``) on CPU tensors: with
    ``job["forms"]``, each collective form it carries against the values
    it must give, a form it does not carry (send), and the four
    redistributions of ``lm_sharded.PROBES``; then one step of the FM
    ``train_batch`` smoke cell on a (2, 2) mesh (rank 0 returns its
    outputs as numpy)."""
    import torch.distributed as dist

    from repro_torch.launch import lm_sharded
    from repro_torch.launch.mesh import compat_make_mesh

    torch.set_num_threads(1)   # four ranks beside the test workers
    out = {"backend": dist.get_backend()}
    if job.get("forms"):
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
        every = torch.cat([torch.arange(6, dtype=torch.float32).reshape(2, 3)
                           + 10 * r for r in range(world)])
        got = {}
        g = torch.empty(2 * world, 3)
        dist.all_gather_into_tensor(g, x)
        got["all_gather_into_tensor"] = torch.equal(g, every)
        parts = [torch.empty(2, 3) for _ in range(world)]
        dist.all_gather(parts, x)
        got["all_gather"] = torch.equal(torch.cat(parts), every)
        rs = torch.empty(2, 3)
        dist.reduce_scatter_tensor(rs, every + rank)
        got["reduce_scatter_tensor"] = torch.equal(
            rs, world * every[2 * rank:2 * rank + 2] + sum(range(world)))
        # rank r sends r + 1 rows to every rank: uneven splits
        a = torch.full((world * (rank + 1),), float(rank))
        b = torch.empty(sum(r + 1 for r in range(world)))
        dist.all_to_all_single(b, a, [r + 1 for r in range(world)],
                               [rank + 1] * world)
        got["all_to_all_single"] = torch.equal(b, torch.cat(
            [torch.full((r + 1,), float(r)) for r in range(world)]))
        s = x.clone()
        dist.all_reduce(s)
        got["all_reduce"] = torch.equal(s, every.view(world, 2, 3).sum(0))
        c = x.clone()
        dist.broadcast(c, 1)
        got["broadcast"] = torch.equal(c, every[2:4])
        dist.barrier()
        try:
            dist.send(x, (rank + 1) % world)
            got["send_raises"] = False
        except NotImplementedError:
            got["send_raises"] = True
        out["forms"] = got
        out["probes"] = {k: lm_sharded.probe_job(rank, world, device,
                                                 k)["equal"]
                         for k in lm_sharded.PROBES}
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    res = run_cell(model_cell("fm", "train_batch", mesh), mesh)
    if rank == 0:
        out["fm"] = res
    return out
