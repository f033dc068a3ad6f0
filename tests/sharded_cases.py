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
    """Every case of FLASH_CASES and SEGMENT_CASES on DTensors; rank 0
    returns the full results as numpy."""
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
    for name, dt, rows, vocab in SEGMENT_CASES:
        a = segment_inputs(dt)
        pl = (Shard(0) if rows else Replicate(), Replicate())
        want = (Replicate(), Shard(0) if vocab else Replicate())
        got = sr.segment_sum_sorted(dist(a["data"], mesh, *pl),
                                    dist(a["ids"], mesh, *pl),
                                    SEGMENT_SHAPE["s"], out_placements=want)
        full = got.full_tensor().numpy()
        if rank == 0:
            out[name] = (full, [type(p).__name__ + (
                f"({p.dim})" if hasattr(p, "dim") else "")
                for p in got.placements])
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
            cell = lm_sharded.lm_cell(job["arch"], shape, device, mesh,
                                      tuning=tuning, params=job["params"])
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
