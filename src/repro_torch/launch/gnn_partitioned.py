"""Partition-aware distributed MeshGraphNet training on ``torch.distributed``
(counterpart of ``repro.launch.gnn_partitioned``).

Layout, built on the host from a Jet partition (:func:`build_partitioned_batch`):
each rank owns a contiguous block of ``n_l`` node slots; every edge lives on
its receiver's rank (``e_cap`` edge slots a rank); a sender is either a local
slot or a halo slot ``n_l + r * h_cap + s``, the ``s``-th boundary vertex
that rank ``r`` exports.  Each rank runs one process.  Per message-passing
layer it exports its boundary rows once, one all-gather of the ranks'
``(h_cap, F)`` blocks (:class:`Exchange`), and aggregates locally, where the
naive layout needs a full-node all-gather and an all-reduce:

    naive       : N*F (gather) + N*F (reduce)        = 2*N*F
    partitioned : D*h_cap*F gathered by every rank   (~ halo_frac * N * F)

so the partitioner's cut quality IS the communication bill.

The reference runs the step under ``shard_map``; here every rank runs
:func:`make_step` on its own block.  The exchange is an autograd function
whose backward is its transpose: the sum over ranks of each rank's block
(``reduce_scatter_tensor`` on NCCL; an all-reduce and this rank's block on
gloo, which has no reduce-scatter).  Every row gather and the local sum by
receiver go through ``models/gather.py`` (sorted indices built once a batch,
:func:`with_local_plan`), so the sums and every gather's gradient run on
segment_reduce in a fixed order.  Each processor block runs under
``torch.utils.checkpoint``; its recompute repeats the exchange on every rank
in the same order.

The loss is ``psum(se) / max(psum(cnt), 1)``.  The reference's gradient is
the dense model's gradient, so each rank back-propagates its own
``se / cnt_total`` (the denominator taken without a gradient) and the
parameter gradients are summed over ranks before AdamW; back-propagating
the all-reduced loss on every rank would give D times that.

Backends are chosen explicitly (:func:`init_rank`): NCCL on the card, gloo
on the CPU, and gloo on the card where the caller names it (NCCL refuses two
ranks on one GPU).  Implemented for meshgraphnet, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.steps import (
    SEED, Cell, _pad512, gnn_model_flops, materialize,
)
from repro_torch.models.gather import SortedIndex, gather_nodes, \
    scatter_sum, sorted_index
from repro_torch.models.gnn import meshgraphnet
from repro_torch.models.gnn.common import layer, mlp_apply
from repro_torch.optim import adamw


def _sizes(shape, world: int, halo_frac: float):
    n = _pad512(shape.get("n_nodes", shape.get("pad_nodes")))
    e = _pad512(shape.get("n_edges", shape.get("pad_edges")))
    n_l = n // world
    e_l = e // world
    h_cap = max(8, int(round(halo_frac * n_l / 8)) * 8)
    return n, e, world, n_l, e_l, h_cap


def partitioned_batch_spec(shape, world: int, halo_frac: float,
                           d_feat: int) -> dict:
    """name -> (shape, dtype) of the global batch over ``world`` ranks."""
    n, e, d, n_l, e_l, h_cap = _sizes(shape, world, halo_frac)
    return {
        "node_feat": ((n, d_feat), torch.float32),
        "pos": ((n, 3), torch.float32),
        "target": ((n, 2), torch.float32),
        # local sender index in [0, n_l + d*h_cap]  (ghost = n_l + d*h_cap)
        "senders": ((e,), torch.int32),
        # local receiver index in [0, n_l]          (ghost = n_l)
        "receivers": ((e,), torch.int32),
        # per-rank boundary export list (local indices)
        "halo_send": ((d * h_cap,), torch.int32),
        "valid_edge": ((e,), torch.float32),
        "valid_node": ((n,), torch.float32),
    }


def _within_group(keys: np.ndarray, k: int) -> np.ndarray:
    """The position of each element among the elements with its key, in
    array order (keys in [0, k))."""
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=k)
    pos = np.empty(keys.size, np.int64)
    pos[order] = np.arange(keys.size) - (np.cumsum(counts) - counts)[
        keys[order]]
    return pos


def build_partitioned_batch(n, feats, pos, target, edges, parts, k,
                            n_l, e_cap_total, h_cap):
    """Host-side layout builder: a partition -> the ranks' arrays.

    ``edges`` (E, 2) directed (sender, receiver); each edge is owned by its
    receiver's rank.  Returns (batch, stats): the numpy arrays of
    :func:`partitioned_batch_spec` over ``k`` ranks, and the drop counts
    (``dropped_edges``: edges beyond a rank's ``e_cap`` or whose sender has
    no halo slot; ``dropped_halo``: boundary vertices beyond ``h_cap``).

    Bit for bit the reference's loop, vectorised: vertices take their
    rank's slots in the order of a stable sort by part; exports in
    ``np.unique`` order, ``h_cap`` a rank; edges in input order up to
    ``e_cap`` a rank.  An edge whose sender has no export slot is dropped
    after the reference has written its receiver into the rank's next slot,
    so that slot keeps a real receiver with ``valid_edge`` 0 unless a later
    edge takes it.
    """
    if isinstance(parts, torch.Tensor):
        parts = parts.cpu().numpy()
    dev_of = np.asarray(parts)[:n].astype(np.int64)
    if dev_of.size and (dev_of.min() < 0 or dev_of.max() >= k):
        raise ValueError("parts must lie in [0, k)")
    counts = np.bincount(dev_of, minlength=k)
    if counts.max(initial=0) > n_l:
        raise ValueError(f"a part holds {counts.max()} vertices > n_l {n_l}")
    slot_of = _within_group(dev_of, k)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    src, dst = edges[:, 0], edges[:, 1]
    # per-rank exports: boundary vertices that other ranks reference
    remote = dev_of[src] != dev_of[dst]
    exported = np.unique(src[remote])
    x_dev = dev_of[exported]
    x_slot = _within_group(x_dev, k)
    kept = x_slot < h_cap
    dropped_halo = int((~kept).sum())
    halo_of = np.full(n, -1, np.int64)
    halo_of[exported[kept]] = x_slot[kept]
    halo_send = np.zeros((k, h_cap), np.int64)
    halo_send[x_dev[kept], x_slot[kept]] = slot_of[exported[kept]]
    # per-rank edge lists: an edge is placed if its sender is local or
    # exported, in input order, while its rank has room
    e_cap = e_cap_total // k
    e_dev = dev_of[dst]
    placeable = ~remote | (halo_of[src] >= 0)
    pi = np.flatnonzero(placeable)
    p_dev = e_dev[pi]
    p_slot = _within_group(p_dev, k)
    fits = p_slot < e_cap
    ei, ed, ej = pi[fits], p_dev[fits], p_slot[fits]
    senders = np.full((k, e_cap), n_l + k * h_cap, np.int64)
    receivers = np.full((k, e_cap), n_l, np.int64)
    valid_e = np.zeros((k, e_cap), np.float32)
    u = src[ei]
    senders[ed, ej] = np.where(remote[ei], n_l + dev_of[u] * h_cap
                               + halo_of[u], slot_of[u])
    receivers[ed, ej] = slot_of[dst[ei]]
    valid_e[ed, ej] = 1.0
    # the receiver written by the last unplaceable edge after a rank's last
    # placed edge stays in the rank's next slot (if it has one)
    fill = np.minimum(np.bincount(p_dev, minlength=k), e_cap)
    last_placed = np.full(k, -1, np.int64)
    np.maximum.at(last_placed, ed, ei)
    bad = np.flatnonzero(~placeable)
    late = bad > last_placed[e_dev[bad]]
    last_bad = np.full(k, -1, np.int64)
    np.maximum.at(last_bad, e_dev[bad[late]], bad[late])
    resid = np.flatnonzero((last_bad >= 0) & (fill < e_cap))
    receivers[resid, fill[resid]] = slot_of[dst[last_bad[resid]]]
    # node arrays in rank-block layout
    feats, pos, target = (np.asarray(a) for a in (feats, pos, target))
    nodes = {}
    for name, a in (("node_feat", feats), ("pos", pos), ("target", target)):
        out = np.zeros((k, n_l, a.shape[1]), np.float32)
        out[dev_of, slot_of] = a[:n]
        nodes[name] = out.reshape(k * n_l, -1)
    vn = np.zeros((k, n_l), np.float32)
    vn[dev_of, slot_of] = 1.0
    batch = {
        **nodes,
        "senders": senders.reshape(-1).astype(np.int32),
        "receivers": receivers.reshape(-1).astype(np.int32),
        "halo_send": halo_send.reshape(-1).astype(np.int32),
        "valid_edge": valid_e.reshape(-1),
        "valid_node": vn.reshape(-1),
    }
    stats = {"dropped_edges": int(edges.shape[0] - ei.size),
             "dropped_halo": dropped_halo}
    return batch, stats


def layout_sizes(n: int, edges, parts, k: int, align: int = 512) -> dict:
    """Capacities that drop nothing for this partition: ``n_l`` >= the
    largest part and ``e_cap`` >= the most edges a rank receives, each
    rounded up to ``align`` (so that ``k * n_l`` and ``k * e_cap`` survive
    the cells' padding to 512), and ``h_cap`` >= the most boundary vertices
    a rank exports (a multiple of 8, at least 8).  ``halo_frac`` is the
    cell's tuning value that gives that ``h_cap``, and ``halo_rows`` the
    exports of each rank."""
    if isinstance(parts, torch.Tensor):
        parts = parts.cpu().numpy()
    dev_of = np.asarray(parts)[:n].astype(np.int64)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    src, dst = edges[:, 0], edges[:, 1]
    remote = dev_of[src] != dev_of[dst]
    halo = np.bincount(dev_of[np.unique(src[remote])], minlength=k)

    def up(x, a):
        return max(a, -(-int(x) // a) * a)

    n_l = up(np.bincount(dev_of, minlength=k).max(), align)
    e_cap = up(np.bincount(dev_of[dst], minlength=k).max(), align)
    h_cap = up(halo.max(initial=0), 8)
    return {"n_l": n_l, "e_cap": e_cap, "h_cap": h_cap,
            "halo_frac": h_cap / n_l, "halo_rows": halo.tolist()}


class LocalPlan(NamedTuple):
    """A rank's sorted indices, built once a batch."""

    senders: SortedIndex    # into the n_l + D*h_cap exchanged rows
    receivers: SortedIndex  # into the n_l local rows
    halo: SortedIndex       # the exported rows, into the n_l local rows


def rank_block(batch: dict, rank: int, world: int, device="cpu") -> dict:
    """Rank ``rank``'s block of a global batch (numpy arrays or tensors):
    node rows ``[r*n_l, (r+1)*n_l)``, edges ``[r*e_cap, ...)``, halo
    ``[r*h_cap, ...)``, as tensors on ``device``."""
    out = {}
    for name in ("node_feat", "pos", "target", "senders", "receivers",
                 "halo_send", "valid_edge", "valid_node"):
        a = batch[name]
        m = a.shape[0] // world
        out[name] = torch.as_tensor(a[rank * m:(rank + 1) * m]).to(device)
    return out


def with_local_plan(b: dict, world: int) -> dict:
    """The block with its sorted indices (``"plan"``): every step over it
    reuses them."""
    n_l, h_cap = b["node_feat"].shape[0], b["halo_send"].shape[0]
    return {**b, "plan": LocalPlan(
        sorted_index(b["senders"], n_l + world * h_cap, counts=False),
        sorted_index(b["receivers"], n_l, counts=False),
        sorted_index(b["halo_send"], n_l, counts=False))}


# ---------------------------------------------------------------------------
# ranks and the exchange
# ---------------------------------------------------------------------------

def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda`` means card ``rank`` modulo the
    cards there are (all ranks on card 0 of a one-card machine)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, port: int, device, backend=None,
              timeout_s: float = 120.0, log=print) -> str:
    """Initialise the default group for this rank over
    ``tcp://localhost:<port>``.  ``backend`` None takes NCCL for a CUDA
    device and gloo for the CPU; NCCL with more ranks than cards raises
    (name gloo to put several ranks on one card).  Rank 0 prints the
    choice.  Returns the backend."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    named = backend is not None
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL needs CUDA devices; use gloo on the CPU")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"NCCL refuses two ranks on one GPU ({world} ranks, "
                f"{torch.cuda.device_count()} cards): name backend='gloo'")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=timedelta(seconds=timeout_s))
    if rank == 0:
        how = "named by the caller" if named else \
            f"the default for {device.type}"
        if backend == "gloo" and device.type == "cuda":
            how += "; gloo copies CUDA tensors through host memory"
        log(f"[gnn_partitioned] {world} rank(s) on {device.type}, backend "
            f"{backend} ({how})", flush=True)
    return backend


class Exchange:
    """Collectives of one rank of a group: the boundary all-gather, its
    transpose and the all-reduce of sums.  Gloo takes CUDA tensors as they
    are (it copies them through host memory itself)."""

    def __init__(self, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "the partitioned mode needs an initialised process group "
                "(torch.distributed.init_process_group, or init_rank): it "
                "will not run one rank quietly")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)

    def all_gather(self, x):
        """(h, F) on every rank -> (world * h, F), rank r's rows at
        [r*h, (r+1)*h)."""
        x = x.contiguous()
        out = x.new_empty((self.world * x.shape[0],) + x.shape[1:])
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:
            dist.all_gather(list(out.chunk(self.world)), x,
                            group=self.group)
        return out

    def reduce_block(self, g):
        """(world * h, F) on every rank -> (h, F): the sum over ranks of
        this rank's block (the all-gather's transpose)."""
        h = g.shape[0] // self.world
        if self.backend == "nccl":
            src = g.contiguous()
            out = src.new_empty((h,) + src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=self.group)
            return out
        src = g.clone()
        dist.all_reduce(src, group=self.group)
        return src[self.rank * h:(self.rank + 1) * h]

    def all_reduce_(self, x):
        """Sum ``x`` over the ranks, in place."""
        dist.all_reduce(x, group=self.group)
        return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return ex.all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ex.reduce_block(grad), None


def exchange(x, plan: LocalPlan, ex: Exchange):
    """(n_l, F) -> (n_l + D*h_cap, F): the local rows, then every rank's
    exported rows (the ghost index n_l + D*h_cap reads a zero row)."""
    return torch.cat([x, _AllGather.apply(gather_nodes(x, plan.halo), ex)])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _block(blk, h, e, plan: LocalPlan, v_e, ex: Exchange):
    hs = gather_nodes(exchange(h, plan, ex), plan.senders)
    hr = gather_nodes(h, plan.receivers)
    e = e + mlp_apply(blk["edge"], torch.cat([e, hs, hr], -1),
                      act=F.relu) * v_e
    agg = scatter_sum(e, plan.receivers, h.shape[0])
    h = h + mlp_apply(blk["node"], torch.cat([h, agg], -1), act=F.relu)
    return h, e


def local_sums(cfg, params, b: dict, ex: Exchange):
    """This rank's (squared error, count) of the loss over its block."""
    plan = b["plan"]
    v_e = b["valid_edge"][:, None]
    v_n = b["valid_node"][:, None]
    pos = b["pos"]
    # edge geometry: receiver-local pos minus (possibly remote) sender pos
    rel = (gather_nodes(pos, plan.receivers)
           - gather_nodes(exchange(pos, plan, ex), plan.senders)) * v_e
    dist_ = torch.linalg.vector_norm(rel + 1e-12, dim=-1,
                                     keepdim=True) * v_e
    efeat = torch.cat([rel, dist_], -1)
    h = mlp_apply(params["enc_n"], b["node_feat"], act=F.relu)
    e = mlp_apply(params["enc_e"], efeat, act=F.relu) * v_e
    for i in range(cfg.n_layers):
        h, e = checkpoint(_block, layer(params["blocks"], i), h, e, plan,
                          v_e, ex, use_reentrant=False,
                          preserve_rng_state=False)
    pred = mlp_apply(params["dec"], h, act=F.relu)
    se = torch.sum(((pred - b["target"]) ** 2) * v_n)
    return se, torch.sum(v_n) * cfg.d_out


def value_and_grad(cfg, params, b: dict, ex: Exchange):
    """The loss over all ranks and its gradient (summed over ranks: the
    dense model's gradient), on every rank."""
    if "plan" not in b:
        b = with_local_plan(b, ex.world)
    live = tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
    se, cnt = local_sums(cfg, live, b, ex)
    total = ex.all_reduce_(torch.stack([se.detach(), cnt.detach()]))
    denom = torch.clamp(total[1], min=1.0)
    leaves = tree.leaves(live)
    grads = torch.autograd.grad(se / denom, leaves, allow_unused=True,
                                materialize_grads=True)
    flat = ex.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    sizes = [g.numel() for g in grads]
    grads = [x.view_as(p) for x, p in zip(flat.split(sizes), leaves)]
    return total[0] / denom, tree.unflatten(params, grads)


def make_step(cfg, ex: Exchange, opt_cfg: adamw.AdamWConfig | None = None):
    """This rank's train step (params, opt_state, block) -> (params,
    opt_state, {"loss", "grad_norm", "lr"}); every rank must run it."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, b):
        loss, grads = value_and_grad(cfg, params, b, ex)
        params, opt_state, om = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def _group_of(mesh):
    """The group whose ranks shard the batch: a 1-D mesh's, else the
    default group, which a mesh must then span."""
    if mesh is None:
        return None
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the group")
    return mesh.get_group() if mesh.ndim == 1 else None


def partitioned_gnn_cell(arch, shape_name, mesh=None, device=None,
                         smoke=False, tuning=None, params=None) -> Cell:
    """This rank's partitioned MeshGraphNet train cell.

    ``mesh`` (a DeviceMesh spanning the group, or None for the default
    group) plays the reference's mesh: its ranks shard the batch.  ``args``
    are the parameters (``init_params`` seeded with ``SEED`` on ``device``
    unless given), their AdamW state, and this rank's block of a global
    batch that ``steps.materialize`` fills from ``SEED``.  ``tuning``:
    ``halo_frac`` (default 0.25) sizes the halo slots.
    """
    if arch.id != "meshgraphnet":
        raise ValueError("partitioned mode: meshgraphnet only")
    ex = Exchange(_group_of(mesh))
    tuning = tuning or {}
    halo_frac = tuning.get("halo_frac", 0.25)
    device = resolve_device(device)
    cfg = arch.smoke if smoke else arch.config
    shape = arch.shapes[shape_name]
    cfg = dataclasses.replace(cfg, d_in=shape["d_feat"])
    n, e, world, n_l, e_l, h_cap = _sizes(shape, ex.world, halo_frac)
    if params is None:
        params = meshgraphnet.init_params(
            cfg, torch.Generator(device=device).manual_seed(SEED))
    spec = partitioned_batch_spec(shape, world, halo_frac, shape["d_feat"])
    batch = materialize({k: torch.empty(s, dtype=dt)
                         for k, (s, dt) in spec.items()}, SEED)
    block = with_local_plan(rank_block(batch, ex.rank, world, device), world)
    return Cell(
        step_fn=make_step(cfg, ex),
        args=(params, adamw.init_state(params), block),
        meta={
            "kind": "train",
            "param_count": cfg.param_count(),
            "active_param_count": cfg.param_count(),
            "model_flops": gnn_model_flops(arch.id, cfg, shape),
            "tokens": n,
            "mode": "partitioned",
            "halo_frac": halo_frac,
            "h_cap": h_cap,
            "n_l": n_l,
            "e_cap": e_l,
            "world": world,
            "rank": ex.rank,
            "backend": ex.backend,
        },
    )


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------

def _rank_main(rank, world, port, device, backend, timeout_s, fn, args, q):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dev = rank_device(device, rank)
        init_rank(rank, world, port, dev, backend, timeout_s)
        q.put((rank, True, fn(rank, world, dev, *args)))
    except Exception:  # the parent reports it and stops the others
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), *, device="cuda", backend=None,
                timeout_s: float = 600.0) -> list:
    """``fn(rank, world, device, *args)`` in ``world`` new processes, one a
    rank, each with the default group initialised (:func:`init_rank` on a
    free port; ``fn`` and ``args`` must pickle).  Returns the results by
    rank.  Raises as soon as a rank fails, or at ``timeout_s`` (rendezvous
    and collectives time out then too); every process is stopped before it
    returns or raises."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, port, str(device), backend, timeout_s, fn, args, q))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    results = {}
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results)} of {world} "
                                   f"ranks gave no result in {timeout_s} s")
            try:
                rank, ok, value = q.get(timeout=min(left, 2.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank process died ({dead[0]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        q.close()
    return [results[r] for r in range(world)]


def train_job(rank: int, world: int, device, job: dict) -> dict:
    """One rank of a partitioned training run (for :func:`spawn_ranks`).

    ``job``: ``layout`` (an ``.npz`` of :func:`build_partitioned_batch`'s
    arrays), ``cfg`` (an MGNConfig), ``halo_frac``, ``steps``; optional
    ``params`` (a ``torch.save``'d tree; default the cell's seeded
    parameters), ``repeat`` (run step 1 again and report whether it
    repeats bit for bit), ``return_params`` (rank 0 returns the
    parameters after step 1 as numpy arrays).  The cell comes from
    ``steps.build_cell(..., tuning={"mode": "partitioned"})``.
    """
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    with np.load(job["layout"]) as z:
        glob = {k: z[k] for k in z.files}
    n_l = glob["node_feat"].shape[0] // world
    shape = {"kind": "train", "n_nodes": world * n_l,
             "n_edges": glob["senders"].shape[0],
             "d_feat": glob["node_feat"].shape[1], "n_graphs": 1}
    arch = dataclasses.replace(get_arch("meshgraphnet"), config=job["cfg"],
                               shapes={"partitioned": shape})
    params = None
    if job.get("params"):
        params = torch.load(job["params"], map_location=device)
    cell = steps.build_cell(arch, "partitioned", device, params=params,
                            tuning={"mode": "partitioned",
                                    "halo_frac": job["halo_frac"]})
    if cell.meta["h_cap"] * world != glob["halo_send"].shape[0]:
        raise ValueError("the layout's h_cap is not the cell's")
    block = with_local_plan(rank_block(glob, rank, world, device), world)
    params, opt = cell.args[:2]
    out = {"loss": [], "grad_norm": [], "step_s": [], "segment_reduce": [],
           "meta": {k: v for k, v in cell.meta.items()}}
    p, o = params, opt
    for i in range(job.get("steps", 1)):
        synchronize(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        p, o, m = cell.step_fn(p, o, block)
        synchronize(device)
        out["step_s"].append(time.perf_counter() - t0)
        out["segment_reduce"].append(kernels.launch_counts["segment_reduce"])
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            first = (p, o, m)
    if job.get("repeat"):
        again = cell.step_fn(params, opt, block)
        out["repeats"] = all(
            torch.equal(a, b) for a, b in zip(
                tree.leaves(first[:2]) + [first[2]["loss"]],
                tree.leaves(again[:2]) + [again[2]["loss"]]))
    if job.get("return_params") and rank == 0:
        out["params"] = [x.cpu().numpy() for x in tree.leaves(first[0])]
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=1,
                    help="ranks, one process each (= parts of the mesh)")
    ap.add_argument("--mesh", type=int, default=64,
                    help="side of the synthetic mesh (mesh_batch)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (3 blocks, d 32), not the "
                         "published one (15 blocks, d 128)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, needs a card) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda, gloo on "
                         "the CPU; several ranks on one card need gloo)")
    args = ap.parse_args(argv)

    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.core.graph import build_csr_host
    from repro_torch.core.partition import PartitionConfig, partition
    from repro_torch.data import synthetic
    from repro_torch.dist import partition_aware as pa

    device = resolve_device(args.device)
    arch = get_arch("meshgraphnet")
    cfg = dataclasses.replace(arch.smoke if args.smoke else arch.config,
                              d_in=4)
    data = synthetic.mesh_batch(args.mesh, args.mesh, seed=0)
    graph = data["graph"]
    n = graph.node_feat.shape[0]
    edges = torch.stack([graph.senders, graph.receivers], 1).numpy()
    k = args.world
    if k > 1:
        g = build_csr_host(n, edges)
        res = partition(g, PartitionConfig(k=k, lam=0.05, backend="ell"),
                        device=device)
        parts = res.parts.cpu().numpy()[:n]
        cb = pa.comm_bytes_per_layer(pa.plan_from_partition(g, parts, k),
                                     cfg.d_hidden)
        print(f"partition k={k}: cut {res.cut}, imbalance "
              f"{res.imbalance:.4f}; per layer at d {cfg.d_hidden}: halo "
              f"{cb['partition_halo']} B against the naive "
              f"{cb['naive_allgather']} B")
    else:
        parts = np.zeros(n, np.int64)
    sz = layout_sizes(n, edges, parts, k)
    batch, stats = build_partitioned_batch(
        n, graph.node_feat.numpy(), graph.pos.numpy(),
        data["target"].numpy(), edges, parts, k, sz["n_l"],
        k * sz["e_cap"], sz["h_cap"])
    print(f"layout: n_l {sz['n_l']}, e_cap {sz['e_cap']}, h_cap "
          f"{sz['h_cap']} (halo rows {sz['halo_rows']}); dropped {stats}; "
          f"exchange {k * sz['h_cap'] * cfg.d_hidden * 4} B gathered per "
          "rank a layer")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "layout.npz")
        np.savez(path, **batch)
        out = spawn_ranks(train_job, k, ({
            "layout": path, "cfg": cfg, "halo_frac": sz["halo_frac"],
            "steps": args.steps},), device=device, backend=args.backend)
    r0 = out[0]
    for i, (l, gn, s) in enumerate(zip(r0["loss"], r0["grad_norm"],
                                       r0["step_s"])):
        print(f"step {i + 1}: loss {l:.6f}, grad_norm {gn:.6f}, {s:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
