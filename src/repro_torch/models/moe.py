"""Mixture-of-Experts FFN: shared + routed experts, top-k, sort-based dispatch
(counterpart of ``repro.models.moe``).

DeepSeek-V2-Lite / Moonlight family: ``n_shared`` always-active experts plus
``n_experts`` routed ones, top-k selection with gates normalised by their
sum.  Parameters are a dict in the reference's layout: ``router`` (d, E)
float32, ``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E, f, d), and
``shared`` {``w_gate``, ``w_up`` (d, n_shared f), ``w_down``}.

Dispatch is the reference's, step for step: flatten the (token, choice)
pairs, sort them by expert (stable), give each its slot within its expert,
drop the pairs past the static capacity, gather the kept tokens into a
dense (E, C, d) batch, run the expert FFN as batched products, and add the
gated outputs back in float32.  The reference computes all of it outside
any Pallas kernel; the port uses plain PyTorch indexing and ``torch.bmm``,
with the gather and the sum on ``models/gather.py``.  What has to match the
reference exactly:

* capacity ``max(1, int(capacity_factor * T * top_k / E))`` in Python,
  over all T tokens of a dispatch group (at decode with B = 4, E = 64,
  top_k = 6 that is 1: each expert takes one pair and the rest drop);
* the router in float32 on ``x.float()``; ``jax.lax.top_k`` puts the lower
  index first on ties, so the top k come from a stable descending sort;
* the slot tables are scatter-max / scatter-min / scatter-max, with dropped
  pairs aimed at the dummy slot (E-1, C-1) and token index T a zero row;
  max and min are order-free, so the tables are exact on any device;
* the output summed in float32, the shared experts added in float32, one
  cast at the end.  The sum of at most top_k + 1 terms a row runs in
  another order than XLA's scatter-add (float32 roundings only): the
  dispatch gather and the combine go through ``models/gather.py`` on one
  sorted index, so the combine's sum and the gather's gradient are
  segment_reduce sums in a fixed order, and a step repeats bit for bit on
  the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.gather import (
    SortedIndex, gather_nodes, scatter_sum, sorted_index,
)
from repro_torch.models.layers import dense_init


def moe_init(gen: torch.Generator, d_model: int, d_expert: int,
             n_experts: int, n_shared: int, dtype=torch.bfloat16,
             lead: tuple = ()):
    """The reference's ``moe_init``: one draw of each expert matrix,
    repeated over all E experts (so every routed expert starts equal);
    ``lead`` prepends axes (the stacked layer axis)."""
    def repeated(d_in, d_out):
        w = dense_init(gen, d_in, d_out, dtype, lead=lead)
        return w.unsqueeze(len(lead)).expand(
            *lead, n_experts, d_in, d_out).contiguous()

    p = {
        "router": dense_init(gen, d_model, n_experts, torch.float32,
                             lead=lead),
        "w_gate": repeated(d_model, d_expert),
        "w_up": repeated(d_model, d_expert),
        "w_down": repeated(d_expert, d_model),
    }
    if n_shared > 0:
        f = n_shared * d_expert
        p["shared"] = {
            "w_gate": dense_init(gen, d_model, f, dtype, lead=lead),
            "w_up": dense_init(gen, d_model, f, dtype, lead=lead),
            "w_down": dense_init(gen, f, d_model, dtype, lead=lead),
        }
    return p


def route(params, x, top_k: int):
    """x (T, d) -> (probs (T, E), gate values (T, K), expert ids (T, K)):
    the router in float32, the top k of a stable descending sort (lower
    expert index first on ties), gates normalised by their sum."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return probs, vals / vals.sum(dim=-1, keepdim=True), idx


def _dispatch(router, x, top_k: int, capacity_factor: float, g: int):
    """The dispatch of x (T, d) in ``g`` groups: (aux loss, the gate
    weights of the (E, C) slots (g, E C) float32, the slots' token rows in
    the groups' (T / g + 1)-row blocks (g E C,) long)."""
    t, _ = x.shape
    e = router.shape[1]
    tl = t // g
    probs, gate_vals, gate_idx = route({"router": router}, x, top_k)

    me = probs.mean(dim=0)
    # one_hot by comparison: F.one_hot reads the ids' range back to the
    # host on real tensors (and not on fake ones), a sync and other ops
    ce = (gate_idx[..., None] == torch.arange(e, device=x.device)).float() \
        .sum(1).mean(dim=0) / top_k
    aux = e * torch.sum(me * ce)

    cap = max(1, int(capacity_factor * tl * top_k / e))
    dev = x.device
    n = tl * top_k
    flat_e = gate_idx.reshape(g, n)
    flat_t = torch.arange(tl, device=dev).repeat_interleave(top_k) \
        .expand(g, n)
    flat_w = gate_vals.reshape(g, n)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    stok = flat_t.gather(1, order)
    sw = flat_w.gather(1, order)
    # slot of each pair within its expert: its rank from the expert's first
    pos = torch.arange(n, device=dev).expand(g, n)
    isfirst = torch.ones_like(se, dtype=torch.bool)
    isfirst[:, 1:] = se[:, 1:] != se[:, :-1]
    grp_start = torch.zeros((g, e), dtype=torch.long, device=dev) \
        .scatter_reduce(1, se, torch.where(isfirst, pos, 0), "amax",
                        include_self=True)
    slot = pos - grp_start.gather(1, se)
    keep = slot < cap
    # (E, C) tables of each group; dropped pairs aim at the dummy slot
    # (E-1, C-1), unfilled slots index token tl (a zero row)
    cell = torch.where(keep, se * cap + slot, e * cap - 1)
    idx = torch.full((g, e * cap), tl, dtype=torch.long, device=dev) \
        .scatter_reduce(1, cell, torch.where(keep, stok, tl), "amin",
                        include_self=True)
    wtbl = torch.zeros((g, e * cap), dtype=torch.float32, device=dev) \
        .scatter_reduce(1, cell, torch.where(keep, sw, 0.0), "amax",
                        include_self=True)
    flat = (idx + torch.arange(g, device=dev)[:, None] * (tl + 1)).reshape(-1)
    return aux, wtbl, flat


class _Fanout(torch.autograd.Function):
    """``n`` uses of one tensor whose gradients are summed in the order of
    the uses (autograd would add them in the order its nodes run, which a
    sharded step's extra nodes change)."""

    @staticmethod
    def forward(ctx, x, n: int):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                total = g if total is None else total + g
        return total, None


def moe_apply(params, x, *, top_k: int, capacity_factor: float = 1.25,
              groups: int = 0):
    """x (T, d) -> (out (T, d) in x's dtype, aux_loss float32 scalar).

    ``groups`` > 1 splits the tokens into G dispatch groups of T / G tokens
    (the reference's ``_moe_apply_grouped``): capacity, slots and drops are
    per group.  The Switch-style aux loss averages over all T tokens either
    way.

    On DTensors (a sharded step) the tokens are gathered and every rank
    runs the whole dispatch (the ``moe_dispatch`` region: top-k, argsort,
    scatter max/min), so capacity and drops are the one-device ones.  The
    experts are sharded over "model" (``constrain`` at the reference's
    sites): each rank gathers the rows of its own experts' slots
    (``moe_experts``) and sums its experts' weighted outputs into the
    tokens (``moe_combine``), each by its own sorted index; the sum over
    the experts' ranks is a ``Partial``.
    """
    from repro_torch.dist import regions
    from repro_torch.dist.constrain import constrain

    t, d = x.shape
    e = params["router"].shape[1]
    g = groups if groups > 1 else 1
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    tl = t // g
    rows = g * (tl + 1)   # the groups' (tl + 1)-row blocks, a zero row each
    x, x_in = _Fanout.apply(x, 2) if "shared" in params and \
        torch.is_grad_enabled() and x.requires_grad else (x, x)
    sharded = regions.is_dtensor(x)
    if sharded:
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        rep = [Replicate()] * mesh.ndim
        x = regions.to(x, rep)
        aux, wtbl, flat = regions.run(
            "moe_dispatch",
            lambda xl, rl: _dispatch(rl, xl, top_k, capacity_factor, g),
            mesh, (x, regions.to(params["router"], rep)), (rep, rep),
            (rep, rep, rep))
        flat = flat.to_local()
    else:
        aux, wtbl, flat = _dispatch(params["router"], x, top_k,
                                    capacity_factor, g)
    cap = wtbl.shape[1] // e
    xz = torch.cat([x.reshape(g, tl, d), x.new_zeros((g, 1, d))], 1) \
        .reshape(rows, d)
    if sharded:
        xe = _sharded_experts(xz, flat, g, e, cap)
    else:
        # one sorted index serves the gather, its gradient and the combine
        index = sorted_index(flat, rows, counts=False)
        xe = _expert_rows(xz, index, g, e, cap)
    xe = constrain(xe, "model", None, None)
    hg = constrain(torch.bmm(xe, params["w_gate"]), "model", None, None)
    hu = constrain(torch.bmm(xe, params["w_up"]), "model", None, None)
    y = constrain(torch.bmm(F.silu(hg) * hu, params["w_down"]),
                  "model", None, None)                          # (E, G C, d)
    if sharded:
        out = _sharded_combine(y, wtbl, flat, g, e, cap, rows)
    else:
        out = _combine(y, wtbl, index, g, cap, rows)
    out = out.reshape(g, tl + 1, d)[:, :tl].reshape(t, d)

    if "shared" in params:
        sp = params["shared"]
        gs = constrain(x_in @ sp["w_gate"], "batch", "model")
        us = constrain(x_in @ sp["w_up"], "batch", "model")
        out = out + constrain((F.silu(gs) * us) @ sp["w_down"],
                              "batch", None).float()
    return out.to(x.dtype), aux


def _expert_rows(xz, index: SortedIndex, g: int, ne: int, cap: int):
    """The token rows of ``ne`` experts' slots (E, G C, d), gathered by
    ``index`` from xz (the groups' rows)."""
    d = xz.shape[1]
    return gather_nodes(xz, index).reshape(g, ne, cap, d).transpose(0, 1) \
        .reshape(ne, g * cap, d)


def _combine(y, wtbl, index: SortedIndex, g: int, cap: int, rows: int):
    """The experts' outputs y (E, G C, d) weighted by their slots' gates
    wtbl (G, E C) and summed into the groups' rows by ``index``
    (float32)."""
    ne, _, d = y.shape
    yw = y.reshape(ne, g, cap, d).transpose(0, 1).reshape(g * ne * cap, d) \
        .float() * wtbl.reshape(-1, 1)
    return scatter_sum(yw, index, rows)


def _expert_layouts(mesh):
    """(experts over "model", a sum over "model") placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = mesh.mesh_dim_names
    return ([Shard(0) if n == "model" else Replicate() for n in names],
            [Partial() if n == "model" else Replicate() for n in names])


def _own_slots(mesh, e_pl, flat, g: int, e: int, cap: int):
    """This rank's experts [e0, e1) and the token rows of their slots."""
    from repro_torch.dist import regions

    e0, e1 = regions.shard_range(mesh, e_pl, 0, e)
    return e0, e1, flat.reshape(g, e, cap)[:, e0:e1].reshape(-1)


def _sharded_experts(xz, flat, g: int, e: int, cap: int):
    """The ``moe_experts`` region: each rank gathers the rows of its own
    experts' slots from the replicated tokens xz; xz's gradient is each
    rank's share of a sum over "model"."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import regions

    mesh = xz.device_mesh
    e_pl, p_pl = _expert_layouts(mesh)
    rep = [Replicate()] * mesh.ndim

    def local(xl):
        e0, e1, slots = _own_slots(mesh, e_pl, flat, g, e, cap)
        return _expert_rows(xl, sorted_index(slots, xl.shape[0],
                                             counts=False), g, e1 - e0, cap)

    return regions.run("moe_experts", local, mesh, (xz,), (rep,), e_pl,
                       (p_pl,), (e, g * cap, xz.shape[1]))


def _sharded_combine(y, wtbl, flat, g: int, e: int, cap: int, rows: int):
    """The ``moe_combine`` region: each rank sums its experts' weighted
    outputs into the tokens by its own sorted index; the output is the sum
    over "model" (``Partial``), as wtbl's gradient is."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import regions

    mesh = y.device_mesh
    e_pl, p_pl = _expert_layouts(mesh)
    rep = [Replicate()] * mesh.ndim
    y = regions.to(y, e_pl)

    def local(yl, wl):
        e0, e1, slots = _own_slots(mesh, e_pl, flat, g, e, cap)
        w = wl.reshape(g, e, cap)[:, e0:e1]
        return _combine(yl, w, sorted_index(slots, rows, counts=False), g,
                        cap, rows)

    return regions.run("moe_combine", local, mesh, (y, wtbl), (e_pl, rep),
                       p_pl, (e_pl, p_pl), (rows, y.shape[2]))
