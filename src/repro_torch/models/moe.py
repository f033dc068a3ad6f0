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

from repro_torch.models.gather import gather_nodes, scatter_sum, sorted_index
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


def moe_apply(params, x, *, top_k: int, capacity_factor: float = 1.25,
              groups: int = 0):
    """x (T, d) -> (out (T, d) in x's dtype, aux_loss float32 scalar).

    ``groups`` > 1 splits the tokens into G dispatch groups of T / G tokens
    (the reference's ``_moe_apply_grouped``): capacity, slots and drops are
    per group.  The Switch-style aux loss averages over all T tokens either
    way.
    """
    t, d = x.shape
    e = params["router"].shape[1]
    g = groups if groups > 1 else 1
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    tl = t // g
    probs, gate_vals, gate_idx = route(params, x, top_k)

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
    # one sorted index over the groups' (tl + 1)-row blocks serves the
    # gather, its gradient and the combine
    rows = g * (tl + 1)
    flat = (idx + torch.arange(g, device=dev)[:, None] * (tl + 1)).reshape(-1)
    index = sorted_index(flat, rows, counts=False)
    xz = torch.cat([x.reshape(g, tl, d), x.new_zeros((g, 1, d))], 1)
    xe = gather_nodes(xz.reshape(rows, d), index) \
        .reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(torch.bmm(xe, params["w_gate"])) \
        * torch.bmm(xe, params["w_up"])
    y = torch.bmm(h, params["w_down"])                          # (E, G C, d)
    yw = y.reshape(e, g, cap, d).transpose(0, 1).reshape(g * e * cap, d) \
        .float() * wtbl.reshape(-1, 1)
    out = scatter_sum(yw, index, rows).reshape(g, tl + 1, d)
    out = out[:, :tl].reshape(t, d)

    if "shared" in params:
        sp = params["shared"]
        hs = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        out = out + (hs @ sp["w_down"]).float()
    return out.to(x.dtype), aux
