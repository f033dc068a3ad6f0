"""Carry the JAX package's model parameters across to the port.

The reference's ``init_params`` returns pytrees of arrays; converted to
numpy (``jax.tree.map(np.asarray, params)``) they become the port's dicts
of tensors here.  The port keeps the reference's layouts — ``x @ w`` with
``w`` (d_in, d_out), per-layer weights stacked on a leading (L,) axis,
embedding tables (rows, D) — so no array is transposed: each is copied with
its dtype.  bfloat16 arrays (numpy's ``ml_dtypes`` type) are reinterpreted
bit for bit.  This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, device=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor with the
    same dtype and values."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def tree_to_tensors(tree, device=None):
    """Nested dicts and lists of arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_tensors(v, device) for v in tree]
    return to_tensor(tree, device)


def fm_params(np_params, device=None) -> dict:
    """``repro.models.recsys.fm.init_params`` output -> ``models/recsys/fm``
    parameters: ``table`` (V, D), ``linear`` (V,), ``bias`` ()."""
    return {k: to_tensor(np_params[k], device)
            for k in ("table", "linear", "bias")}


def lm_params(np_params, device=None) -> dict:
    """``repro.models.transformer.init_params`` output -> ``models/transformer``
    parameters: ``embed`` (V, D), ``final_ln`` (D,) and ``layers`` of
    stacked (L, ...) weights: GQA or MLA attention, a dense FFN or the
    nested ``moe`` dict (``router``, experts, ``shared``)."""
    return {"embed": to_tensor(np_params["embed"], device),
            "final_ln": to_tensor(np_params["final_ln"], device),
            "layers": tree_to_tensors(np_params["layers"], device)}


def gnn_params(np_params, device=None) -> dict:
    """The ``init_params`` output of any of ``repro.models.gnn``'s four
    models -> ``models/gnn`` parameters: the same nesting, with stacked
    (L, ...) layer leaves and ``mlp_init``'s lists of ``{"w", "b"}`` as
    they are."""
    return tree_to_tensors(np_params, device)
