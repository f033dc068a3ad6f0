"""Mirrors of the reference's registry and flag tests that had no port
counterpart, on the CPU: every (arch x shape) cell of the port's registry
is buildable or declared skipped (40 cells, the reference's registry, as
``tests/test_configs_smoke.py`` counts them); the GNNs' ``ogb_products``
smoke cells run one real step with a finite loss and finite parameters;
and the LM's ``seq_parallel`` and ``grad_cast`` tuning flags
(``tests/test_extensions.py``), which the port carries but does not read
on one card, leave the loss unchanged."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402


def test_all_cells_enumerable():
    """40 cells: every (arch x shape) is either buildable or declared
    skipped, with the reference's arch ids and shape names."""
    assert ARCH_IDS == tuple(JAX_ARCH_IDS)
    total, skipped = 0, 0
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        assert list(arch.shapes) == list(jax_get_arch(arch_id).shapes)
        for shape_name in arch.shapes:
            total += 1
            if arch.shapes[shape_name] is None:
                skipped += 1
                assert shape_name in arch.skip_notes, (
                    f"{arch_id}/{shape_name} skipped without a note")
                with pytest.raises(ValueError):
                    steps.build_cell(arch, shape_name, "cpu", smoke=True)
    assert total == 40, total
    assert skipped == 4  # long_500k for 4 pure-full-attention LMs


def test_gnn_smoke_large_shapes():
    """The ogb_products smoke cell of each GNN: one step, finite loss and
    parameters."""
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        if arch.family != "gnn":
            continue
        cell = steps.build_cell(arch, "ogb_products", "cpu", smoke=True)
        params, _, metrics = cell.step_fn(*steps.materialize_cell(cell, 0))
        assert np.isfinite(float(metrics["loss"])), arch_id
        for leaf in tree.leaves(params):
            assert bool(torch.isfinite(leaf.float()).all()), arch_id


def test_grad_cast_and_seq_parallel_flags_preserve_loss():
    """The tuning flags must not change the forward loss."""
    cfg = tf.LMConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
                      head_dim=16, d_ff=64, vocab=53, remat=True,
                      dtype="float32", attn_chunk=16)
    p = tf.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    b = {k: torch.from_numpy(rng.integers(0, 53, (2, 16)).astype(np.int32))
         for k in ("tokens", "labels")}
    base = float(tf.loss_fn(cfg, p, b)[0])
    for flags in ({"seq_parallel": True}, {"grad_cast": True},
                  {"seq_parallel": True, "grad_cast": True}):
        cfg2 = dataclasses.replace(cfg, **flags)
        assert float(tf.loss_fn(cfg2, p, b)[0]) == pytest.approx(base)
