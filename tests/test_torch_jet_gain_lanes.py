"""jet_gain with a fleet's lane axis: per-lane ELL weights (B, N, D) and
panels (B, T, N, D), on the CPU.

The port's plain version is held against ``jax.vmap`` (over lanes, then
trials, the weights mapped over lanes only) of the reference's plain
version, and the ELL glue against the port's own per-lane calls.  Lane
counts differ from trial counts where it matters (a weight broadcast along
the wrong axis would show).  Exact: integer outputs.  The kernel's lane
path runs only on a card (``test_torch_gpu.py``).
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_parity as tp  # noqa: E402

from repro.kernels.jet_gain.ref import jet_gain_ref as jax_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import graph as gr  # noqa: E402
from repro_torch.data import graphs as gen  # noqa: E402
from repro_torch.kernels.jet_gain import ops  # noqa: E402
from repro_torch.kernels.jet_gain.ref import jet_gain_ref  # noqa: E402


def _lanes(b, n, d, k, t, seed):
    """B stacked jet_gain panels: (B, T, N, D), (B, N, D), (B, T, N)."""
    panels = [tp.panel(n, d, k, t, seed=seed + i, odd=True) for i in range(b)]
    return [np.stack(a) for a in zip(*panels)]


@pytest.mark.parametrize("b,t", [(3, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("d,k", [(1, 2), (6, 64), (33, 7)])
def test_plain_with_lanes_matches_vmapped_reference(b, t, d, k):
    nbr_parts, wgt, parts = _lanes(b, 96, d, k, t, seed=d * k + b)
    got = jet_gain_ref(*(torch.from_numpy(a) for a in (nbr_parts, wgt,
                                                       parts)), k)
    per_trial = jax.vmap(lambda p, w, q: jax_ref(p, w, q, k),
                         in_axes=(0, None, 0))
    want = jax.vmap(per_trial)(jnp.asarray(nbr_parts), jnp.asarray(wgt),
                               jnp.asarray(parts))
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    # the wrapper on the CPU: the plain version, no launch; without a
    # trial axis the lanes' panels are (B, N, D)
    before = dict(kernels.launch_counts)
    for g_, w in zip(ops.jet_gain_from_parts(
            *(torch.from_numpy(a) for a in (nbr_parts, wgt, parts)), k), got):
        assert torch.equal(g_, w)
    one = ops.jet_gain_from_parts(torch.from_numpy(nbr_parts[:, 0]),
                                  torch.from_numpy(wgt),
                                  torch.from_numpy(parts[:, 0]), k)
    for g_, w in zip(one, got):
        assert torch.equal(g_, w[:, 0])
    assert dict(kernels.launch_counts) == before


def test_wrapper_checks_lane_shapes():
    nbr_parts, wgt, parts = (torch.from_numpy(a)
                             for a in _lanes(2, 40, 4, 5, 3, seed=0))
    for bad in ((nbr_parts, wgt[:1], parts),            # lanes differ
                (nbr_parts, wgt[:, :30], parts[..., :30]),  # N differs
                (nbr_parts[0, 0], wgt, parts[0, 0]),    # (N, D) with lanes
                (nbr_parts, wgt, parts[:, :2])):        # parts do not fit
        with pytest.raises(ValueError):
            ops.jet_gain_from_parts(*bad, 5)
    with pytest.raises(TypeError):
        ops.jet_gain_from_parts(nbr_parts, wgt.long(), parts, 5)


def test_ell_glue_with_lanes_equals_each_lane():
    """csr_to_ell, lookup_nbr_parts, update_nbr_parts and ell_to_matrix on
    a stacked bucket equal the same calls lane by lane."""
    graphs = [gen.small_world(90, seed=1), gen.grid2d(9, 9),
              gen.random_geometric(70, seed=2)]
    cap = (max(g.n_max for g in graphs), max(g.m_max for g in graphs))
    gb = gr.stack_bucket(graphs, cap)
    d = int(gb.degrees().max())
    k, t = 6, 2
    rng = np.random.default_rng(5)
    parts = torch.from_numpy(rng.integers(0, k + 1, (3, t, cap[0]))
                             .astype(np.int32))
    move = torch.from_numpy(rng.random((3, t, cap[0])) < 0.3)
    dest = torch.from_numpy(rng.integers(0, k, (3, t, cap[0]))
                            .astype(np.int32))
    nbr, wgt = ops.csr_to_ell(gb, d)
    nparts = ops.lookup_nbr_parts(nbr, parts, k)
    upd = ops.update_nbr_parts(nbr, nparts, move, dest, k)
    mat = ops.ell_to_matrix(upd, wgt, k)
    for b in range(3):
        nb, wb = ops.csr_to_ell(gr.unstack_graph(gb, b), d)
        assert torch.equal(nbr[b], nb) and torch.equal(wgt[b], wb)
        npb = ops.lookup_nbr_parts(nb, parts[b], k)
        assert torch.equal(nparts[b], npb)
        ub = ops.update_nbr_parts(nb, npb, move[b], dest[b], k)
        assert torch.equal(upd[b], ub)
        assert torch.equal(mat[b], ops.ell_to_matrix(ub, wb, k))
