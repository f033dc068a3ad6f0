"""The port's jet_gain against the JAX reference: plain version, kernel, glue.

Inputs are made with numpy from a seed and go through both packages; every
comparison is exact (integer outputs).  The CUDA kernel runs only on a
card: its tests are in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import graphs as jgen  # noqa: E402
from repro.kernels.jet_gain import ops as jops  # noqa: E402
from repro.kernels.jet_gain.jet_gain import jet_gain_pallas  # noqa: E402
from repro.kernels.jet_gain.ref import jet_gain_ref as jax_ref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core.graph import from_numpy_arrays  # noqa: E402
from repro_torch.kernels.jet_gain import ops  # noqa: E402
from repro_torch.kernels.jet_gain.ref import jet_gain_ref  # noqa: E402

SWEEP = [  # (n, d, k, pallas block) as in tests/test_kernel_jet_gain.py
    (256, 8, 4, 64),
    (512, 16, 7, 128),
    (1024, 4, 13, 256),
    (128, 32, 31, 128),
    (2048, 5, 3, 512),
]


def _rand_inputs(n, d, k, seed=0, wmax=8, t=None):
    rng = np.random.default_rng(seed)
    shape = (n, d) if t is None else (t, n, d)
    nbr_parts = rng.integers(0, k + 1, shape).astype(np.int32)
    nwgt = rng.integers(0, wmax, (n, d)).astype(np.int32)
    if t is None:
        nwgt[nbr_parts == k] = 0  # ghost slots carry no weight
    parts = rng.integers(0, k, shape[:-1]).astype(np.int32)
    return nbr_parts, nwgt, parts


def _assert_same(got, want):
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g_), np.asarray(w))


@pytest.mark.parametrize("n,d,k,block", SWEEP)
def test_ref_matches_jax_ref_and_pallas(n, d, k, block):
    nbr_parts, nwgt, parts = _rand_inputs(n, d, k, seed=n + d + k)
    got = jet_gain_ref(*map(torch.from_numpy, (nbr_parts, nwgt, parts)), k)
    want = jax_ref(jnp.asarray(nbr_parts), jnp.asarray(nwgt),
                   jnp.asarray(parts), k)
    _assert_same(got, want)
    pallas = jet_gain_pallas(jnp.asarray(nbr_parts), jnp.asarray(nwgt),
                             jnp.asarray(parts), k, block_n=block)
    _assert_same(got, pallas)


def test_ties_pick_smallest_part():
    nbr_parts = np.asarray([[1, 2, 1, 2]], np.int32)
    nwgt = np.asarray([[3, 3, 2, 2]], np.int32)
    parts = np.asarray([0], np.int32)
    got = jet_gain_ref(*map(torch.from_numpy, (nbr_parts, nwgt, parts)), 4)
    _assert_same(got, jax_ref(jnp.asarray(nbr_parts), jnp.asarray(nwgt),
                              jnp.asarray(parts), 4))
    assert int(got[1][0]) == 1 and int(got[2][0]) == 5


def test_no_other_part_and_ghost_rows():
    # a row tied only to its own part, and a padding row (all ghost slots)
    nbr_parts = np.asarray([[0, 0, 0, 0], [3, 3, 3, 3]], np.int32)
    nwgt = np.asarray([[1, 1, 1, 1], [0, 0, 0, 0]], np.int32)
    parts = np.asarray([0, 3], np.int32)
    got = jet_gain_ref(*map(torch.from_numpy, (nbr_parts, nwgt, parts)), 3)
    _assert_same(got, jax_ref(jnp.asarray(nbr_parts), jnp.asarray(nwgt),
                              jnp.asarray(parts), 3))
    _assert_same(got, ([4, 0], [3, 3], [0, 0]))


@pytest.mark.parametrize("t,k", [(3, 5), (2, 33)])
def test_trial_batch_equals_separate_calls(t, k):
    nbr_parts, nwgt, parts = _rand_inputs(300, 9, k, seed=7 * t + k, t=t)
    batched = jet_gain_ref(*map(torch.from_numpy, (nbr_parts, nwgt, parts)), k)
    for i in range(t):
        want = jax_ref(jnp.asarray(nbr_parts[i]), jnp.asarray(nwgt),
                       jnp.asarray(parts[i]), k)
        _assert_same([b[i] for b in batched], want)


@pytest.mark.parametrize("name", ["grid_64x32", "rmat_12"])
def test_ell_glue_matches_reference(name):
    """csr_to_ell / lookup / update / ell_to_matrix and jet_gain on a graph."""
    jg = jgen.suite_graph(name)
    g = from_numpy_arrays(*(np.asarray(a) for a in jg))
    k = 5
    rng = np.random.default_rng(3)
    parts = rng.integers(0, k, (2, g.n_max)).astype(np.int32)
    parts[:, int(g.n):] = k
    move = rng.random((2, g.n_max)) < 0.3
    dest = rng.integers(0, k, (2, g.n_max)).astype(np.int32)

    nbr, wgt = ops.csr_to_ell(g)
    jnbr, jwgt = jops.csr_to_ell(jg)
    _assert_same((nbr, wgt), (jnbr, jwgt))
    tparts = torch.from_numpy(parts)
    nparts = ops.lookup_nbr_parts(nbr, tparts, k)
    upd = ops.update_nbr_parts(nbr, nparts, torch.from_numpy(move),
                               torch.from_numpy(dest), k)
    mat = ops.ell_to_matrix(upd, wgt, k)
    out = ops.jet_gain(nbr, wgt, tparts, k)
    for i in range(2):
        jp = jops.lookup_nbr_parts(jnbr, jnp.asarray(parts[i]), k)
        np.testing.assert_array_equal(nparts[i].numpy(), np.asarray(jp))
        ju = jops.update_nbr_parts(jnbr, jp, jnp.asarray(move[i]),
                                   jnp.asarray(dest[i]), k)
        np.testing.assert_array_equal(upd[i].numpy(), np.asarray(ju))
        np.testing.assert_array_equal(mat[i].numpy(),
                                      np.asarray(jops.ell_to_matrix(ju, jwgt, k)))
        want = jops.jet_gain(jnbr, jwgt, jnp.asarray(parts[i]), k,
                             use_pallas=False)
        _assert_same([o[i] for o in out], want)


def test_cpu_tensor_never_launches_the_kernel():
    nbr_parts, nwgt, parts = _rand_inputs(64, 4, 3, seed=1)
    before = kernels.launch_counts["jet_gain"]
    ops.jet_gain_from_parts(*map(torch.from_numpy, (nbr_parts, nwgt, parts)), 3)
    assert kernels.launch_counts["jet_gain"] == before


def test_wrapper_rejects_bad_inputs():
    nbr_parts, nwgt, parts = map(torch.from_numpy, _rand_inputs(64, 4, 3))
    with pytest.raises(TypeError):
        ops.jet_gain_from_parts(nbr_parts.long(), nwgt, parts, 3)
    with pytest.raises(ValueError):
        ops.jet_gain_from_parts(nbr_parts, nwgt[:-1], parts, 3)
