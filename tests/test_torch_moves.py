"""Jetlp moves of the port against the JAX reference at k in {2, 33}.

``tests/test_torch_core.py`` holds every variant on every backend at k=8;
this file takes the same check to the other part counts of the suite, two
parts (a single alternative) and 33 (more parts than many vertices have
neighbors), with T=2 trials and every variant.  Everything is bit-exact.

Each test covers every variant of one (k, backend), which keeps the
file's item count low (ROADMAP Queue 3: test_fleet and pytest-xdist).
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import refine as jrf  # noqa: E402
from repro.data import graphs as jgen  # noqa: E402
from repro_torch.core import connectivity as cn  # noqa: E402
from repro_torch.core import graph as gr  # noqa: E402
from repro_torch.core import refine as rf  # noqa: E402


@pytest.mark.parametrize("backend", cn.BACKENDS)
@pytest.mark.parametrize("k", [2, 33])
def test_jetlp_moves_match(k, backend):
    jg = jgen.rmat(8).with_capacity(300, 2000)
    tg = gr.from_numpy_arrays(*(np.asarray(a) for a in jg))
    rng = np.random.default_rng(k)
    parts = rng.integers(0, k, (2, jg.n_max)).astype(np.int32)
    parts[:, int(jg.n):] = k
    lock = rng.random((2, jg.n_max)) < 0.2
    for variant in rf.VARIANTS:
        move, dest = rf.jetlp_moves(tg, torch.from_numpy(parts), k,
                                    torch.from_numpy(lock), 0.75, backend,
                                    variant)
        for t in range(2):
            jm, jd = jrf.jetlp_moves(jg, jnp.asarray(parts[t]), k,
                                     jnp.asarray(lock[t]), 0.75, backend,
                                     variant)
            np.testing.assert_array_equal(move[t].numpy(), np.asarray(jm),
                                          err_msg=variant)
            np.testing.assert_array_equal(dest[t].numpy(), np.asarray(jd),
                                          err_msg=variant)
