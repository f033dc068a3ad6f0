"""The reference's public functions that the port carries beside its
batched forms, each against the reference on the CPU: ``initial_partition``
(one seed, both methods; parts bit for bit), ``metrics.ghost_part``,
``delta_cutsize`` and ``boundary_mask`` (exact), ``graph.validate_host``
(passes on a valid graph, raises on a broken ``xadj`` in both packages),
and the dry run's ``--skip-existing`` (a cell whose record is on disk is not
counted again).  The reference runs through ``jax.jit``.
"""
import os

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgr  # noqa: E402
from repro.core import initial as jinit  # noqa: E402
from repro.core import metrics as jme  # noqa: E402
from repro.data import graphs as jgen  # noqa: E402
from repro_torch.core import graph as gr  # noqa: E402
from repro_torch.core import initial as init  # noqa: E402
from repro_torch.core import metrics as me  # noqa: E402


def _graph():
    jg = jgen.rmat(7)
    return jg.with_capacity(jg.n_max + 37, jg.m_max + 50)


def _port(jg):
    return gr.from_numpy_arrays(*(np.asarray(a) for a in jg))


def _parts(jg, k, t, seed):
    parts = np.random.default_rng(seed).integers(0, k, (t, jg.n_max))
    parts[:, int(jg.n):] = k
    return parts.astype(np.int32)


@pytest.mark.parametrize("method", ["voronoi", "random"])
def test_initial_partition_matches(method):
    jg, k = _graph(), 8
    ref = jax.jit(jinit.initial_partition, static_argnames=("k", "method"))
    for seed in (0, -3, 123456789):
        got = init.initial_partition(_port(jg), k, seed, method)
        assert got.shape == (jg.n_max,) and got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref(jg, k, seed, method)))
    with pytest.raises(ValueError):
        init.initial_partition(_port(jg), k, 0, "nope")


@pytest.mark.parametrize("fn", ["ghost_part", "delta_cutsize",
                                "boundary_mask"])
def test_metrics_functions_match(fn):
    jg, k = _graph(), 5
    tg = _port(jg)
    old, new = _parts(jg, k, 3, seed=1), _parts(jg, k, 3, seed=2)
    if fn == "ghost_part":
        assert me.GHOST == jme.GHOST
        assert [me.ghost_part(k) for k in (2, 33)] == \
            [jme.ghost_part(k) for k in (2, 33)]
        return
    if fn == "delta_cutsize":
        ref = jax.jit(jme.delta_cutsize)
        got = me.delta_cutsize(tg, None, torch.from_numpy(old),
                               torch.from_numpy(new))
        for t in range(3):
            want = ref(jg, jnp.int32(0), jnp.asarray(old[t]),
                       jnp.asarray(new[t]))
            assert int(got[t]) == int(want) and got.dtype == torch.int32
        return
    ref = jax.jit(jme.boundary_mask)
    got = me.boundary_mask(tg, torch.from_numpy(new))
    assert got.shape == new.shape and got.dtype == torch.bool
    for t in range(3):
        want = np.asarray(ref(jg, jnp.asarray(new[t])))
        np.testing.assert_array_equal(got[t].numpy(), want)
        np.testing.assert_array_equal(
            me.boundary_mask(tg, torch.from_numpy(new[t])).numpy(), want)


@pytest.mark.parametrize("broken", [False, True])
def test_validate_host_matches(broken):
    jg = _graph()
    if broken:   # a row that ends before it starts
        xadj = np.asarray(jg.xadj).copy()
        xadj[1], xadj[2] = xadj[2], xadj[1] - 1
        jg = jg._replace(xadj=jnp.asarray(xadj))
    tg = _port(jg)
    if not broken:
        jgr.validate_host(jg)
        gr.validate_host(tg)
        return
    with pytest.raises(AssertionError):
        jgr.validate_host(jg)
    with pytest.raises(AssertionError):
        gr.validate_host(tg)


def test_dryrun_skip_existing(tmp_path, capsys):
    """A second run with ``--skip-existing`` leaves the record alone; an
    error record is counted again."""
    from repro_torch.launch import dryrun

    out = str(tmp_path)
    argv = ["--smoke", "--mesh", "card", "--arch", "fm", "--shape",
            "serve_p99", "--out", out]
    assert dryrun.main(argv) == 0
    path = os.path.join(out, "card", "fm__serve_p99.json")
    before = os.stat(path).st_mtime_ns
    capsys.readouterr()
    assert dryrun.main(argv + ["--skip-existing"]) == 0
    assert "[skip-existing] card fm serve_p99" in capsys.readouterr().out
    assert os.stat(path).st_mtime_ns == before
    with open(path, "w") as f:
        f.write('{"status": "error"}')
    assert dryrun.main(argv + ["--skip-existing"]) == 0
    assert "[skip-existing]" not in capsys.readouterr().out
    with open(path) as f:
        assert '"status": "ok"' in f.read()
