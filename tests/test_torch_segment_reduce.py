"""The port's segment_reduce (sorted-segment sum) against the JAX package.

The plain version (``kernels/segment_reduce/ref.py``), which the wrapper
takes for CPU tensors, is held against the reference's Pallas kernel in
interpret mode (through ``segment_sum_sorted``) and against its oracle
``ref.py``, on the sweep of ``tests/test_kernel_segment_reduce.py``: int32
and float32, empty segments, padding rows, giant runs.  Tolerance: int32
exact.  Float32 against the oracle: rtol=1e-5, atol=1e-5, since the order
of the sums may differ.  Float32 against the Pallas kernel: the reference
test's own rtol=1e-4, atol=1e-3, since its blocked one-hot products reorder
the sums of long segments further (measured: 2e-5 apart on a 700-row run).  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_reduce.ops import segment_sum_sorted as jss  # noqa: E402
from repro.kernels.segment_reduce.ref import segment_sum_sorted_ref as jref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.segment_reduce import ops  # noqa: E402


def _case(m, f, s, seed, dtype, skewed=False):
    rng = np.random.default_rng(seed)
    if skewed:  # one giant segment straddling many blocks
        seg = np.sort(rng.choice([0, s // 2, s - 1], m, p=[0.8, 0.1, 0.1]))
    else:
        seg = np.sort(rng.integers(0, s, m))
    if dtype == np.int32:
        data = rng.integers(-5, 5, (m, f)).astype(dtype)
    else:
        data = rng.standard_normal((m, f)).astype(dtype)
    return data, seg.astype(np.int32)


def _check(data, seg, s, block=128):
    got = ops.segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(seg),
                                 s).numpy()
    assert got.dtype == data.dtype and got.shape == (s, data.shape[1])
    jd, js = jnp.asarray(data), jnp.asarray(seg)
    for want, tol in ((jref(jd, js, s), 1e-5),
                      (jss(jd, js, s, block_m=block), None)):
        if data.dtype == np.int32:
            np.testing.assert_array_equal(got, np.asarray(want))
        elif tol:
            np.testing.assert_allclose(got, np.asarray(want), rtol=tol,
                                       atol=tol)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-3)
    return got


@pytest.mark.parametrize("m,f,s,block", [
    (512, 8, 32, 128),
    (1024, 16, 200, 256),
    (300, 4, 10, 128),     # needs padding
    (256, 128, 256, 64),   # every row its own segment
    (2048, 32, 3, 512),    # giant segments straddle blocks
    (1000, 1, 5000, 256),  # F = 1, mostly empty segments
])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_sum_sweep(m, f, s, block, dtype):
    _check(*_case(m, f, s, seed=m + f, dtype=dtype), s, block)


def test_segment_sum_empty_segments_and_padding_rows():
    # ids skip values; ids >= S are dropped (padding rows), as are ids < 0
    seg = np.asarray([-1, 0, 0, 5, 5, 5, 9, 12, 12], dtype=np.int32)
    for dtype in (np.float32, np.int32):
        data = np.arange(18).reshape(9, 2).astype(dtype)
        got = _check(data, seg, 10, block=8)
        assert np.all(got[1:5] == 0) and np.all(got[6:9] == 0)
        np.testing.assert_array_equal(got[0], data[1] + data[2])


def test_segment_sum_skewed():
    for dtype in (np.float32, np.int32):
        _check(*_case(1024, 8, 64, seed=7, dtype=dtype, skewed=True), 64)


def test_segment_sum_wraps_and_empty_inputs():
    data = np.full((4, 1), 2**30, dtype=np.int32)
    got = _check(data, np.zeros(4, dtype=np.int32), 1)
    assert got[0, 0] == 0  # 4 * 2^30 wraps to 0, as XLA's int32 sum does
    empty = ops.segment_sum_sorted(torch.zeros(0, 3, dtype=torch.int32),
                                   torch.zeros(0, dtype=torch.int32), 4)
    assert torch.equal(empty, torch.zeros(4, 3, dtype=torch.int32))
    assert ops.segment_sum_sorted(torch.ones(5, 1), torch.zeros(
        5, dtype=torch.int32), 0).shape == (0, 1)


def test_wrapper_checks_and_cpu_path_launches_nothing():
    data = torch.ones(6, 2, dtype=torch.int32)
    seg = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.segment_sum_sorted(data.long(), seg, 3)
    with pytest.raises(TypeError):
        ops.segment_sum_sorted(data.double(), seg, 3)
    with pytest.raises(TypeError):
        ops.segment_sum_sorted(data, seg.long(), 3)
    with pytest.raises(ValueError):
        ops.segment_sum_sorted(data[:5], seg, 3)
    with pytest.raises(ValueError):
        ops.segment_sum_sorted(data[:, 0], seg, 3)
    with pytest.raises(ValueError):
        ops.segment_sum_sorted(data, seg, -1)
    before = kernels.launch_counts["segment_reduce"]
    ops.segment_sum_sorted(data, seg, 3)
    assert kernels.launch_counts["segment_reduce"] == before
