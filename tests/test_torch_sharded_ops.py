"""The DTensor rules of the hand-written kernels' wrappers against the
one-device ops, on the CPU (their plain versions).

flash_attention's forward and backward with the batch over "data" and the
query heads over "model" (k, v replicated there, or sharded alike when
Hkv = H), at (H, Hkv, model) = (4, 1, 2), (8, 2, 4), (6, 2, 4): the last
has a shard whose heads straddle two kv groups and an empty shard.
fm_interaction's forward and backward with the batch rows sharded, D
sharded (a ``Partial`` score), a ``Partial`` emb (a vocab-parallel
lookup's: reduced onto the rows, or replicated where they do not divide)
and F sharded (gathered), also against the reference's
``fm_interaction_ref`` and its ``jax.grad`` through ``jax.jit``.
segment_reduce with the rows sharded (a ``Partial`` sum), the output
sharded by segment range (each rank's ids shifted), and both;
``models/gather.py``'s gather_nodes and scatter_sum with sharded
features.  Four gloo
ranks (``launch/gnn_partitioned.spawn_ranks``) run every case once
(``tests/sharded_cases.py``); the parent compares.  Tolerances: float32
within 1e-6 relative L2 (sums in another order across ranks), int32
exact.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sharded_cases as cases  # noqa: E402
from repro.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.launch.gnn_partitioned import spawn_ranks  # noqa: E402

RTOL = 1e-6


@pytest.fixture(scope="module")
def world():
    return spawn_ranks(cases.ops_world, 4, ({},), device="cpu",
                       timeout_s=240)[0]


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("name,h,hkv,mesh", cases.FLASH_CASES,
                         ids=[c[0] for c in cases.FLASH_CASES])
def test_flash_attention_sharded_matches_one_device(world, name, h, hkv,
                                                    mesh):
    """o, dq, dk, dv of the sharded call (gathered) against the same call
    on whole tensors."""
    a = {k: torch.from_numpy(v) for k, v in cases.flash_inputs(h, hkv)
         .items()}
    want = cases.flash_one(a["q"], a["k"], a["v"], a["w"],
                           cases.FLASH_SHAPE["window"])
    for label, g, w in zip(("o", "dq", "dk", "dv"), world[name], want):
        assert g.shape == tuple(w.shape), label
        w = w.detach().numpy()
        assert _rel_l2(g, w) <= RTOL, (label, _rel_l2(g, w))


def test_flash_attention_kv_heads_of_a_shard():
    """The kv heads a shard of query heads gets: whole groups and heads in
    one group are slices, straddling heads a repeat of each one's head;
    an empty shard gets none."""
    k = torch.arange(2.0).reshape(1, 2, 1, 1).expand(1, 2, 1, 3)
    for (h0, h1), want in (((0, 3), [0]), ((3, 6), [1]), ((0, 6), [0, 1]),
                           ((2, 4), [0, 1]), ((1, 5), [0, 0, 1, 1]),
                           ((1, 2), [0]), ((4, 4), [])):
        kl, vl = fa_ops._kv_heads(k, k, h0, h1, 3)
        assert kl[0, :, 0, 0].tolist() == [float(x) for x in want], (h0, h1)
        assert vl.shape == kl.shape


def test_flash_attention_zero_heads_on_cpu():
    """A shard with no query head (H = Hkv = 0): an empty output of the
    right shape, forward and backward, no error."""
    q = torch.zeros((2, 0, 8, 16), requires_grad=True)
    k = torch.zeros((2, 0, 8, 16), requires_grad=True)
    v = torch.zeros((2, 0, 8, 12), requires_grad=True)
    o = fa_ops.flash_attention(q, k, v, causal=True, window=4)
    assert tuple(o.shape) == (2, 0, 8, 12)
    dq, dk, dv = torch.autograd.grad(o.sum(), (q, k, v), allow_unused=True)
    assert tuple(dq.shape) == (2, 0, 8, 16) and tuple(dv.shape) == \
        (2, 0, 8, 12)
    o2, lse = fa_ops._forward_op(q.detach(), k.detach(), v.detach(), True,
                                 4, 0, True)
    assert tuple(o2.shape) == (2, 0, 8, 12) and tuple(lse.shape) == (2, 0, 8)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(torch.zeros(2, 0, 8, 16),
                               torch.zeros(2, 1, 8, 16),
                               torch.zeros(2, 1, 8, 16))


# the scores' placements of each case of FM_RULE_CASES
FM_RULE_OUT = {"batch": ["Shard(0)", "Shard(0)"],
               "columns": ["Shard(0)", "Partial"],
               "partial": ["Shard(0)", "Replicate"],
               "fields": ["Replicate", "Replicate"]}


@pytest.mark.parametrize("name,b,placements", cases.FM_RULE_CASES,
                         ids=[c[0] for c in cases.FM_RULE_CASES])
def test_fm_interaction_sharded_matches_one_device(world, name, b,
                                                   placements):
    """The scores and emb's gradient of the sharded call (gathered)
    against the same call on whole tensors and against the reference's
    ``fm_interaction_ref`` and its gradient; the scores laid out as the
    rule says."""
    a = cases.fm_rule_inputs(b)
    emb, w = torch.from_numpy(a["emb"]), torch.from_numpy(a["w"])
    want = [x.detach().numpy() for x in cases.fm_rule_one(emb, w)]
    ref = jax.jit(jax.value_and_grad(
        lambda e: jnp.sum(fm_interaction_ref(e) * a["w"])))
    jscores = jax.jit(fm_interaction_ref)(a["emb"])
    jgrad = ref(a["emb"])[1]
    (got, pl) = world[f"fm_{name}"]
    assert pl == FM_RULE_OUT[name]
    for label, g, w1, w2 in zip(("scores", "grad"), got, want,
                                (jscores, jgrad)):
        assert g.shape == w1.shape, label
        assert _rel_l2(g, w1) <= RTOL, (label, _rel_l2(g, w1))
        assert _rel_l2(g, np.asarray(w2)) <= RTOL, label


@pytest.mark.parametrize("name,dtype,rows,vocab", cases.SEGMENT_CASES,
                         ids=[c[0] for c in cases.SEGMENT_CASES])
def test_segment_reduce_sharded_matches_one_device(world, name, dtype, rows,
                                                   vocab):
    """The sharded sum (gathered) against the one-device sum: int32
    exact, float32 within 1e-6; rows sharded give a Partial over "data"
    (reduced by the gather), a vocab-parallel output a Shard(0) over
    "model"."""
    a = cases.segment_inputs(dtype)
    want = sr.segment_sum_sorted(torch.from_numpy(a["data"]),
                                 torch.from_numpy(a["ids"]),
                                 cases.SEGMENT_SHAPE["s"]).numpy()
    got, placements = world[name]
    assert placements[0] == ("Partial" if rows else "Replicate")
    assert placements[1] == ("Shard(0)" if vocab else "Replicate")
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel_l2(got, want) <= RTOL


def test_gather_and_scatter_rows_sharded_match_one_device(world):
    """gather_nodes and scatter_sum on DTensors whose features are sharded
    over "model" (rows over "data" gathered first: an index is one rank's,
    the same on every rank), forward and gradients, against the
    one-device calls."""
    a = {k: torch.from_numpy(v) for k, v in cases.rows_inputs().items()}
    want = cases.rows_one(a["x"], a["values"], a["index"], a["w_gather"],
                          a["w_sum"])
    for label, g, w in zip(("gather", "sum", "dx", "dvalues"),
                           world["rows"], want):
        w = w.detach().numpy()
        assert g.shape == w.shape, label
        assert _rel_l2(g, w) <= RTOL, (label, _rel_l2(g, w))
