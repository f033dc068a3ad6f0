"""The port on a CUDA card: the jet_gain, segment_reduce, fm_interaction
and flash_attention kernels against their plain versions, partition()
against the CPU run, the committed golden results and, for the sorted
backend, the dense backend, the serving models (FM, Gemma-3 1B and
DeepSeek-V2-Lite's MLA + MoE) against their CPU runs, and GNN training:
scatter_sum and gather_nodes with their backward passes on the
segment_reduce kernel, each GNN's train step against the CPU's, and the
partitioned MeshGraphNet step at world size 1 against the dense one; LM
and FM training: the backward kernels of flash_attention and
fm_interaction against their plain versions, and each LM's and FM's smoke
train step against the CPU's; the LM smoke cells through
``steps.sharded_step`` on a one-rank NCCL mesh, bit for bit the unsharded
cells'; a flash_attention call with no query head, no launch.

Wrapper contracts: every wrapper takes strided views (one launch per
call), segment_reduce takes bfloat16 and float16 (float32 sums, one
rounding; the tolerance adds one step of the output's rounding), and
fm_interaction float16; jet_gain takes a fleet's per-lane weights, and
partition_fleet on the card equals the CPU and the reference's standalone
runs (the golden file), and so does PartitionServer's response to the
reference serve test's burst, dispatch log included.

These tests import no JAX, so they run on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card they skip.  Every comparison is exact, except where a float
sum runs in another order than the plain version's; two launches must then
agree bit for bit, and the tolerance is: segment_reduce on float32, 1e-5 +
1e-5 * (the sum of |x| over the segment); fm_interaction, 1e-5 + 1e-5 *
(the row's sum of e^2); flash_attention, 2e-5 + 2e-5 * |plain| in float32
and 1e-5 + 1e-2 * |plain| in bfloat16 and float16 (``torch_parity.py``);
the models' logits and scores, and the GNNs' losses and gradients, against
the CPU, 2e-4.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.jet_gain import ops  # noqa: E402
from repro_torch.kernels.jet_gain.ref import jet_gain_ref  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref  # noqa: E402,E501
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402,E501

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("d", [1, 4, 6, 8, 31, 32, 33, 37, 300])
def test_kernel_matches_plain(cuda, d):
    # D <= 32 takes the kernel's lane-group path, D > 32 its histogram path;
    # each case runs for k = 2, 64 and 1000, without trials (t=None) and
    # with four
    for k in (2, 64, 1000):
        for t in (None, 4):
            ins = [torch.from_numpy(a)
                   for a in tp.panel(2000, d, k, t, seed=d * k, odd=True)]
            want = jet_gain_ref(*ins, k)
            before = kernels.launch_counts["jet_gain"]
            got = ops.jet_gain_from_parts(*(x.to(cuda) for x in ins), k)
            torch.cuda.synchronize()
            assert kernels.launch_counts["jet_gain"] == before + 1, (k, t)
            for g_, w in zip(got, want):
                assert torch.equal(g_.cpu(), w), (k, t)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind", tp.SEGMENT_KINDS)
@pytest.mark.parametrize("m,f", [(1, 1), (255, 1), (257, 3), (4099, 1),
                                 (100_000, 1), (3000, 128)])
def test_segment_reduce_matches_plain(cuda, m, f, kind, dtype):
    data, seg, s = tp.segment_case(m, f, kind, dtype, seed=m + f, device=cuda)
    want = segment_sum_sorted_ref(data, seg, s)
    before = kernels.launch_counts["segment_reduce"]
    got = sr.segment_sum_sorted(data, seg, s)
    again = sr.segment_sum_sorted(data, seg, s)
    torch.cuda.synchronize()
    assert kernels.launch_counts["segment_reduce"] == before + 2
    assert torch.equal(got, again)
    assert got.dtype == dtype
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        assert tp.segment_error_ratio(got, want, data, seg, s) <= 1


def test_segment_reduce_edge_inputs(cuda):
    # inputs the panels do not make: data and ids that start 4 bytes past
    # a 16-byte boundary (the kernel's scalar loads), F = 4 both aligned
    # and not, no rows, no segments, F = 0, and every row dropped
    gen = torch.Generator(device=cuda).manual_seed(5)
    m, s = 50_001, 9_000
    seg = torch.sort(torch.randint(-50, s + 50, (m + 1,), device=cuda,
                                   generator=gen)).values.int()
    cases = []
    for f in (1, 4):
        flat = torch.randint(-2**31, 2**31, ((m + 1) * f + 1,), device=cuda,
                             generator=gen, dtype=torch.int64).int()
        cases.append((flat[:m * f].view(m, f), seg[:m]))
        cases.append((flat[1:m * f + 1].view(m, f), seg[1:]))
    cases += [(torch.zeros(0, 1, dtype=torch.int32, device=cuda),
               seg[:0]),
              (torch.ones(7, 0, dtype=torch.int32, device=cuda), seg[:7]),
              (torch.ones(m, 1, dtype=torch.int32, device=cuda),
               torch.full((m,), -3, dtype=torch.int32, device=cuda)),
              (torch.ones(m, 1, dtype=torch.int32, device=cuda),
               torch.full((m,), s, dtype=torch.int32, device=cuda))]
    for data, ids in cases:
        for num_segments in (0, 1, s):
            got = sr.segment_sum_sorted(data, ids, num_segments)
            want = segment_sum_sorted_ref(data, ids, num_segments)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (tuple(data.shape),
                                            data.data_ptr() % 16,
                                            num_segments)


def test_argmax_argmin_take_first_index(cuda):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (500, 40)))
    for fn in (torch.argmax, torch.argmin):
        want = fn(x, dim=1)
        assert torch.equal(fn(x.to(cuda), dim=1).cpu(), want)
        first = [(row == row.max() if fn is torch.argmax else row == row.min())
                 .nonzero()[0, 0] for row in x]
        assert torch.equal(want, torch.stack(first))


@pytest.mark.parametrize("graph", [*tp.GRAPHS, "host"])
def test_partition_on_card_matches_golden_and_cpu(cuda, graph):
    golden = tp.load_golden()
    names = tp.HOST_CASES if graph == "host" else tp.case_names(graph)
    for name in names:
        got = tp.summary(tp.torch_result(name, "cuda"))
        assert got == golden[name], name
        assert got == tp.summary(tp.torch_result(name)), name


def test_sorted_equals_dense_on_card(cuda):
    from repro_torch.core.partition import PartitionConfig, partition
    from repro_torch.data import graphs as gen

    g = gen.rmat(12)
    res = {}
    for backend in ("dense", "sorted"):
        kernels.reset_launch_counts()
        res[backend] = partition(g, PartitionConfig(k=16, trials=2,
                                                    backend=backend))
        launched = kernels.launch_counts["segment_reduce"]
        assert (launched > 0) == (backend == "sorted"), launched
    assert tp.summary(res["sorted"]) == tp.summary(res["dense"])


def test_port_reads_equal_sync_debug_count(cuda):
    """``times["host_reads"]``, the reads the partitioner counts where it
    makes them, equals CUDA's sync debug mode's count of the same call on
    both backends the benchmark runs, after a warm call.  Switching the
    mode on warns once a process itself; that warning is not counted."""
    import warnings

    from repro_torch.core.partition import PartitionConfig, partition
    from repro_torch.data import graphs as gen

    for g, backend in ((gen.grid3d(24, 24, 24), "ell"),
                       (gen.rmat(12), "dense")):
        g = g.to(cuda)
        cfg = PartitionConfig(k=16, trials=2, backend=backend)
        partition(g, cfg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            del caught[:]
            try:
                res = partition(g, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        synced = sum("synchronizing" in str(w.message) for w in caught)
        assert res.times["host_reads"] == synced > 0, backend


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,f,d", [(1, 1, 1), (257, 39, 10), (4099, 8, 128),
                                   (512, 39, 300)])
def test_fm_interaction_matches_plain(cuda, b, f, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(b + f + d)
    emb = torch.randn(b, f, d, generator=gen, device=cuda).to(dtype)
    want = fm_interaction_ref(emb)
    before = kernels.launch_counts["fm_interaction"]
    got = fm_ops.fm_interaction(emb)
    again = fm_ops.fm_interaction(emb)
    torch.cuda.synchronize()
    assert kernels.launch_counts["fm_interaction"] == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert tp.fm_error_ratio(got, want, emb) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [8, 36, 64, 128, 256])
@pytest.mark.parametrize("shape", tp.FLASH_SHAPES)
def test_flash_attention_matches_plain(cuda, shape, d, dtype):
    h, hkv, sq, skv, causal, window, off = shape
    q, k, v = tp.qkv(2, h, hkv, sq, skv, d, dtype, seed=sq + skv + d,
                     device=cuda)
    want = flash_attention_ref(q, k, v, causal, window, off)
    before = kernels.launch_counts["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, causal, window, off)
    again = fa_ops.flash_attention(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention"] == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    assert tp.flash_error_ratio(got, want) <= 1
    # rows that see no key are exactly 0, as in the Pallas kernel
    dead = want.float().abs().amax(dim=-1) == 0
    assert bool((got[dead] == 0).all())


@pytest.mark.parametrize("d_dv", tp.FLASH_DV)
@pytest.mark.parametrize("shape", tp.FLASH_SHAPES)
def test_flash_attention_value_width_matches_plain(cuda, shape, d_dv):
    """Each dtype (float32, bfloat16, float16) in turn; then the shape with
    no query head (a sharded call's empty shard): an empty output, no
    launch."""
    h, hkv, sq, skv, causal, window, off = shape
    d, dv = d_dv
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v = tp.qkv(2, h, hkv, sq, skv, d, dtype, seed=sq + skv + dv,
                         device=cuda, dv=dv)
        want = flash_attention_ref(q, k, v, causal, window, off)
        before = kernels.launch_counts["flash_attention"]
        got = fa_ops.flash_attention(q, k, v, causal, window, off)
        again = fa_ops.flash_attention(q, k, v, causal, window, off)
        torch.cuda.synchronize()
        assert kernels.launch_counts["flash_attention"] == before + 2
        assert got.shape == (2, h, sq, dv)
        assert got.dtype == dtype and torch.equal(got, again), dtype
        assert tp.flash_error_ratio(got, want) <= 1, dtype
        # rows that see no key are exactly 0, as in the Pallas kernel
        dead = want.float().abs().amax(dim=-1) == 0
        assert bool((got[dead] == 0).all())
        before = dict(kernels.launch_counts)
        empty = fa_ops.flash_attention(q[:, :0], k[:, :0], v[:, :0], causal,
                                       window, off)
        torch.cuda.synchronize()
        assert empty.shape == (2, 0, sq, dv) and \
            dict(kernels.launch_counts) == before


def test_fm_serving_on_card_matches_cpu(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    arch = get_arch("fm")
    for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
        cpu = steps.build_cell(arch, name, device="cpu", smoke=True)
        card = steps.build_cell(
            arch, name, device=cuda, smoke=True,
            params={k: v.to(cuda) for k, v in cpu.args[0].items()})
        kernels.reset_launch_counts()
        got = card.step_fn(*card.args)
        torch.cuda.synchronize()
        assert kernels.launch_counts["fm_interaction"] == (
            0 if name == "retrieval_cand" else 1)
        np.testing.assert_allclose(got.cpu().numpy(),
                                   cpu.step_fn(*cpu.args).numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_lm_serving_on_card_matches_cpu(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = get_arch("gemma3-1b").smoke
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = tf.tree_to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
    fed = torch.from_numpy(rng.integers(0, cfg.vocab, (6, 2)))
    kernels.reset_launch_counts()
    for dev, p in (("cpu", params), (cuda, on_card)):
        logits, cache = tf.prefill(cfg, p, prompts.to(dev), max_len=46)
        out = [logits]
        for t in fed:
            logits, cache = tf.decode_step(cfg, p, cache, t.to(dev))
            out.append(logits)
        if dev == "cpu":
            want = out
    assert kernels.launch_counts["flash_attention"] == cfg.n_layers
    for got, w in zip(out, want):
        np.testing.assert_allclose(got.cpu().numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_moe_serving_on_card_matches_cpu(cuda):
    """DeepSeek-V2-Lite's smoke config (MLA + MoE, float32; its value width
    differs from its query width) with distinct experts: prefill, the
    compressed cache and decode on the card against the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = get_arch("deepseek-v2-lite-16b").smoke
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for w in params["layers"]["moe"].values():
        if isinstance(w, torch.Tensor) and w.dim() == 4:   # routed experts
            w.copy_(torch.rand(w.shape, generator=gen) * 0.3 - 0.15)
    on_card = tf.tree_to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
    fed = torch.from_numpy(rng.integers(0, cfg.vocab, (6, 2)))
    kernels.reset_launch_counts()
    for dev, p in (("cpu", params), (cuda, on_card)):
        logits, cache = tf.prefill(cfg, p, prompts.to(dev), max_len=46)
        out = [logits]
        for t in fed:
            logits, cache = tf.decode_step(cfg, p, cache, t.to(dev))
            out.append(logits)
        if dev == "cpu":
            want, want_cache = out, cache
    assert kernels.launch_counts["flash_attention"] == cfg.n_layers
    for got, w in zip(out, want):
        np.testing.assert_allclose(got.cpu().numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-4)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(cache[key].cpu().numpy(),
                                   want_cache[key].numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("b,t", [(3, 2), (2, 2), (5, 1)])
@pytest.mark.parametrize("d", [1, 6, 17, 33, 300])
def test_jet_gain_lane_weights_match_plain(cuda, d, b, t):
    """A fleet bucket's panels (B, T, N, D) with per-lane weights (B, N, D):
    row r reads weight row (r / (T*N))*N + r % N; exact against plain."""
    k = 64
    panels = [tp.panel(1500, d, k, t, seed=d + i, odd=True) for i in range(b)]
    ins = [torch.from_numpy(np.stack(a)) for a in zip(*panels)]
    want = jet_gain_ref(*ins, k)
    before = kernels.launch_counts["jet_gain"]
    got = ops.jet_gain_from_parts(*(x.to(cuda) for x in ins), k)
    torch.cuda.synchronize()
    assert kernels.launch_counts["jet_gain"] == before + 1
    for g_, w in zip(got, want):
        assert torch.equal(g_.cpu(), w)


def test_wrappers_take_strided_views(cuda):
    """Each wrapper takes a strided view on the card, launches once, and
    returns what its plain version returns for the same view."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    # jet_gain: panels sliced out of wider ones, parts every other column
    nbr_parts, wgt, parts = (torch.from_numpy(a).to(cuda)
                             for a in tp.panel(3000, 9, 16, 4, seed=1))
    views = (nbr_parts[..., :6], wgt[:, 2:8],
             torch.stack([parts, parts], -1)[..., 0])
    assert not any(v.is_contiguous() for v in views)
    cases = [("jet_gain", lambda: ops.jet_gain_from_parts(*views, 16),
              lambda: jet_gain_ref(*(v.contiguous() for v in views), 16))]
    data, seg, s = tp.segment_case(20_000, 6, "span", torch.float32, seed=2,
                                   device=cuda)
    dv, sv = data[:, ::2], torch.stack([seg, seg], -1)[:, 1]
    cases.append(("segment_reduce", lambda: sr.segment_sum_sorted(dv, sv, s),
                  lambda: segment_sum_sorted_ref(dv.contiguous(),
                                                 sv.contiguous(), s)))
    emb = torch.randn(300, 12, 20, generator=gen, device=cuda)[:, 1:, ::2]
    cases.append(("fm_interaction", lambda: fm_ops.fm_interaction(emb),
                  lambda: fm_interaction_ref(emb.contiguous())))
    q, k_, v = (torch.randn(2, 70, 4, 64, generator=gen, device=cuda)
                .transpose(1, 2) for _ in range(3))
    cases.append(("flash_attention",
                  lambda: fa_ops.flash_attention(q, k_, v, True, 16),
                  lambda: flash_attention_ref(q.contiguous(), k_.contiguous(),
                                              v.contiguous(), True, 16)))
    for name, call, plain in cases:
        before = kernels.launch_counts[name]
        got, want = call(), plain()
        torch.cuda.synchronize()
        assert kernels.launch_counts[name] == before + 1, name
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g_, w in zip(got, want):
            if name == "jet_gain":
                assert torch.equal(g_, w)
            elif name == "segment_reduce":
                assert tp.segment_error_ratio(g_, w, dv, sv, s) <= 1
            elif name == "fm_interaction":
                assert tp.fm_error_ratio(g_, w, emb) <= 1
            else:
                assert tp.flash_error_ratio(g_, w) <= 1


def test_fleet_on_card_matches_cpu_and_golden(cuda):
    """partition_fleet on the card, dense, sorted and ell: each member
    equals the CPU fleet's and the reference's standalone run (golden), at
    k = 8, T = 2."""
    for backend in ("dense", "sorted", "ell"):
        _fleet_on_card(backend)


def _fleet_on_card(backend):
    from repro_torch.core import graph as gr
    from repro_torch.core.partition import PartitionConfig, partition_fleet
    from repro_torch.data import graphs as gen

    name = f"fleet_{backend}_k8_t2"
    cfg = PartitionConfig(**tp.fleet_config_kwargs(name))
    graphs = tp.fleet_graphs(gr, gen)
    card = partition_fleet(graphs, cfg)
    cpu = partition_fleet(graphs, cfg, device="cpu")
    golden = tp.load_golden_fleet()[name]
    for c, h, want in zip(card.results, cpu.results, golden):
        assert tp.member_summary(c) == tp.member_summary(h) == want
        assert c.imbalance == h.imbalance


def test_serve_on_card_matches_golden(cuda):
    """PartitionServer on the card (its default device): the reference
    serve test's burst on every backend gives the reference's standalone
    results and dispatch log (golden); parts stay on the card."""
    import json

    from repro_torch.core import partition as pa
    from repro_torch.data import graphs as gen
    from repro_torch.launch import partition_serve as ps

    golden = tp.load_golden_serve()
    for name in tp.serve_case_names():
        server = ps.PartitionServer(tp.serve_config(ps, pa, name))
        assert server.device == torch.device("cuda", 0)
        got = tp.run_burst(server, tp.serve_burst(gen))
        assert [tp.member_summary(r) for r in got] == \
            golden[name]["members"], name
        assert json.loads(json.dumps(list(server.dispatch_log))) == \
            golden[name]["dispatch_log"], name
        assert all(r.parts.device.type == "cuda" for r in got)


def test_gnn_scatter_and_gather_on_card(cuda):
    """scatter_sum and gather_nodes on the card: forward and backward on the
    segment_reduce kernel (one launch each), against the CPU's plain
    version within its float32 tolerance, and bit for bit across two runs;
    ghost edges, an empty segment and (E, C, 3) data."""
    from repro_torch.models.gnn import common

    rng = np.random.default_rng(0)
    n, e = 300, 5000
    idx = rng.integers(0, n + 1, e).astype(np.int32)
    idx[idx == 7] = 8                        # node 7 receives nothing
    vals = rng.standard_normal((e, 4, 3)).astype(np.float32)
    x = rng.standard_normal((n, 4, 3)).astype(np.float32)
    w = rng.standard_normal((n, 4, 3)).astype(np.float32)

    def run(device):
        index = common.sorted_index(torch.from_numpy(idx).to(device), n)
        v = torch.from_numpy(vals).to(device).requires_grad_(True)
        h = torch.from_numpy(x).to(device).requires_grad_(True)
        before = kernels.launch_counts["segment_reduce"]
        s = common.scatter_sum(v, index, n)
        g = common.gather_nodes(h, index)
        (torch.sum(s * torch.from_numpy(w).to(device))
         + torch.sum(g * v.detach())).backward()
        launched = kernels.launch_counts["segment_reduce"] - before
        return [t.detach().cpu() for t in (s, g, v.grad, h.grad)], launched

    cpu, _ = run("cpu")
    card, launched = run(cuda)
    again, _ = run(cuda)
    assert launched == 2  # the scatter's forward, the gather's backward
    assert all(torch.equal(a, b) for a, b in zip(card, again))
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert float(card[0][7].abs().sum()) == 0.0


def test_gnn_training_on_card_matches_cpu(cuda):
    """One train step of each GNN's smoke config on the card: loss and
    gradients within 2e-4 of the CPU's, segment_reduce launched as
    ``chip_smoke.gnn_segment_sums`` counts, and the step bit for bit equal
    across two runs."""
    for arch_id in tp.GNN_ARCHS:
        _gnn_training_on_card(cuda, arch_id)


def _gnn_training_on_card(cuda, arch_id):
    import chip_smoke
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = get_arch(arch_id).smoke
    b_np = tp.gnn_batch(arch_id, cfg, seed=0)
    params = steps.GNN_MODULES[arch_id].init_params(
        cfg, torch.Generator().manual_seed(0))
    loss = steps.gnn_loss(arch_id, cfg, 3)

    def batch(device):
        return steps.with_edge_plan(
            {k: torch.from_numpy(v).to(device) for k, v in b_np.items()}, 3)

    (l_cpu, _), g_cpu = loop.value_and_grad(loss, params, batch("cpu"))
    p_card = tree.tree_map(lambda x: x.to(cuda), params)
    b_card = batch(cuda)
    before = kernels.launch_counts["segment_reduce"]
    (l_card, _), g_card = loop.value_and_grad(loss, p_card, b_card)
    torch.cuda.synchronize()
    assert kernels.launch_counts["segment_reduce"] - before == \
        chip_smoke.gnn_segment_sums(arch_id, cfg)
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=2e-4, atol=2e-4)
    for a, b in zip(tree.leaves(g_card), tree.leaves(g_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-4)
    step = loop.build_train_step(loss, adamw.AdamWConfig())
    zero = torch.zeros((), device=cuda)
    one, two = (step(p_card, adamw.init_state(p_card), zero, b_card)
                for _ in range(2))
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(one[:2]), tree.leaves(two[:2])))


def test_partitioned_gnn_one_rank_on_card(cuda):
    """The partitioned MeshGraphNet step at world size 1 on the card (NCCL,
    the smoke config on a 16x16 mesh): loss within 1e-4 relative and
    gradients within ``chip_smoke.GNN_GRAD_RL2`` of the dense path's,
    segment_reduce launched ``chip_smoke.partitioned_segment_sums`` times a
    step, and the step bit for bit equal across two runs."""
    import chip_smoke
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import gnn_partitioned as gp
    from repro_torch.models.gnn import meshgraphnet
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = get_arch("meshgraphnet").smoke
    data = synthetic.mesh_batch(16, 16, seed=0)
    graph = data["graph"]
    n = graph.node_feat.shape[0]
    edges = torch.stack([graph.senders, graph.receivers], 1).numpy()
    batch, stats = gp.build_partitioned_batch(
        n, graph.node_feat.numpy(), graph.pos.numpy(),
        data["target"].numpy(), edges, np.zeros(n, np.int64), 1, 512, 2048,
        8)
    assert stats == {"dropped_edges": 0, "dropped_halo": 0}
    params = meshgraphnet.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0))
    dense = {"graph": graph._replace(
        **{f: getattr(graph, f).to(cuda) for f in (
            "node_feat", "senders", "receivers", "pos", "graph_id")},
        plan=None), "target": data["target"].to(cuda)}
    (l_d, _), g_d = loop.value_and_grad(
        lambda p, b: meshgraphnet.loss_fn(cfg, p, b), params, dense)
    gp.init_rank(0, 1, gp.free_port(), cuda)
    try:
        ex = gp.Exchange()
        block = gp.with_local_plan(gp.rank_block(batch, 0, 1, cuda), 1)
        kernels.reset_launch_counts()
        loss, grads = gp.value_and_grad(cfg, params, block, ex)
        torch.cuda.synchronize()
        assert kernels.launch_counts["segment_reduce"] == \
            chip_smoke.partitioned_segment_sums(cfg)
        step = gp.make_step(cfg, ex)
        one, two = (step(params, adamw.init_state(params), block)
                    for _ in range(2))
    finally:
        torch.distributed.destroy_process_group()
    assert abs(float(loss) - float(l_d)) <= 1e-4 * abs(float(l_d))
    assert chip_smoke._rel_l2(grads, g_d) <= chip_smoke.GNN_GRAD_RL2
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(one[:2]), tree.leaves(two[:2])))


@pytest.mark.parametrize("shape", tp.FLASH_SHAPES)
def test_flash_attention_backward_matches_plain(cuda, shape):
    """The forward with its log-sum-exp (output bitwise unchanged) and the
    backward kernels against ``flash_attention_bwd_ref`` from the plain
    forward in float32, bfloat16 and float16 at every (D, Dv) of
    ``chip_smoke.FLASH_BWD_WIDTHS``: relative L2 1e-4 in float32, 2e-2 in
    bfloat16 and float16; two launches bitwise equal; the autograd
    Function launches the forward and the backward once each, the backward
    on its dtype's route (float32 on CUDA cores, 16-bit on the tensor
    cores); dq is 0 on rows that see no key."""
    import chip_smoke
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)

    h, hkv, sq, skv, causal, window, off = shape
    for dtype, (d, dv) in itertools.product(
            (torch.float32, torch.bfloat16, torch.float16),
            chip_smoke.FLASH_BWD_WIDTHS):
        q, k, v = tp.qkv(2, h, hkv, sq, skv, d, dtype, seed=d, device=cuda,
                         dv=dv)
        do = torch.randn(2, h, sq, dv, device=cuda).to(dtype)
        o0 = fa_ops._flash_attention_cuda(q, k, v, causal, window, off)
        o, lse = fa_ops._flash_attention_cuda(q, k, v, causal, window, off,
                                              with_lse=True)
        assert torch.equal(o0, o)
        o_ref, lse_ref = flash_attention_ref(q, k, v, causal, window, off,
                                             return_lse=True)
        want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal,
                                       window, off)
        lq, lk, lv = (x.clone().requires_grad_(True) for x in (q, k, v))
        before = dict(kernels.launch_counts)
        launched = dict(fa_ops.bwd_launches)
        out = fa_ops.flash_attention(lq, lk, lv, causal, window, off)
        out.backward(do)
        torch.cuda.synchronize()
        for name in ("flash_attention", "flash_attention_bwd"):
            assert kernels.launch_counts[name] == before.get(name, 0) + 1
        source = fa_ops.BWD_SOURCES[dtype]
        assert fa_ops.bwd_launches[source] == launched.get(source, 0) + 1
        got = (lq.grad, lk.grad, lv.grad)
        again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                           window, off)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            rel = float((g.float() - w.float()).norm()
                        / w.float().norm().clamp(min=1e-30))
            assert rel <= tol, (dtype, d, dv, rel)
        assert bool((got[0][torch.isneginf(lse_ref)] == 0).all())


def test_fm_interaction_backward_matches_plain(cuda):
    """The backward kernel against ``fm_interaction_bwd_ref``, in float32,
    bfloat16 and float16: float32 within 1e-6 relative L2, 16-bit within
    one rounding step; two launches bitwise equal; a strided view."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        _fm_backward_matches_plain(cuda, dtype)


def _fm_backward_matches_plain(cuda, dtype):
    from repro_torch.kernels.fm_interaction.ref import fm_interaction_bwd_ref

    for b, f, d in ((1, 0, 10), (257, 1, 1), (4096, 39, 10), (3, 2, 12288)):
        e = torch.randn(b, f, d, device=cuda).to(dtype)
        g = torch.randn(b, device=cuda)
        got, again = (fm_ops.fm_interaction_bwd(e, g) for _ in range(2))
        want = fm_interaction_bwd_ref(e, g)
        assert torch.equal(got, again) and got.dtype == dtype
        if got.numel() == 0:
            continue
        if not bool(want.any()):
            # F = 1: every gradient is s - e = 0 exactly
            assert torch.equal(got, want)
            continue
        w = want.float()
        if dtype == torch.float32:
            assert float((got - w).norm() / w.norm()) <= 1e-6
        else:
            step = torch.finfo(dtype).eps * w.abs() + torch.finfo(dtype).tiny
            assert bool(((got.float() - w).abs() <= step).all())
    e = torch.randn(999, 40, 24, device=cuda).to(dtype)[:, 1:, ::2]
    g = torch.randn(999, device=cuda)
    torch.testing.assert_close(fm_ops.fm_interaction_bwd(e, g),
                               fm_interaction_bwd_ref(e.contiguous(), g),
                               rtol=1e-2, atol=1e-5)
    # a contiguous view whose base is not 16-byte aligned
    e = torch.randn(999 * 39 * 10 + 1, device=cuda).to(dtype)[1:] \
        .view(999, 39, 10)
    assert e.data_ptr() % 16 != 0
    torch.testing.assert_close(fm_ops.fm_interaction_bwd(e, g),
                               fm_interaction_bwd_ref(e, g),
                               rtol=1e-2, atol=1e-5)


def test_lm_and_fm_training_on_card_matches_cpu(cuda):
    """One smoke train step's loss and gradients on the card within 2e-4
    of the CPU's, for gemma3-1b, deepseek-v2-lite-16b, moonshot-v1-16b-a3b
    and fm; the launches a step as ``chip_smoke`` counts them (MoE layers
    add their combine's sums and their gather's gradient on
    segment_reduce); the step (gradient and AdamW update) bit for bit
    across two runs, the MoE configs' included."""
    for arch_id in ("gemma3-1b", "deepseek-v2-lite-16b",
                    "moonshot-v1-16b-a3b", "fm"):
        _lm_or_fm_training_on_card(cuda, arch_id)


def _lm_or_fm_training_on_card(cuda, arch_id):
    import chip_smoke
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import fm
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    arch = get_arch(arch_id)
    cfg = arch.smoke
    gen = torch.Generator().manual_seed(0)
    if arch.family == "lm":
        params = tf.init_params(cfg, gen)
        b = next(synthetic.lm_batches(cfg.vocab, 2, 64, seed=0))

        def loss(p, bb):
            return tf.loss_fn(cfg, p, bb)
        want = {"flash_attention": chip_smoke.lm_flash_launches(cfg)[0],
                "flash_attention_bwd": chip_smoke.lm_flash_launches(cfg)[1]}
    else:
        params = fm.init_params(cfg, gen)
        b = next(synthetic.recsys_batches(cfg.n_fields, cfg.rows_per_field,
                                          64, seed=0))

        def loss(p, bb):
            return fm.loss_fn(cfg, p, bb)
        want = {"fm_interaction": 1, "fm_interaction_bwd": 1}
    want["segment_reduce"] = chip_smoke.lm_segment_sums(cfg) \
        if arch.family == "lm" else chip_smoke.EMBED_SEGMENT_SUMS["recsys"]
    (l_cpu, _), g_cpu = loop.value_and_grad(loss, params, b)
    p_card = tree.tree_map(lambda x: x.to(cuda), params)
    b_card = {k: v.to(cuda) for k, v in b.items()}
    kernels.reset_launch_counts()
    (l_card, _), g_card = loop.value_and_grad(loss, p_card, b_card)
    torch.cuda.synchronize()
    assert {k: kernels.launch_counts[k] for k in want} == want
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=2e-4, atol=2e-4)
    for a, c in zip(tree.leaves(g_card), tree.leaves(g_cpu)):
        torch.testing.assert_close(a.cpu(), c, rtol=2e-4, atol=2e-4)
    step = steps.make_train_step(loss)
    one, two = (step(p_card, adamw.init_state(p_card), b_card)
                for _ in range(2))
    assert all(torch.equal(x, y) for x, y in
               zip(tree.leaves(one[:2]), tree.leaves(two[:2])))


def test_sharded_step_one_rank_on_card_is_bitwise(cuda):
    """The smoke configs of gemma3-1b and deepseek-v2-lite-16b through
    ``steps.sharded_step`` on a one-rank NCCL mesh: a train step, a
    prefill and a decode step on its cache, bit for bit the unsharded
    cells' on the card, with the same kernel launches."""
    from repro_torch import tree
    from repro_torch.launch import gnn_partitioned as gp
    from repro_torch.launch import lm_sharded, steps
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import compat_make_mesh

    def run(arch_id, mesh):
        out, cache, launches = [], None, []
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            cell = lm_sharded.registry_cell(arch_id, shape, cuda, mesh)
            args, step = (cell.args, cell.step_fn) if mesh is None else (
                steps.sharded_args(cell, mesh),
                steps.sharded_step(cell, mesh))
            if shape == "decode_32k":
                args = (args[0], cache, args[2])
            kernels.reset_launch_counts()
            res = step(*args)
            torch.cuda.synchronize()
            launches.append(dict(kernels.launch_counts))
            if shape == "prefill_32k":
                cache = res[1]
            out.append(tree.tree_map(lambda x: x.clone() if isinstance(
                x, torch.Tensor) else x, res if mesh is None else
                sh.full(res)))
        return out, launches

    gp.init_rank(0, 1, gp.free_port(), cuda)
    try:
        mesh = compat_make_mesh((1, 1), ("data", "model"), "cuda")
        for arch_id in ("gemma3-1b", "deepseek-v2-lite-16b"):
            want, want_launches = run(arch_id, None)
            got, got_launches = run(arch_id, mesh)
            assert got_launches == want_launches, arch_id
            for g, w in zip(got, want):
                for a, b in zip(tree.leaves(g), tree.leaves(w)):
                    assert (torch.equal(a, b) if isinstance(b, torch.Tensor)
                            else a == b), arch_id
    finally:
        torch.distributed.destroy_process_group()
