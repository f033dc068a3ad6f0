"""Flops, transcendentals and bytes of a step, counted op by op as it runs
(counterpart of ``repro.launch.hlo_cost``).

The reference reads compiled HLO text and must multiply each loop body by
its trip count.  Here :class:`OpCost` is a ``TorchDispatchMode``: it sees
every aten op the step dispatches, on real or fake tensors, so a loop over
microbatches, a checkpoint's recompute and every backward op are counted
as often as they run.

Counting rules, after ``hlo_cost.py``'s:

* flops: matrix products by ``torch.utils.flop_counter``'s formulas
  (2 x the product of the output's and the contracted dims); one flop an
  output element of a pointwise op (``torch.Tag.pointwise``) and of a
  reduction; the few aten ops that XLA writes as several element-wise steps
  (softmax, SiLU and their backward) count those steps (``_COMPOSITE``).
* transcendentals: one an element for the reference's ``_TRANSCENDENTAL``
  set (exp, log, tanh, rsqrt, sqrt, logistic, sin, cos, expm1, log1p, erf,
  atan2), each also a flop.
* bytes: the operands plus the outputs of each op.  In eager PyTorch every
  op is a round trip to device memory, as a top-level fusion is in XLA.
  Views, ``detach`` and factory ops are free, as the reference's ``_FREE``
  set is.  Indexed ops pay only for the region they touch (``hlo_cost.py``
  :221-235): a gather reads and writes its output's bytes, a scatter or
  ``index_put_`` reads the region and the updates and writes the region,
  a ``slice_scatter`` reads and writes its update.
* the hand-written kernels (the ``repro_torch`` custom ops,
  ``kernels/__init__.py``) are counted by their formulas
  (``kernels.op_costs``), never by what runs inside them: a kernel and its
  plain version count the same.

With ``track_memory`` the mode also keeps the bytes of every live storage
that the step's ops made or that :meth:`OpCost.track` was given (its
inputs): ``peak_bytes`` is the most held at once, the fake run's
counterpart of ``torch.cuda.max_memory_allocated``.  Work inside a custom
op (a kernel's scratch) is not seen.

``per_device`` counts a sharded step (DTensors, ``steps.sharded_step``) as
one device runs it: the mode lets each DTensor op desugar into the ops on
this rank's local shards and its collectives (as ``CommDebugMode`` does),
and counts those; the inputs' live bytes are their local shards.  The ops
that DTensor's sharding propagation runs on fake tensors of the global
shapes, to learn an output's shape or an op's strategy from its
decomposition, are not the device's and are not counted
(:func:`_propagation_uncounted`).  Each
collective of ``torch.distributed._functional_collectives`` is counted by
kind under the reference's names (``KINDS``), with the bytes of its
result, as the reference's ``parse_collectives`` counts the result type
of each collective op; it adds no flops and no device-memory bytes.  A
shard-to-shard redistribution is one all-to-all, as a card's mesh issues it
(``_dtensor.shard_dim_alltoall``): on a host mesh DTensor would run an
all-gather and a chunk instead (gloo has no all-to-all), so the count runs
the card's op there too (:func:`_card_alltoall`).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# registers every kernel's custom op and cost formula in kernels.op_costs
from repro_torch.kernels import op_costs
from repro_torch.kernels.flash_attention import ops as _flash  # noqa: F401
from repro_torch.kernels.fm_interaction import ops as _fm  # noqa: F401
from repro_torch.kernels.jet_gain import ops as _jet_gain  # noqa: F401
from repro_torch.kernels.segment_reduce import ops as _segment  # noqa: F401

_TRANSCENDENTAL = {"exp", "log", "tanh", "rsqrt", "sqrt", "sigmoid", "sin",
                   "cos", "expm1", "log1p", "erf", "atan2"}
# (flops, transcendentals) an element of the op's first operand
_COMPOSITE = {
    "_softmax": (3, 1),                  # max, subtract, exp, sum, divide
    "_log_softmax": (3, 1),              # max, subtract, exp, sum, log
    "_softmax_backward_data": (3, 0),    # g y, its sum, y (g - s)
    "_log_softmax_backward_data": (3, 1),  # exp y, its product, subtract
    "silu": (2, 1),                      # logistic, multiply
    "silu_backward": (5, 1),
    "softplus": (3, 2),                  # log1p(exp x)
    "sigmoid_backward": (3, 0),
    "tanh_backward": (3, 0),
    "logsumexp": (2, 1),
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
               "argmax", "argmin", "any", "all", "cumsum", "cumprod",
               "nansum", "count_nonzero", "aminmax"}
_FREE = {"detach", "alias", "_unsafe_view", "lift_fresh", "empty_like",
         "zeros_like", "ones_like", "full_like", "new_empty", "new_zeros",
         "new_ones", "new_full", "empty_strided", "_local_scalar_dense",
         "set_", "resize_"}
_GATHERS = {"index", "gather", "index_select", "embedding", "take"}
# scatters: the position of their updates argument
_SCATTERS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
             "scatter_reduce": 3, "scatter_reduce_": 3, "index_add": 3,
             "index_add_": 3, "index_copy": 3, "index_copy_": 3}
_UPDATES = {"slice_scatter": 1, "select_scatter": 1, "diagonal_scatter": 1}
_WRITES = {"fill_", "zero_"}  # write their output, read nothing
# functional collectives -> the reference's kinds (dryrun.py _COLLECTIVES)
COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               # DTensor's shard-to-shard redistribution on a card's mesh
               "shard_dim_alltoall": "all-to-all"}
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _tensors(tree) -> list:
    """The tensors in an op's arguments or outputs (nested lists, tuples
    and dicts); a DTensor's local shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return [tree._local_tensor]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def op_bytes(func, args, kwargs, out) -> int:
    """Device-memory bytes of one dispatched aten op (the rules above)."""
    name = func._overloadpacket.__name__
    ins = _tensors((args, kwargs))
    if func.is_view or name in _FREE or not ins:
        return 0
    outs = _tensors(out)
    out_bytes = sum(_bytes(t) for t in outs)
    if name in _GATHERS:
        return 2 * out_bytes
    if name in _SCATTERS or name in _UPDATES:
        pos = _SCATTERS.get(name, _UPDATES.get(name))
        upd = args[pos] if len(args) > pos else None
        if isinstance(upd, torch.Tensor):
            upd_bytes = _bytes(upd)
        else:  # a scalar written at every index
            upd_bytes = args[2].numel() * args[0].element_size()
        return (3 if name in _SCATTERS else 2) * upd_bytes
    if name in _WRITES:
        return out_bytes
    if name == "copy_":  # reads the source, writes the destination
        return _bytes(args[1]) + out_bytes
    return sum(_bytes(t) for t in ins) + out_bytes


def op_flops(func, args, kwargs, out) -> tuple[int, int]:
    """(flops, transcendentals) of one dispatched aten op."""
    packet = func._overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out)), 0
    name = packet.__name__
    name = name[:-1] if name.endswith("_") else name  # in place: as out
    if name in _COMPOSITE:
        per, trans = _COMPOSITE[name]
        n = _tensors(args)[0].numel()
        return per * n, trans * n
    if torch.Tag.pointwise in func.tags:
        n = sum(t.numel() for t in _tensors(out))
        return n, (n if name in _TRANSCENDENTAL else 0)
    if name in _REDUCTIONS:
        return _tensors(out)[0].numel(), 0
    return 0, 0


class OpCost(TorchDispatchMode):
    """Counts the flops, transcendentals and bytes of every op dispatched
    under it (the module's rules); ``flops_16bit`` is the part of the flops
    whose op's first input is a 16-bit float (what tensor cores can take),
    and ``by_kernel`` has the calls and cost of each hand-written kernel."""

    def __init__(self, track_memory: bool = False, per_device: bool = False):
        super().__init__()
        self.per_device = per_device
        self.paused = 0    # inside DTensor's shape propagation
        self.collectives = {k: {"count": 0, "bytes": 0} for k in KINDS}
        self.flops = self.transcendentals = self.bytes = self.ops = 0
        self.flops_16bit = 0
        self.by_kernel: dict = defaultdict(Counter)
        self.track_memory = track_memory
        self.live_bytes = self.peak_bytes = 0
        self._refs: dict = {}

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (a step's
        inputs, made before the mode was entered)."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda _, k=key, n=n:
                                          self._free(k, n))
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key, n) -> None:
        self._refs.pop(key, None)
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if self.per_device and any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # count the local ops it desugars into
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        if func.namespace == "prim":  # a fake tensor's device query
            return out
        if func.namespace in ("_c10d_functional", "c10d_functional",
                              "_dtensor"):
            kind = COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is not None:
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["bytes"] += sum(
                    _bytes(t) for t in _tensors(out))
            return out
        name = func._schema.name
        formula = op_costs.get(name)
        if formula is not None:
            c = formula(*args, **kwargs)
            flops, trans, nbytes = (c["flops"], c["transcendentals"],
                                    c["bytes"])
            self.by_kernel[name.split("::")[-1]].update(calls=1, **c)
        else:
            flops, trans = op_flops(func, args, kwargs, out)
            nbytes = op_bytes(func, args, kwargs, out)
        self.flops += flops
        ins = _tensors(args)
        if ins and ins[0].element_size() == 2 and ins[0].is_floating_point():
            self.flops_16bit += flops
        self.transcendentals += trans
        self.bytes += nbytes
        self.ops += 1
        if self.track_memory:
            self.track(out)
        return out

    def result(self) -> dict:
        out = {"flops": self.flops, "transcendentals": self.transcendentals,
               "bytes": self.bytes, "ops": self.ops,
               "flops_16bit": self.flops_16bit,
               "by_kernel": {k: dict(v) for k, v in
                             sorted(self.by_kernel.items())}}
        if self.track_memory:
            out["peak_bytes"] = self.peak_bytes
        if self.per_device:
            c = {k: dict(v) for k, v in self.collectives.items()}
            c["total_bytes"] = sum(v["bytes"] for v in self.collectives
                                   .values())
            c["total_count"] = sum(v["count"] for v in self.collectives
                                   .values())
            out["collectives"] = c
        return out


def _propagation_methods() -> list[tuple[type, str]]:
    """(class, method) of each place where DTensor's sharding propagation
    runs ops on fake tensors of the global shapes: the output's shape, and
    (where this torch has it) the strategy of an op read off its
    decomposition (SiLU's or softplus's backward, say)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError("this torch's DTensor has no shape propagation "
                           "to leave out of a per-device count")
    out = [(ShardingPropagator, name)]
    try:
        from torch.distributed.tensor._decompositions import \
            DecompShardingStrategy
    except ImportError:
        return out
    return out + [(DecompShardingStrategy, "propagate_strategy")]


@contextlib.contextmanager
def _propagation_uncounted(mode: OpCost):
    """Within it, the ops of DTensor's sharding propagation (run on fake
    tensors of the global shapes, and only on its cache's misses;
    :func:`_propagation_methods`) pause ``mode``."""
    patched = []

    def paused_version(orig):
        def paused(self, *a, **k):
            mode.paused += 1
            try:
                return orig(self, *a, **k)
            finally:
                mode.paused -= 1
        return paused

    try:
        for cls, name in _propagation_methods():
            orig = getattr(cls, name)
            setattr(cls, name, paused_version(orig))
            patched.append((cls, name, orig))
        yield
    finally:
        for cls, name, orig in patched:
            setattr(cls, name, orig)


@contextlib.contextmanager
def _card_alltoall():
    """Within it, DTensor's shard-to-shard redistribution on a host
    (``cpu``) mesh issues the all-to-all it issues on a card's mesh
    (``torch.ops._dtensor.shard_dim_alltoall``), not its host fallback of an
    all-gather and a chunk: the count is of what a card's mesh runs."""
    from torch.distributed.tensor import placement_types

    orig = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def analyze_step(fn, *args, track_memory: bool = False,
                 per_device: bool = False) -> dict:
    """``fn(*args)`` run once under :class:`OpCost`: {"flops",
    "transcendentals", "bytes", "ops", "flops_16bit", "by_kernel":
    {kernel: {"calls",
    "flops", "transcendentals", "bytes"}}} (the role of ``analyze_hlo``),
    with ``peak_bytes`` (``args`` counted live from the start) where
    ``track_memory``; with ``per_device`` (a sharded step) one device's
    counts and its ``collectives``.  ``fn``'s own result is dropped."""
    mode = OpCost(track_memory, per_device)
    if track_memory:
        mode.track(args)
    with (_propagation_uncounted(mode) if per_device
          else contextlib.nullcontext()), \
            (_card_alltoall() if per_device else contextlib.nullcontext()), \
            mode:
        fn(*args)
    return mode.result()
