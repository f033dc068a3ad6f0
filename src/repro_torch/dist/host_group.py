"""A process group that carries the collectives of several ranks on one
card: ``gloo_host``.

NCCL takes one rank a card, and gloo ends the processes of ranks whose
DTensor collectives (the functional all-gather, reduce-scatter and
all-to-all) hand it CUDA tensors (torch 2.11), although the same
collectives through ``torch.distributed``'s own functions carry them; so a
sharded program on DTensors cannot run several ranks on one card with
either.  This group stages every collective through host memory: it
copies each input to a contiguous host buffer, runs the collective on a
gloo group over the CPU copies, and copies the result back into the
caller's tensor (on a CPU tensor the staging is a plain copy).  Every call
finishes before it returns; its ``Work`` is gloo's, already complete.

What it carries (the methods DTensor's functional collectives and
``launch/gnn_partitioned.Exchange`` reach): all-reduce, all-gather (list
and tensor forms, coalesced), reduce-scatter (tensor form, emulated: an
all-reduce of the whole input and this rank's block), all-to-all (tensor
form), broadcast and barrier.  Any other collective raises.
``CommDebugMode`` counts at the functional collectives' level, above the
group, so the emulation changes no count.

The group is used only where a caller names it
(``init_process_group(BACKEND, ...)`` after :func:`register`, or
``launch/gnn_partitioned.init_rank(..., backend=BACKEND)``): nothing picks
it on its own.  It moves every byte through host memory and is meant for
checking numbers with several ranks on one card, not for timing an
exchange.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BACKEND = "gloo_host"


def _stage(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t``."""
    return torch.empty(t.shape, dtype=t.dtype).copy_(t)


def _done(work):
    work.wait()
    return work


class HostStagedGroup(dist.ProcessGroup):
    """One rank's group of ``BACKEND`` (see the module): each collective
    runs on a gloo group over host copies of its tensors."""

    def __init__(self, store, rank: int, world: int, timeout):
        super().__init__(rank, world)
        self._rank, self._world = rank, world
        self._name = ""
        self._gloo = dist.ProcessGroupGloo(store, rank, world, timeout)

    def getBackendName(self) -> str:
        return BACKEND

    # a group with no C++ backend keeps its own name (the functional
    # collectives find the group by it)
    def _set_group_name(self, name: str) -> None:
        self._name = name

    setGroupName = _set_group_name

    @property
    def group_name(self) -> str:
        return self._name

    def getGroupName(self) -> str:
        return self._name

    # -- all-reduce, broadcast, barrier ------------------------------------

    def allreduce(self, tensors, opts=None):
        opts = opts or dist.AllreduceOptions()
        host = [_stage(t) for t in tensors]
        work = _done(self._gloo.allreduce(host, opts))
        for t, h in zip(tensors, host):
            t.copy_(h)
        return work

    def allreduce_coalesced(self, tensors, opts=None):
        ar = dist.AllreduceOptions()
        if opts is not None:
            ar.reduceOp = opts.reduceOp
        return self.allreduce(tensors, ar)

    def broadcast(self, tensors, opts=None):
        opts = opts or dist.BroadcastOptions()
        host = [_stage(t) for t in tensors]
        work = _done(self._gloo.broadcast(host, opts))
        for t, h in zip(tensors, host):
            t.copy_(h)
        return work

    def barrier(self, opts=None):
        return _done(self._gloo.barrier(dist.BarrierOptions()))

    # -- all-gather ----------------------------------------------------------

    def allgather(self, output_lists, inputs, opts=None):
        opts = opts or dist.AllgatherOptions()
        host_in = [_stage(t) for t in inputs]
        host_out = [[torch.empty(o.shape, dtype=o.dtype) for o in outs]
                    for outs in output_lists]
        work = _done(self._gloo.allgather(host_out, host_in, opts))
        for outs, hs in zip(output_lists, host_out):
            for o, h in zip(outs, hs):
                o.copy_(h)
        return work

    def _allgather_base(self, output, input, opts=None):
        """``output`` (world * n, ...) <- every rank's ``input`` (n, ...),
        rank r's at rows [r n, (r + 1) n)."""
        host = torch.empty(output.shape, dtype=output.dtype)
        work = self.allgather([list(host.chunk(self._world))], [input],
                              opts)
        output.copy_(host)
        return work

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        work = None
        for o, i in zip(outputs, inputs):
            work = self._allgather_base(o, i, opts)
        return work

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    # -- reduce-scatter (an all-reduce and this rank's block) -------------

    def _reduce_scatter_base(self, output, input, opts=None):
        """``output`` (n, ...) <- the reduction over ranks of this rank's
        block, rows [rank n, (rank + 1) n), of ``input`` (world * n,
        ...)."""
        ar = dist.AllreduceOptions()
        if opts is not None:
            ar.reduceOp = opts.reduceOp
        host = _stage(input)
        work = _done(self._gloo.allreduce([host], ar))
        output.copy_(host.chunk(self._world)[self._rank])
        return work

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        work = None
        for o, i in zip(outputs, inputs):
            work = self._reduce_scatter_base(o, i, opts)
        return work

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    # -- all-to-all --------------------------------------------------------

    def alltoall_base(self, output, input, output_splits, input_splits,
                      opts=None):
        """Rows of ``input`` to every rank (``input_splits`` rows each,
        equal blocks when empty), ``output`` from every rank."""
        opts = opts or dist.AllToAllOptions()
        host_in = _stage(input)
        host_out = torch.empty(output.shape, dtype=output.dtype)
        work = _done(self._gloo.alltoall_base(
            host_out, host_in, list(output_splits), list(input_splits),
            opts))
        output.copy_(host_out)
        return work

    all_to_all_single = alltoall_base

    # -- what it does not carry --------------------------------------------

    def _refuse(self, *a, **k):
        raise NotImplementedError(
            f"the {BACKEND} group carries all-reduce, all-gather, "
            "reduce-scatter (tensor form), all-to-all (tensor form), "
            "broadcast and barrier, nothing else")

    send = recv = recv_anysource = reduce = gather = scatter = alltoall = \
        reduce_scatter = allgather_coalesced = _refuse


def _create(store, rank, world, timeout):
    return HostStagedGroup(store, rank, world, timeout)


def register() -> str:
    """Register ``BACKEND`` with ``torch.distributed`` (for CPU and CUDA
    tensors; once a process).  Returns its name."""
    if BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(BACKEND, _create,
                                      devices=["cpu", "cuda"])
    return BACKEND
