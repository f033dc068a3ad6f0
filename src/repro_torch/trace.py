"""Spans on the profiler's clock and a per-call record of host reads.

* :func:`span` names a stretch of host work.  With no torch profiler
  recording it returns one shared no-op context (no allocation, no import);
  under ``torch.profiler`` it is a host event of that name, nested under
  the span around it and on the same clock as the device's operations.
  It is a ``_RecordFunctionFast`` and not a ``record_function``: the
  latter also puts a user annotation on the device's timeline, which
  covers the idle gaps inside it as if the device were busy.
  :func:`spanned` makes a whole function one span.
* :func:`read` is the one door of every synchronizing point on the
  partitioner's path (``.tolist()``, ``.cpu()``, ``.item()`` of a device
  tensor, an upload from pageable host memory): it counts the read and
  the seconds the host was blocked in it, always, and is a span
  ``read.<site>`` under the profiler.  Its count is meant to be the one
  CUDA's sync debug mode gives, which does not count
  ``torch.cuda.synchronize``.
* :class:`CallRecord` holds one call's counts and host seconds.
  ``partition()`` and ``partition_fleet_stacked()`` open one with
  :func:`call`; the refinement loop and the jet_gain wrapper add to the
  current one (:func:`current`).  The current record is a context
  variable, so calls on two threads never share one.  Outside a call they
  add to a record that nobody reads.
"""
from __future__ import annotations

import contextvars
import functools
import time

import torch

_enabled = torch.autograd._profiler_enabled
clock = time.perf_counter_ns
_Span = torch._C._profiler._RecordFunctionFast


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context naming host work ``name`` in a running profiler's trace."""
    if not _enabled():
        return _NO_SPAN
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function is one ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class CallRecord:
    """Host reads and host-clock nanoseconds of one call."""

    __slots__ = ("reads", "read_ns", "refine_wait_ns", "refine_loop_ns",
                 "jet_gain_ns")

    def __init__(self):
        self.reads = 0            # reads through read()
        self.read_ns = 0          # the host blocked in them
        self.refine_wait_ns = 0   # ... in the refinement loop's reads
        self.refine_loop_ns = 0   # the refinement loop's host wall time
        self.jet_gain_ns = 0      # host time in the jet_gain wrapper

    def times(self) -> dict:
        """The entries a result's ``times`` takes from this record."""
        return {"host_reads": self.reads,
                "refine_wait_s": self.refine_wait_ns / 1e9,
                "refine_issue_s": (self.refine_loop_ns
                                   - self.refine_wait_ns) / 1e9,
                "jet_gain_host_s": self.jet_gain_ns / 1e9}


_IDLE = CallRecord()   # current outside any call: read by nobody
_current = contextvars.ContextVar("repro_torch_trace_call", default=_IDLE)


def current() -> CallRecord:
    """The open call's record (this thread's, this context's)."""
    return _current.get()


class call:
    """``with call() as rec:`` makes a fresh record current for one call,
    and the one before current again at exit.  A call inside an open one
    (``partition_fleet`` around ``partition_fleet_stacked``) adds to it."""

    __slots__ = ("_token",)

    def __enter__(self) -> CallRecord:
        rec = _current.get()
        if rec is _IDLE:
            rec = CallRecord()
        self._token = _current.set(rec)
        return rec

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


def read(site: str, fn):
    """``fn()``, a synchronizing read, counted and timed in the current
    record; a span ``read.<site>`` under the profiler."""
    with span("read." + site):
        t0 = clock()
        out = fn()
        dt = clock() - t0
    rec = _current.get()
    rec.reads += 1
    rec.read_ns += dt
    return out
