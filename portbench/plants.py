"""Departures from the program that the comparison deciding ``correct``
has to catch: the control and the faults.  The benchmark's own runs never
use them; ``readings.py`` reads them on the card at a cell's own size and
``check_faults.py`` on the host at a small one.

* ``control``: the program with its balance slack doubled (lam 0.06 where
  the configuration states 0.03), the step that would tempt a change for a
  lower cut: it breaks the stated balance guarantee.
* ``state_unchanged``: every refinement returns the state it was given
  (the loop runs no iteration), so the answer is the projected initial
  partition.
* ``half_batch``: half of the batch left out: half of the trials of a
  ``partition()`` call, or half of the graphs of a fleet.
* ``answer_altered``: one vertex of every trial's best partition moved to
  another part where refinement produces it, the reported cuts kept.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _swapped(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _swapped_item(d: dict, key, value):
    old = d[key]
    d[key] = value
    try:
        yield
    finally:
        d[key] = old


@contextlib.contextmanager
def control(system):
    lam = system.settings["lam"]
    with _swapped_item(system.settings, "lam", 2 * lam):
        yield


@contextlib.contextmanager
def state_unchanged(system):
    from repro_torch.core import refine

    loop = refine._refine_loop

    def unchanged(*args, **kw):
        return loop(*args, **dict(kw, max_iter=0))

    with _swapped(refine, "_refine_loop", unchanged):
        yield


@contextlib.contextmanager
def half_batch(system):
    pt = system.pt
    if system.spec.mode == "fleet":
        fleet = pt.partition_fleet

        def half_fleet(graphs, cfg, *args, **kw):
            graphs = list(graphs)
            res = fleet(graphs[: len(graphs) // 2], cfg, *args, **kw)
            res.results += [None] * (len(graphs) - len(res.results))
            return res

        with _swapped(pt, "partition_fleet", half_fleet):
            yield
    else:
        seeds = pt._resolve_trial_seeds

        def half_trials(cfg):
            got = seeds(cfg)
            return got[: max(1, len(got) // 2)]

        with _swapped(pt, "_resolve_trial_seeds", half_trials):
            yield


@contextlib.contextmanager
def answer_altered(system):
    from repro_torch.core import refine

    loop = refine._refine_loop

    def altered(*args, **kw):
        parts, stats = loop(*args, **kw)
        parts = parts.clone()
        parts[..., 0] = (parts[..., 0] + 1) % kw["k"]
        return parts, stats

    with _swapped(refine, "_refine_loop", altered):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
